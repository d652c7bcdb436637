"""Quantized KV cache with a bf16 residual buffer (paper §IV-A(2), §V-B),
dense and paged layouts.

The sequence is split into packed low-bit blocks of ``block_n`` tokens plus
a bf16 residual tail of capacity ``block_n``.  Decoded tokens append to the
residual; when it fills, the fused flush (kernels/residual_flush) quantizes,
packs and commits the block and the residual restarts.

Unlike the JAX reference, whose arrays are immutable, :func:`prefill` and
:func:`append_decode` update the cache's tensors **in place** and return the
same object.  A decode step's whole cache update (token write, flush of the
rows it fills, lengths) is one launch of the residual-flush kernel in its
"append" mode: the JAX reference jits the same step into one program and
skips the flush with ``lax.cond(any(full))``, but on the card a host-side
check of ``full`` would synchronise every token, so instead the kernel's
programs return at once for a row that is not full.  The kernel's per-row
arrival counter (``arrive``, zero between launches) is allocated with the
cache.

The paged layout (:class:`PagedQuantKVCache`) keeps the packed blocks of all
sequences in shared page pools and walks them through a page table; the
serving engine (``repro_torch.serve``) decides which page holds which block.
Its append (:func:`paged_append_decode`) follows the same conventions: in
place, one launch, the flush destinations computed on the device.

``shared_kv`` (the MLA latent cache) keeps one quantized stream: the V side
(``vw``, ``v_scale``, ``v_zero``, ``v_res``) is ``None``, the flush and the
append write K alone, and the decode reads V as the first ``d_v`` channels
of dequantized K.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import layout, quantizer
from repro_torch.core.device import resolve_device, upload
from repro_torch.kernels.kv_quant import ops as kvq_ops
from repro_torch.kernels.residual_flush import ops as rf_ops

_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero",
           "k_res", "v_res", "pack_blocks", "res_len", "arrive")


@dataclasses.dataclass
class QuantKVCache:
    kw: torch.Tensor        # int32 [B, H, nb, npr, d_k]
    k_scale: torch.Tensor   # [B, H, nb, d_k] (channel) or [B, H, nb, block_n]
    k_zero: torch.Tensor
    vw: torch.Tensor | None       # int32 [B, H, nb, npr, d_v]; None when shared_kv
    v_scale: torch.Tensor | None  # [B, H, nb, block_n]
    v_zero: torch.Tensor | None
    k_res: torch.Tensor     # bf16 [B, H, block_n, d_k]
    v_res: torch.Tensor | None    # bf16 [B, H, block_n, d_v]
    pack_blocks: torch.Tensor  # int32 [B]
    res_len: torch.Tensor      # int32 [B]
    arrive: torch.Tensor       # int32 [B]: the append kernel's counter, zero between launches
    bits: int
    block_n: int
    k_gran: str
    shared_kv: bool = False

    @property
    def length(self) -> torch.Tensor:
        return self.pack_blocks * self.block_n + self.res_len

    def layer(self, i: int) -> "QuantKVCache":
        """Layer ``i`` of a cache stacked over layers, as views: in-place
        updates of the returned cache land in the stacked tensors."""
        return dataclasses.replace(self, **_map_fields(self, _FIELDS, lambda t: t[i]))


def _map_fields(cache, fields, fn) -> dict:
    """``fn`` of each tensor field of ``cache`` (the V side of a shared_kv
    cache is None and stays so)."""
    return {f: fn(getattr(cache, f)) for f in fields if getattr(cache, f) is not None}


def stack_caches(caches: list[QuantKVCache]) -> QuantKVCache:
    """Stack per-layer caches along a new leading layer axis."""
    return dataclasses.replace(caches[0], **{
        f: torch.stack([getattr(c, f) for c in caches])
        for f in _FIELDS if getattr(caches[0], f) is not None})


def splitkv_block_align(mesh, axis: str | None) -> int | None:
    """Block-axis alignment implied by a split-KV mesh axis (None when no
    mesh or an unknown axis): the ``block_align`` to pass to
    :func:`init_cache` so every rank's window of the block axis
    (``dist.splitkv``) is equally wide."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if mesh is None or axis is None or axis not in names:
        return None
    return int(mesh.size(names.index(axis)))


def init_cache(batch: int, h_kv: int, d: int, max_seq: int, *, d_v: int | None = None,
               bits: int = 4, block_n: int = 128, k_gran: str = "channel",
               shared_kv: bool = False, block_align: int | None = None,
               device=None) -> QuantKVCache:
    """Allocate an empty cache with capacity >= max_seq tokens: bf16 params
    and a bf16 residual, K of head width ``d`` and V of ``d_v`` (default
    ``d``), on ``device`` (the card unless given).  ``shared_kv``: K alone
    (the V side is None).  ``block_align`` rounds the packed block count up
    to a multiple (the split-KV mesh axis's size, through
    ``model.init_decode_state(..., mesh=...)``)."""
    device = resolve_device(device)
    nb = max(1, -(-max_seq // block_n))
    if block_align and block_align > 1:
        nb = -(-nb // block_align) * block_align
    npr = layout.words_per_block(block_n, bits)
    kp = d if k_gran == "channel" else block_n
    d_v = d if d_v is None else d_v
    bf16 = torch.bfloat16

    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    zv = (lambda shape, dtype: None) if shared_kv else z  # the V side
    return QuantKVCache(
        kw=z((batch, h_kv, nb, npr, d), torch.int32),
        k_scale=z((batch, h_kv, nb, kp), bf16),
        k_zero=z((batch, h_kv, nb, kp), bf16),
        vw=zv((batch, h_kv, nb, npr, d_v), torch.int32),
        v_scale=zv((batch, h_kv, nb, block_n), bf16),
        v_zero=zv((batch, h_kv, nb, block_n), bf16),
        k_res=z((batch, h_kv, block_n, d), bf16),
        v_res=zv((batch, h_kv, block_n, d_v), bf16),
        pack_blocks=z((batch,), torch.int32),
        res_len=z((batch,), torch.int32),
        arrive=z((batch,), torch.int32),
        bits=bits, block_n=block_n, k_gran=k_gran, shared_kv=shared_kv,
    )


def append_decode(cache: QuantKVCache, k_new, v_new, *, quant_impl: str = "auto",
                  mask=None) -> QuantKVCache:
    """Append one decoded token per sequence (k_new/v_new: [B, H, 1, d];
    v_new None when shared_kv) and commit the residual block of every row
    it fills, in place: one launch of the flush kernel's append mode on the
    card.

    quant_impl: 'auto' | 'cuda' | 'torch', forwarded to
    ``residual_flush.ops.append_flush``.  ``mask`` ([B] bool, optional):
    rows with ``False`` keep the cache unchanged."""
    rf_ops.append_flush(
        cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale, cache.v_zero,
        cache.k_res, cache.v_res, k_new, v_new, cache.pack_blocks, cache.res_len,
        cache.arrive, mask=mask, bits=cache.bits, block_n=cache.block_n,
        k_gran=cache.k_gran, shared_kv=cache.shared_kv, impl=quant_impl,
    )
    return cache


def _quantize_full_region(cache: QuantKVCache, k, v, n_full: int, quant_impl: str):
    """Quantize + pack the first ``n_full`` blocks of a prefill straight into
    the packed fields (in place): one launch for K and V on the card, or
    for K alone when shared_kv."""
    if not n_full:
        return
    n = n_full * cache.block_n

    def head(*fields):
        return tuple(getattr(cache, f)[:, :, :n_full] for f in fields)

    if cache.shared_kv:
        kvq_ops.quantize_kv(k[:, :, :n], cache.bits, cache.k_gran, block_n=cache.block_n,
                            impl=quant_impl, out=head("kw", "k_scale", "k_zero"))
        return
    kvq_ops.quantize_kv_pair(
        k[:, :, :n], v[:, :, :n], cache.bits, cache.k_gran, block_n=cache.block_n,
        out_k=head("kw", "k_scale", "k_zero"), out_v=head("vw", "v_scale", "v_zero"),
        impl=quant_impl,
    )


def _residuals(cache, k, v):
    """(residual buffer, new rows) pairs: K's, and V's unless shared_kv."""
    return [(cache.k_res, k)] + ([] if cache.shared_kv else [(cache.v_res, v)])


def prefill(cache: QuantKVCache, k, v, *, lengths=None,
            quant_impl: str = "auto") -> QuantKVCache:
    """Fill the cache (in place) from a prefill's k/v [B, H, L, d] (v None
    when shared_kv): the first ``L - L % block_n`` tokens are quantized into
    packed blocks, the tail goes to the residual.

    ``lengths`` ([B] int32, optional) marks a ragged batch right-padded to
    L: sequence b keeps ``lengths[b] // block_n`` packed blocks and its
    residual holds tokens ``[lengths[b] - lengths[b] % block_n, lengths[b])``.
    Blocks past ``pack_blocks[b]`` hold pad-polluted params but are never
    read, and the next flush overwrites them.
    """
    b, h, L, _ = k.shape
    block_n = cache.block_n
    n_full = L // block_n
    res = L - n_full * block_n
    _quantize_full_region(cache, k, v, n_full, quant_impl)
    if lengths is not None:
        lengths = lengths.to(device=k.device, dtype=torch.int32)
        lo = (lengths // block_n) * block_n
        idx = torch.clamp(lo[:, None].long() + torch.arange(block_n, device=k.device),
                          max=L - 1)  # [B, block_n]; rows >= res_len are unread
        for res_buf, x in _residuals(cache, k, v):
            gather = idx[:, None, :, None].expand(b, h, block_n, x.shape[-1])
            res_buf.copy_(torch.gather(x, 2, gather))
        cache.pack_blocks.copy_(lengths // block_n)
        cache.res_len.copy_(lengths % block_n)
        return cache
    for res_buf, x in _residuals(cache, k, v):
        res_buf.zero_()
        res_buf[:, :, :res] = x[:, :, n_full * block_n:]
    cache.pack_blocks.fill_(n_full)
    cache.res_len.fill_(res)
    return cache


# --------------------------------------------------------------------------
# The speculative draft's residual (self-speculative decoding)
# --------------------------------------------------------------------------


def widen_residual(cache, extra: int, *, multiple: int = 1):
    """The cache with its residual token axis padded by at least ``extra``
    rows of zeros, to a multiple of ``multiple`` rows: fresh residual
    tensors, every other field shared.  The draft pass appends up to
    ``spec_k - 1`` tokens without flushing, so ``res_len`` may run past
    ``block_n``; the decode reads take the residual's width from
    ``k_res.shape[-2]`` and mask by ``res_len``, so the rows past it change
    nothing.  JAX pads by exactly ``extra``; the decode kernel reads the
    residual in units of ``bitdecode.ops.RES_TOKENS`` tokens, so the
    speculative pass rounds up (``multiple``).  Dense and paged caches
    alike, stacked over layers or not."""
    n = cache.k_res.shape[-2]
    width = -(-(n + extra) // multiple) * multiple if extra > 0 else n
    if width == n:
        return cache

    def pad(res):
        return torch.nn.functional.pad(res, (0, 0, 0, width - n))

    return dataclasses.replace(cache, **_map_fields(cache, ("k_res", "v_res"), pad))


def draft_append(cache, k_new, v_new):
    """The draft pass's append (k_new/v_new: [B, H, 1, d]; v_new None when
    shared_kv), in place: write each row's token at its ``res_len`` and add
    1 to ``res_len``.  No flush, no pool, ``pack_blocks`` or table write:
    the caller widened the residual (:func:`widen_residual`), and the draft
    state is thrown away after the verify pass.  The row index stays on the
    device (a scatter), so the append captures into a CUDA graph.  Dense
    and paged caches alike."""
    b, h = k_new.shape[:2]
    for res, new in _residuals(cache, k_new, v_new):
        idx = cache.res_len.long()[:, None, None, None].expand(b, h, 1, new.shape[-1])
        res.scatter_(2, idx, new.to(res.dtype))
    cache.res_len.add_(1)
    return cache


# --------------------------------------------------------------------------
# Paged cache (page pools + per-sequence page tables)
# --------------------------------------------------------------------------

_PAGED_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero",
                 "k_res", "v_res", "page_table", "pack_blocks", "res_len", "arrive")


@dataclasses.dataclass
class PagedQuantKVCache:
    """Paged twin of :class:`QuantKVCache`: packed blocks live in shared page
    pools (``[P, H, ...]``, one pool entry = one ``block_n``-token block) and
    each sequence walks its blocks through a ``page_table`` row; the bf16
    residual tail stays dense per slot.

    Invariants (``repro_torch.serve.pages`` maintains them):

    * pool pages ``[0, B)`` are per-slot scratch, never allocated to a
      request; a ``page_table`` entry that holds no allocated page equals
      the slot index, so a flush through it lands in the slot's own scratch
      page and the destinations of one flush stay pairwise distinct;
    * ``page_table[b, j]`` holds the page of sequence ``b``'s packed block
      ``j`` for every ``j < pack_blocks[b]``, and the page of block
      ``pack_blocks[b]`` is allocated before the step whose flush commits it;
    * ``length = pack_blocks * block_n + res_len``, as in the dense cache.

    A cache stacked over layers (the serving state) prepends a layer axis to
    every field; its ``page_table`` is one ``[B, nb_max]`` tensor expanded
    over the layers, so one in-place copy updates every layer's view
    (``serve.pages.set_page_tables``).

    ``page_lo`` / ``pages_total``: the pools may hold one page range, pages
    ``[page_lo, page_lo + P)`` of a pool of ``pages_total`` (a rank's share
    of page-affine pools, ``dist.state_specs.local_pools``); the table keeps
    the global page ids, and the append, :func:`copy_pages` and
    ``serve.pages.adopt_prefill`` write only the pages in the range.
    ``pages_total`` None: the pools are whole.
    """

    kw: torch.Tensor        # int32 [P, H, npr, d_k]
    k_scale: torch.Tensor   # [P, H, d_k] (channel) or [P, H, block_n]
    k_zero: torch.Tensor
    vw: torch.Tensor | None       # int32 [P, H, npr, d_v]; None when shared_kv
    v_scale: torch.Tensor | None  # [P, H, block_n]
    v_zero: torch.Tensor | None
    k_res: torch.Tensor     # bf16 [B, H, block_n, d_k]
    v_res: torch.Tensor | None    # bf16 [B, H, block_n, d_v]
    page_table: torch.Tensor   # int32 [B, nb_max]
    pack_blocks: torch.Tensor  # int32 [B]
    res_len: torch.Tensor      # int32 [B]
    arrive: torch.Tensor       # int32 [B]: the append kernel's counter, zero between launches
    bits: int
    block_n: int
    k_gran: str
    shared_kv: bool = False
    page_lo: int = 0
    pages_total: int | None = None

    @property
    def length(self) -> torch.Tensor:
        return self.pack_blocks * self.block_n + self.res_len

    @property
    def n_pages(self) -> int:
        """Pages the pools hold (this rank's range under page affinity)."""
        return self.kw.shape[-4]

    def local_pages(self, pages) -> tuple[list[int], list[int]]:
        """(positions in ``pages``, local ids) of the global page ids this
        cache's pools hold."""
        if self.pages_total is None:
            return list(range(len(pages))), [int(p) for p in pages]
        pos = [i for i, p in enumerate(pages) if 0 <= p - self.page_lo < self.n_pages]
        return pos, [int(pages[i]) - self.page_lo for i in pos]

    def layer(self, i: int) -> "PagedQuantKVCache":
        """Layer ``i`` of a cache stacked over layers, as views."""
        return dataclasses.replace(self, **_map_fields(self, _PAGED_FIELDS, lambda t: t[i]))


def init_paged_cache(n_pages: int, batch: int, h_kv: int, d_k: int, nb_max: int, *,
                     d_v: int | None = None, bits: int = 4, block_n: int = 128,
                     k_gran: str = "channel", shared_kv: bool = False,
                     layers: int | None = None, device=None) -> PagedQuantKVCache:
    """Allocate empty page pools for ``batch`` decode slots on ``device`` (the
    card unless given).

    ``n_pages`` must exceed ``batch``: the first ``batch`` pages are the
    per-slot scratch pages.  ``nb_max`` is the page-table width.  The fresh
    table points every entry at its slot's scratch page.  ``layers`` stacks
    the cache over that many layers, with one page table shared by all.
    ``shared_kv`` allocates the MLA latent layout: K's pools and residual
    alone.
    """
    if n_pages <= batch:
        raise ValueError(f"n_pages={n_pages} must exceed batch={batch} (the first "
                         "`batch` pages are reserved per-slot scratch)")
    device = resolve_device(device)
    d_v = d_k if d_v is None else d_v
    npr = layout.words_per_block(block_n, bits)
    kp = d_k if k_gran == "channel" else block_n
    lead = () if layers is None else (layers,)
    bf16 = torch.bfloat16

    def z(shape, dtype):
        return torch.zeros((*lead, *shape), dtype=dtype, device=device)

    zv = (lambda shape, dtype: None) if shared_kv else z  # the V side
    table = torch.arange(batch, dtype=torch.int32, device=device)[:, None].repeat(1, nb_max)
    return PagedQuantKVCache(
        kw=z((n_pages, h_kv, npr, d_k), torch.int32),
        k_scale=z((n_pages, h_kv, kp), bf16),
        k_zero=z((n_pages, h_kv, kp), bf16),
        vw=zv((n_pages, h_kv, npr, d_v), torch.int32),
        v_scale=zv((n_pages, h_kv, block_n), bf16),
        v_zero=zv((n_pages, h_kv, block_n), bf16),
        k_res=z((batch, h_kv, block_n, d_k), bf16),
        v_res=zv((batch, h_kv, block_n, d_v), bf16),
        page_table=table.expand(*lead, batch, nb_max),
        pack_blocks=z((batch,), torch.int32),
        res_len=z((batch,), torch.int32),
        arrive=z((batch,), torch.int32),
        bits=bits, block_n=block_n, k_gran=k_gran, shared_kv=shared_kv,
    )


def paged_append_decode(cache: PagedQuantKVCache, k_new, v_new, *,
                        quant_impl: str = "auto", mask=None) -> PagedQuantKVCache:
    """Append one decoded token per sequence (k_new/v_new: [B, H, 1, d];
    v_new None when shared_kv) to the residual and commit every residual it
    fills through the page table into the pools, in place: one launch of
    the paged flush kernel's append mode on the card.

    The flush destination of row ``b`` is ``page_table[b, pack_blocks[b]]``
    when its residual filled, else its scratch page ``b``, clamped to
    ``P - 1``: computed on the device, so nothing here reads ``full`` on the
    host.  ``mask`` ([B] bool, optional): rows with ``False`` keep residual,
    occupancy and pool pages unchanged."""
    rf_ops.paged_append_flush(
        cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale, cache.v_zero,
        cache.k_res, cache.v_res, k_new, v_new, cache.page_table, cache.pack_blocks,
        cache.res_len, cache.arrive, mask=mask, bits=cache.bits, block_n=cache.block_n,
        k_gran=cache.k_gran, shared_kv=cache.shared_kv, impl=quant_impl,
        page_lo=cache.page_lo, pages_total=cache.pages_total,
    )
    return cache


# Pool fields of the paged cache with the rank each has before any stacking
# dims are prepended (a layer axis in the serving state): the page axis of a
# stacked field is ``ndim - base rank``.
_PAGED_POOL_FIELDS = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")
_PAGED_POOL_BASE_RANK = {"kw": 4, "k_scale": 3, "k_zero": 3, "vw": 4, "v_scale": 3,
                         "v_zero": 3}


def _page_axis(arr, field: str) -> int:
    """Page-pool axis of a (possibly layer-stacked) pool field."""
    return arr.ndim - _PAGED_POOL_BASE_RANK[field]


def _index(x, device) -> torch.Tensor:
    """Page indices as int64 on ``device``: a tensor as given, host values
    uploaded without waiting on the card (``core.device.upload``)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return upload(np.asarray(x, np.int64), device)


def copy_pages(cache: PagedQuantKVCache, src, dst) -> PagedQuantKVCache:
    """Copy-on-write primitive, in place: pool page ``dst[i]`` becomes a
    bitwise replica of ``src[i]`` in every pool field (K's three alone when
    shared_kv) and every stacked layer.  ``dst`` entries are pairwise
    distinct and disjoint from ``src``.  Pools that hold a page range copy
    the pairs in it (a page-affine copy never leaves its rank's range)."""
    if cache.pages_total is not None:
        pos, src_l = cache.local_pages(src)
        pos_d, dst_l = cache.local_pages(dst)
        if pos != pos_d:
            raise ValueError(f"copy on write across page ranges: {list(src)} -> {list(dst)}")
        if not pos:
            return cache
        src, dst = src_l, dst_l
    src, dst = (_index(x, cache.kw.device) for x in (src, dst))
    for f in _PAGED_POOL_FIELDS:
        pool = getattr(cache, f)
        if pool is None:
            continue
        ax = _page_axis(pool, f)
        pool.index_copy_(ax, dst, pool.index_select(ax, src))
    return cache


def dequant_prior(cache: PagedQuantKVCache, pages, *, fetch=None):
    """Gather pool pages ``pages`` (int [B, J], rows right-padded; the caller
    masks the padding through ``prior_len``) and dequantize them into bf16
    prior K/V for the shared-prefix suffix prefill.

    Returns ``(k, v)`` shaped ``[*lead, B, J * block_n, H, d]`` (lead = the
    cache's stacking dims, e.g. the layer axis) in natural token order: the
    layout ``core.attention.prefix_suffix_attention`` takes.  Pool K is
    stored after RoPE, so the prior needs no position re-applied.  A
    shared_kv cache (the MLA latent pools) returns ``(latent, None)``: the
    model's up-projections make the per-head K and V from the latent
    (``models.mla.mla_prefill_cache``).  ``fetch(arr, page_axis)`` gathers
    the pages of one pool field (default: index the pools here; pools that
    hold a page range take ``dist.splitkv.gather_prior_pages``)."""

    idx = _index(pages, cache.kw.device)
    if fetch is None:
        def fetch(arr, ax):
            return arr.movedim(ax, 0)[idx]

    def gather(field: str):
        arr = getattr(cache, field)
        return fetch(arr, _page_axis(arr, field))  # [B, J, *lead, H, ...]

    def to_prior(x):
        # [B, J, *lead, H, n, d] -> [*lead, B, J * n, H, d]
        b, j, *lead, h, n, d = x.shape
        nl = len(lead)
        x = x.permute(*range(2, 2 + nl), 0, 1, 3 + nl, 2 + nl, 4 + nl)
        return x.reshape(*lead, b, j * n, h, d)

    k = quantizer.unpack_and_dequantize(gather("kw"), gather("k_scale"),
                                        gather("k_zero"), cache.bits, cache.k_gran)
    if cache.shared_kv:
        return to_prior(k), None
    v = quantizer.unpack_and_dequantize(gather("vw"), gather("v_scale"),
                                        gather("v_zero"), cache.bits, "tensor")
    return to_prior(k), to_prior(v)
