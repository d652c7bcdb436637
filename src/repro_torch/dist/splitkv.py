"""Cross-device split-KV decode: FlashDecoding partitioning across a mesh
axis, the port of the JAX package's ``dist/splitkv.py``.

The decode kernels already split a row's packed-block walk across their CTAs
(``num_splits``); this module is the level above.  Each rank of the mesh
axis walks one window of the block axis through the same kernel, and the
ranks' partials (o, lse) merge by logsumexp:

    m = max_i lse_i;  w_i = exp(lse_i - m);  out = sum_i w_i o_i / sum_i w_i

A rank whose window lies past a row's ``pack_blocks`` computes no valid
token there: the kernel's empty partial has lse ~ -1e37, whose weight is
exactly 0.  The bf16 residual is read by the last rank only.

Ranks are SPMD: every rank holds the same replicated cache (or, for
page-affine pools, its own page range of them) and runs the same call.  The
JAX package slices the operands with ``shard_map``; here the kernels take
the window in place (``block_lo``, ``n_blocks``, ``read_res``): rank ``r``
of ``n`` walks blocks ``[r * nb_local, (r + 1) * nb_local)`` with
``nb_local = ceil(nb / n)``, the last window cut at ``nb``.  That is JAX's
zero pad of the block axis without the copy: padded blocks sit past every
``pack_blocks`` and are never read.

The merge gathers every rank's (o, lse), packed into one buffer, with one
``all_gather_into_tensor`` over the axis's process group
(``mesh.get_group(axis)``), and runs the port's split merge on it: the
``bitdecode_merge`` kernel on the card, ``ref.merge_partials`` on the CPU.
Every rank merges the same gathered bytes in the same order, so the result
is bitwise the same on every rank.  With one rank the merge of one partial
is ``o * exp(0) / 1``: the split walk equals the unsplit call bit for bit.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``; its
``mesh_dim_names`` are JAX's ``axis_names``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.core.attention import inverse_query_transform, query_transform
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.bitdecode import ref as bd_ref
from repro_torch.kernels.paged_bitdecode import ops as pg_ops


def axis_of(mesh, axis: str) -> tuple[int, int]:
    """(size, this rank's coordinate) of mesh axis ``axis``; JAX's
    ``ValueError`` when the mesh has no such axis."""
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if axis not in names:
        raise ValueError(f"mesh has no axis {axis!r}; available: {names}")
    return mesh.size(names.index(axis)), mesh.get_local_rank(axis)


def merge_collective(o, lse, mesh, axis: str):
    """lse merge of the ranks' flash partials across mesh axis ``axis``.

    o: [..., g, d_v] normalised per-rank output; lse: [..., g].  Returns the
    merged output (f32), the same bits on every rank."""
    n, _ = axis_of(mesh, axis)
    o, lse = o.float().contiguous(), lse.float().contiguous()
    k, m = o.numel(), lse.numel()
    buf = torch.empty(n * (k + m), dtype=torch.float32, device=o.device)
    dist.all_gather_into_tensor(buf, torch.cat([o.reshape(-1), lse.reshape(-1)]),
                                group=mesh.get_group(axis))
    parts = buf.view(n, k + m)
    o_parts, lse_parts = parts[:, :k].view(n, *o.shape), parts[:, k:].view(n, *lse.shape)
    if o.is_cuda:
        return bd_ops.merge_cuda(o_parts, lse_parts)[0]
    return bd_ref.merge_partials(o_parts, lse_parts)[0]


def splitkv_decode_attention(q, cache, mesh, *, axis: str = "data",
                             sm_scale: float | None = None, d_v: int | None = None,
                             impl: str = "auto", num_splits="auto",
                             draft_bits: int | None = None):
    """Sequence-parallel decode attention against a dense QuantKVCache held
    whole by every rank: this rank walks its window of the block axis.

    q: [B, 1, h_q, d_k] (model layout).  Returns f32 [B, 1, h_q, d_v], the
    same on every rank.  Composes with the in-kernel split (``num_splits``
    within the window).  ``draft_bits``: the speculative draft read, as in
    ``core.attention.decode_attention``."""
    n, r = axis_of(mesh, axis)
    qt = query_transform(q, cache.kw.shape[1])
    nb_local = -(-cache.kw.shape[2] // n)
    o, lse = bd_ops.bitdecode_attention(
        qt, cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale, cache.v_zero,
        cache.k_res, cache.v_res, cache.pack_blocks, cache.res_len, bits=cache.bits,
        block_n=cache.block_n, sm_scale=sm_scale, k_gran=cache.k_gran,
        shared_kv=cache.shared_kv, d_v=d_v, impl=impl, num_splits=num_splits,
        return_lse=True, draft_bits=draft_bits, block_lo=r * nb_local, n_blocks=nb_local,
        read_res=r == n - 1,
    )
    return inverse_query_transform(merge_collective(o, lse, mesh, axis))


def affine_pools(cache, n: int, r: int, axis: str):
    """This rank's pools of a page-affine walk and the first page id they
    hold: the cache's own when it holds a page range already (``pages_total``
    set: ``state_specs.local_pools`` or the engine), else rank ``r``'s
    ``1/n`` of the whole pools, as views (the page axis leads a layer's
    pools).  JAX's ``ValueError`` when the pool's page count does not divide
    by the axis size."""
    total = cache.n_pages if cache.pages_total is None else cache.pages_total
    if total % n:
        raise ValueError(
            f"page_affine needs the pool page count ({total}) divisible by the {axis!r} "
            f"axis size ({n}); allocate the pool with shards equal to the axis size "
            "(serve/pages.py)")
    pp = total // n
    names = ("kw", "k_scale", "k_zero", "vw", "v_scale", "v_zero")
    if cache.pages_total is not None:
        if cache.n_pages != pp or cache.page_lo != r * pp:
            raise ValueError(f"rank {r} holds pages [{cache.page_lo}, +{cache.n_pages}), not "
                             f"its share [{r * pp}, +{pp}) of {total}")
        return [getattr(cache, f) for f in names], cache.page_lo
    return [None if getattr(cache, f) is None else getattr(cache, f)[r * pp:(r + 1) * pp]
            for f in names], r * pp


def splitkv_paged_decode_attention(q, cache, mesh, *, axis: str = "data",
                                   sm_scale: float | None = None, d_v: int | None = None,
                                   impl: str = "auto", num_splits="auto",
                                   page_affine: bool = False, draft_bits: int | None = None):
    """Sequence-parallel *paged* decode: this rank walks its slice of the page
    table's columns (``nb_local = ceil(nb_max / n)`` of them), and with
    ``page_affine`` only its own pages.

    ``page_affine=False`` walks the slice against pools every rank holds
    whole.  ``page_affine=True`` is the page-affine allocator's contract
    (``serve/pages.py`` with ``shards = n``): every page referenced at table
    column ``j`` lives in shard ``j // nb_local``, the rank that walks that
    column, so each rank reads only its ``n_pages / n`` pages; page ids are
    rebased into the rank's range (``- r * pp_local``) and clamped, so only
    masked entries (scratch ids past ``pack_blocks``) clamp.  The cache may
    hold the whole pools (the rank walks its share of them, as views) or
    this rank's page range alone (``cache.pages_total`` set).

    q: [B, 1, h_q, d_k]; returns f32 [B, 1, h_q, d_v], the same on every
    rank.  ``shared_kv`` caches (the MLA latent pools) walk the same way,
    ``d_v`` naming the latent's value slice.  ``draft_bits`` as in
    :func:`splitkv_decode_attention`."""
    n, r = axis_of(mesh, axis)
    qt = query_transform(q, cache.kw.shape[1])
    nb_local = -(-cache.page_table.shape[1] // n)
    pools = [cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale, cache.v_zero]
    page_lo = 0
    if page_affine:
        pools, page_lo = affine_pools(cache, n, r, axis)
    o, lse = pg_ops.paged_bitdecode_attention(
        qt, *pools, cache.k_res, cache.v_res, cache.page_table, cache.pack_blocks,
        cache.res_len, bits=cache.bits, block_n=cache.block_n, sm_scale=sm_scale,
        k_gran=cache.k_gran, shared_kv=cache.shared_kv, d_v=d_v, impl=impl,
        num_splits=num_splits, return_lse=True, draft_bits=draft_bits,
        block_lo=r * nb_local, n_blocks=nb_local, read_res=r == n - 1, page_lo=page_lo,
    )
    return inverse_query_transform(merge_collective(o, lse, mesh, axis))


def gather_prior_pages(cache, pages, mesh, axis: str):
    """``qcache.dequant_prior``'s page gather over page-affine pools: each
    rank gathers the pages of ``pages`` (global ids, [B, J]) that it holds,
    zeros for the others, and one ``all_reduce`` (sum) a field over the axis
    completes them: every page is held by exactly one rank, so the sum is
    the page's bits (taken as int32 words).  Returns the ``fetch`` that
    ``dequant_prior`` takes."""
    group = mesh.get_group(axis)
    n_local = cache.n_pages
    idx = pages.long() - cache.page_lo
    mine = (idx >= 0) & (idx < n_local)
    idx = torch.clamp(idx, 0, n_local - 1)

    def fetch(arr, ax):
        got = arr.movedim(ax, 0)[idx]  # [B, J, *lead, H, ...]
        got = torch.where(mine.view(*mine.shape, *[1] * (got.dim() - 2)), got,
                          torch.zeros((), dtype=got.dtype, device=got.device))
        words = got.contiguous().view(torch.int32)
        dist.all_reduce(words, group=group)
        return words.view(got.dtype)

    return fetch
