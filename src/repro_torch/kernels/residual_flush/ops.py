"""Entry points of the residual flush (quantize + pack + commit) and of the
decode append around it, dense and paged: one CUDA kernel with two modes
(``csrc/residual_flush.cu``) or their plain PyTorch versions (``ref.py``).

* mode "flush" (:func:`residual_flush`, :func:`paged_residual_flush`): the
  direct counterparts of the JAX package's two flush kernels;
* mode "append" (:func:`append_flush`, :func:`paged_append_flush`): a
  layer's whole cache update in a decode step (token write, flush of the
  rows it fills, lengths), one launch, nothing read on the host.

Both modes count their launches under ``residual_flush`` (dense) and
``paged_residual_flush`` (paged).  ``shared_kv`` (the MLA latent cache)
flushes and appends K alone: the V-side arguments are None.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.residual_flush import ref as _ref

# head dims: any of these (zamba2-7b's 112 among them: its 14 8-channel chunks a
# token reduce their per-token statistics over 16 lanes, two idle); per-channel
# K also multiples of 8 up to MAX_CHANNEL_DIM (the MLA latents 160 and 576),
# whose 8-channel chunks do not divide a warp
HEAD_DIMS = (8, 16, 32, 64, 112, 128, 256)
MAX_CHANNEL_DIM = 576


def _head_dim_ok(d: int, channel: bool) -> bool:
    return d in HEAD_DIMS or (channel and d % 8 == 0 and 8 <= d <= MAX_CHANNEL_DIM)


def _check_flush_args(arrays, b, h, npr, bits, block_n, k_gran):
    """``arrays``: kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res;
    the V side None when shared_kv."""
    kw, vw, k_res, v_res = arrays[0], arrays[3], arrays[6], arrays[7]
    shared = vw is None
    if (tuple(k_res.shape) != (b, h, block_n, kw.shape[-1])
            or not shared and tuple(v_res.shape) != (b, h, block_n, vw.shape[-1])):
        raise ValueError("residual buffers must be [B, H, block_n, d]")
    if npr * 32 != block_n * bits:
        raise ValueError(f"packed words do not match bits={bits}, block_n={block_n}")
    present = [t for t in arrays if t is not None]
    if any(not t.is_contiguous() for t in present):
        raise ValueError("the CUDA flush writes the cache in place: arrays must be contiguous")
    if any(arrays[i] is not None and arrays[i].dtype != torch.bfloat16 for i in (1, 4, 6, 7)):
        raise ValueError("the CUDA flush takes bf16 params and bf16 residuals")
    if (not _head_dim_ok(kw.shape[-1], k_gran == "channel")
            or not shared and vw.shape[-1] not in HEAD_DIMS):
        raise ValueError(f"the CUDA flush takes head dims {HEAD_DIMS} (and multiples of 8 up "
                         f"to {MAX_CHANNEL_DIM} for per-channel K), got {kw.shape[-1]} / "
                         f"{None if shared else vw.shape[-1]}; use impl='torch'")
    if any(t is not None and t.data_ptr() % 16 for t in (k_res, v_res)):
        raise ValueError("the CUDA flush reads the residuals in 16-byte chunks: align them")


def _v_side(shared_kv: bool, *tensors):
    """The V-side arguments as the kernel takes them: None when shared_kv."""
    return (None,) * len(tensors) if shared_kv else tensors


def _ints(*tensors):
    """Per-row int32 vectors the kernel reads or writes in place."""
    for t in tensors:
        if t.dtype != torch.int32 or t.ndim != 1 or not t.is_contiguous():
            raise ValueError("lengths and counters must be contiguous int32 [B]")


def _new_token(x, b, h, d):
    """The new token [B, H, 1, d] as bf16 with a contiguous last axis; its
    batch and head strides."""
    if tuple(x.shape) != (b, h, 1, d):
        raise ValueError(f"new token must be [B, H, 1, d] = {(b, h, 1, d)}, got {tuple(x.shape)}")
    x = x.to(torch.bfloat16)
    if x.stride(-1) != 1:
        x = x.contiguous()
    return x, x.stride(0), x.stride(1)


def _launch(name, arrays, *, b, h, n_cells, block_n, bits, k_gran, k_new=None, v_new=None,
            mask=None, full=None, dest=None, table=None, lengths=(None, None, None),
            page_lo: int = 0, pages_total: int | None = None):
    """One launch of the kernel: mode "append" when ``k_new`` is given,
    else mode "flush" (``full``/``dest``).  ``page_lo``/``pages_total``: the
    page range a paged append's pools hold (default: the whole pool)."""
    pages_total = n_cells if pages_total is None else pages_total
    if page_lo < 0 or page_lo + n_cells > pages_total:
        raise ValueError(f"page range [{page_lo}, {page_lo} + {n_cells}) outside a pool of "
                         f"{pages_total} pages")
    shared = arrays[3] is None
    d_k = arrays[0].shape[-1]
    d_v = d_k if shared else arrays[3].shape[-1]
    strides = (0, 0, 0, 0)
    if k_new is not None:
        k_new, k_sb, k_sh = _new_token(k_new, b, h, d_k)
        v_sb = v_sh = 0
        if not shared:
            v_new, v_sb, v_sh = _new_token(v_new, b, h, d_v)
        strides = (k_sb, k_sh, v_sb, v_sh)
        if mask is not None:
            mask = mask.to(torch.bool).contiguous()
        _ints(*lengths)
    else:
        full = full.to(torch.int32).contiguous()
        dest = dest.to(torch.int32).contiguous()
    nb_max, table_ld = 0, 0
    if table is not None:
        if table.dtype != torch.int32 or table.shape[0] != b or table.stride(1) != 1:
            raise ValueError("page_table must be int32 [B, nb_max] with contiguous rows")
        nb_max, table_ld = table.shape[1], table.stride(0)

    def ptr(t):  # None: a null pointer
        return None if t is None else t.data_ptr()

    _build.launch(
        name, *map(ptr, arrays), ptr(k_new), ptr(None if shared else v_new), ptr(mask),
        ptr(full), ptr(dest), ptr(table), *map(ptr, lengths), *strides, b, h, n_cells, block_n,
        d_k, d_v, bits, int(k_gran == "channel"), nb_max, table_ld, int(k_new is not None),
        int(name == "paged_residual_flush"), int(shared), int(page_lo), int(pages_total),
        _build.stream_of(arrays[0]),
    )


# ------------------------------------------------------------- mode "flush"


def residual_flush_cuda(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                        full, dest_block, *, bits: int, block_n: int, k_gran: str,
                        shared_kv: bool = False):
    """Launch mode "flush": programs of rows with ``full[b] == 0`` return at
    once.  Updates the packed arrays in place."""
    b, h, nb, npr, _ = kw.shape
    arrays = (kw, k_scale, k_zero, *_v_side(shared_kv, vw, v_scale, v_zero), k_res,
              *_v_side(shared_kv, v_res))
    _check_flush_args(arrays, b, h, npr, bits, block_n, k_gran)
    _launch("residual_flush", arrays, b=b, h=h, n_cells=nb, block_n=block_n, bits=bits,
            k_gran=k_gran, full=full, dest=dest_block)
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def residual_flush(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                   full, dest_block, *, bits: int, block_n: int, k_gran: str,
                   shared_kv: bool = False, impl: str = "auto"):
    """Commit the bf16 residual of every sequence with ``full[b] != 0`` into
    packed block ``dest_block[b]`` (clamped to ``nb - 1``), in place; K
    alone when ``shared_kv``.

    Neither path reads ``full`` on the host.  impl: 'cuda' | 'torch' |
    'auto' (the kernel for CUDA tensors).
    """
    args = (kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, full, dest_block)
    fn = residual_flush_cuda if _build.resolve_impl(impl, *args) == "cuda" else _ref.residual_flush_ref
    return fn(*args, bits=bits, block_n=block_n, k_gran=k_gran, shared_kv=shared_kv)


def paged_residual_flush_cuda(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                              v_scale_pool, v_zero_pool, k_res, v_res, full,
                              dest_page, *, bits: int, block_n: int, k_gran: str,
                              shared_kv: bool = False):
    """Launch mode "flush" on the pools: programs of rows with
    ``full[b] == 0`` return at once.  Updates the pools in place."""
    n_pages, h, npr, _ = kw_pool.shape
    b = k_res.shape[0]
    arrays = (kw_pool, k_scale_pool, k_zero_pool,
              *_v_side(shared_kv, vw_pool, v_scale_pool, v_zero_pool), k_res,
              *_v_side(shared_kv, v_res))
    _check_flush_args(arrays, b, h, npr, bits, block_n, k_gran)
    _launch("paged_residual_flush", arrays, b=b, h=h, n_cells=n_pages, block_n=block_n,
            bits=bits, k_gran=k_gran, full=full, dest=dest_page)
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool


def paged_residual_flush(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                         v_scale_pool, v_zero_pool, k_res, v_res, full,
                         dest_page, *, bits: int, block_n: int, k_gran: str,
                         shared_kv: bool = False, impl: str = "auto"):
    """Paged face: commit the bf16 residual of every sequence with
    ``full[b] != 0`` into pool page ``min(dest_page[b], P - 1)`` of the shared
    ``[P, H, ...]`` pools, in place; K alone when ``shared_kv``.
    ``dest_page`` entries must be pairwise distinct: callers point rows that
    do not flush at their own scratch page (pool pages ``[0, B)``).  Neither
    path reads ``full`` on the host.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors)."""
    args = (kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
            v_zero_pool, k_res, v_res, full, dest_page)
    fn = (paged_residual_flush_cuda if _build.resolve_impl(impl, *args) == "cuda"
          else _ref.paged_residual_flush_ref)
    return fn(*args, bits=bits, block_n=block_n, k_gran=k_gran, shared_kv=shared_kv)


# ------------------------------------------------------------ mode "append"


def append_flush_cuda(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, k_new,
                      v_new, pack_blocks, res_len, arrive, *, mask=None, bits: int,
                      block_n: int, k_gran: str, shared_kv: bool = False):
    """Launch mode "append" on a dense cache: one launch updates residual,
    packed blocks and lengths in place; ``arrive`` ([B] int32, zero) is the
    kernel's counter and comes back zero."""
    b, h, nb, npr, _ = kw.shape
    arrays = (kw, k_scale, k_zero, *_v_side(shared_kv, vw, v_scale, v_zero), k_res,
              *_v_side(shared_kv, v_res))
    _check_flush_args(arrays, b, h, npr, bits, block_n, k_gran)
    _launch("residual_flush", arrays, b=b, h=h, n_cells=nb, block_n=block_n, bits=bits,
            k_gran=k_gran, k_new=k_new, v_new=v_new, mask=mask,
            lengths=(pack_blocks, res_len, arrive))
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def append_flush(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, k_new, v_new,
                 pack_blocks, res_len, arrive, *, mask=None, bits: int, block_n: int,
                 k_gran: str, shared_kv: bool = False, impl: str = "auto"):
    """A dense cache's decode append, in place: write one token per sequence
    (k_new/v_new [B, H, 1, d]) into residual row ``min(res_len[b],
    block_n - 1)``, commit the residual of every row it fills into packed
    block ``min(pack_blocks[b], nb - 1)``, then ``pack_blocks += full`` and
    ``res_len = full ? 0 : res_len + step``.  ``mask`` ([B] bool, optional):
    rows with ``False`` keep everything unchanged.  ``shared_kv``: K alone
    (``v_new`` and the V side None).
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors)."""
    args = (kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, k_new, v_new,
            pack_blocks, res_len, arrive)
    fn = (append_flush_cuda if _build.resolve_impl(impl, *args, mask) == "cuda"
          else _ref.append_flush_ref)
    return fn(*args, mask=mask, bits=bits, block_n=block_n, k_gran=k_gran,
              shared_kv=shared_kv)


def paged_append_flush_cuda(kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
                            v_zero_pool, k_res, v_res, k_new, v_new, page_table,
                            pack_blocks, res_len, arrive, *, mask=None, bits: int,
                            block_n: int, k_gran: str, shared_kv: bool = False,
                            page_lo: int = 0, pages_total: int | None = None):
    """Launch mode "append" on the pools, through the page table."""
    n_pages, h, npr, _ = kw_pool.shape
    b = k_res.shape[0]
    arrays = (kw_pool, k_scale_pool, k_zero_pool,
              *_v_side(shared_kv, vw_pool, v_scale_pool, v_zero_pool), k_res,
              *_v_side(shared_kv, v_res))
    _check_flush_args(arrays, b, h, npr, bits, block_n, k_gran)
    _launch("paged_residual_flush", arrays, b=b, h=h, n_cells=n_pages, block_n=block_n,
            bits=bits, k_gran=k_gran, k_new=k_new, v_new=v_new, mask=mask, table=page_table,
            lengths=(pack_blocks, res_len, arrive), page_lo=page_lo, pages_total=pages_total)
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool


def paged_append_flush(kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
                       v_zero_pool, k_res, v_res, k_new, v_new, page_table, pack_blocks,
                       res_len, arrive, *, mask=None, bits: int, block_n: int, k_gran: str,
                       shared_kv: bool = False, impl: str = "auto", page_lo: int = 0,
                       pages_total: int | None = None):
    """A paged cache's decode append, in place: as :func:`append_flush`, the
    rows it fills committed into pool page ``page_table[b,
    clamp(pack_blocks[b], 0, nb_max - 1)]`` (clamped to ``P - 1``).
    The page range (``page_lo``, ``pages_total``): the pools hold pages
    ``[page_lo, page_lo + P)`` of a pool of ``pages_total`` (one rank's
    page-affine pools); a row whose page (clamped to ``pages_total - 1``)
    lies outside writes no page, and every row's residual and lengths are
    written all the same.  The default is the whole pool.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors)."""
    args = (kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, k_new, v_new, page_table, pack_blocks, res_len, arrive)
    fn = (paged_append_flush_cuda if _build.resolve_impl(impl, *args, mask) == "cuda"
          else _ref.paged_append_flush_ref)
    return fn(*args, mask=mask, bits=bits, block_n=block_n, k_gran=k_gran,
              shared_kv=shared_kv, page_lo=page_lo, pages_total=pages_total)
