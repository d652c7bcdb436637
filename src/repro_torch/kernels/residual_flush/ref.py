"""Plain PyTorch version of the fused residual flush: quantize every
sequence's residual block and select-commit it, at block granularity, into
packed block ``min(dest_block[b], nb - 1)`` of the sequences with
``full[b] != 0`` (dense cache), or into pool page ``min(dest_page[b], P - 1)``
(paged cache).  Unlike the JAX oracle it updates the packed arrays in
place.  It never reads ``full`` on the host, so it runs without a device
synchronisation on the card as well.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer


def residual_flush_ref(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                       full, dest_block, *, bits: int, block_n: int, k_gran: str):
    """kw: int32 [B, H, nb, npr, d_k]; k_res: bf16 [B, H, block_n, d_k];
    full/dest_block: int32 [B].  Writes the six packed arrays in place and
    returns them; rows with ``full[b] == 0`` keep their contents."""
    if k_res.shape[2] != block_n:
        raise ValueError(f"residual holds {k_res.shape[2]} rows, block_n={block_n}")
    param_dtype = k_scale.dtype
    nb = kw.shape[2]
    rows = torch.arange(kw.shape[0], device=kw.device)
    blk = torch.clamp(dest_block.long(), 0, nb - 1)
    keep = (full != 0)

    def commit(dst, new):
        sel = keep.view(-1, *([1] * (new.ndim - 1)))
        dst[rows, :, blk] = torch.where(sel, new.to(dst.dtype), dst[rows, :, blk])

    for (w_dst, s_dst, z_dst), res, gran in (
        ((kw, k_scale, k_zero), k_res, k_gran),
        ((vw, v_scale, v_zero), v_res, "tensor"),
    ):
        w, s, z = quantizer.quantize_and_pack(res, bits, gran, param_dtype=param_dtype)
        commit(w_dst, w)
        commit(s_dst, s)
        commit(z_dst, z)
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def paged_residual_flush_ref(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                             v_scale_pool, v_zero_pool, k_res, v_res, full,
                             dest_page, *, bits: int, block_n: int, k_gran: str):
    """Paged face: commit the residual of every sequence with ``full[b] != 0``
    into pool page ``min(dest_page[b], P - 1)``, in place.

    kw_pool: int32 [P, H, npr, d_k]; k_scale_pool: [P, H, d_k | block_n];
    k_res: bf16 [B, H, block_n, d_k]; full/dest_page: int32 [B].  The
    destinations must be pairwise distinct (rows that do not flush point at
    their own scratch page), so the scatter has no duplicate indices.
    Returns the six pools."""
    if k_res.shape[2] != block_n:
        raise ValueError(f"residual holds {k_res.shape[2]} rows, block_n={block_n}")
    param_dtype = k_scale_pool.dtype
    dest = torch.clamp_max(dest_page.long(), kw_pool.shape[0] - 1)
    keep = (full != 0)

    def commit(pool, new):
        sel = keep.view(-1, *([1] * (new.ndim - 1)))
        pool[dest] = torch.where(sel, new.to(pool.dtype), pool[dest])

    for (w_dst, s_dst, z_dst), res, gran in (
        ((kw_pool, k_scale_pool, k_zero_pool), k_res, k_gran),
        ((vw_pool, v_scale_pool, v_zero_pool), v_res, "tensor"),
    ):
        w, s, z = quantizer.quantize_and_pack(res, bits, gran, param_dtype=param_dtype)
        commit(w_dst, w)
        commit(s_dst, s)
        commit(z_dst, z)
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool
