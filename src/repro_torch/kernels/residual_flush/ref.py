"""Plain PyTorch versions of the residual flush and of the decode append
around it.

The flush quantizes every sequence's residual block and select-commits it,
at block granularity, into packed block ``min(dest_block[b], nb - 1)`` of
the sequences with ``full[b] != 0`` (dense cache), or into pool page
``min(dest_page[b], P - 1)`` (paged cache).  The append writes one decoded
token per sequence into its residual, flushes the rows it fills and updates
the lengths: the op sequence that the CUDA kernel's append mode does in one
launch.  Unlike the JAX oracle, everything here updates the cache's tensors
in place.  Nothing reads ``full`` on the host, so these run without a device
synchronisation on the card as well.  ``shared_kv`` (the MLA latent cache)
flushes and appends K alone; the V-side arguments are None there.
"""
from __future__ import annotations

import torch

from repro_torch.core import quantizer


def _sides(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, k_gran, shared_kv):
    """((words, scale, zero), residual, granularity) of K, and of V unless
    ``shared_kv``."""
    sides = [((kw, k_scale, k_zero), k_res, k_gran)]
    return sides if shared_kv else sides + [((vw, v_scale, v_zero), v_res, "tensor")]


def residual_flush_ref(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                       full, dest_block, *, bits: int, block_n: int, k_gran: str,
                       shared_kv: bool = False):
    """kw: int32 [B, H, nb, npr, d_k]; k_res: bf16 [B, H, block_n, d_k];
    full/dest_block: int32 [B].  Writes the six packed arrays (three when
    ``shared_kv``) in place and returns them; rows with ``full[b] == 0``
    keep their contents."""
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

    for (w_dst, s_dst, z_dst), res, gran in _sides(kw, k_scale, k_zero, vw, v_scale, v_zero,
                                                   k_res, v_res, k_gran, shared_kv):
        w, s, z = quantizer.quantize_and_pack(res, bits, gran, param_dtype=param_dtype)
        commit(w_dst, w)
        commit(s_dst, s)
        commit(z_dst, z)
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def paged_residual_flush_ref(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                             v_scale_pool, v_zero_pool, k_res, v_res, full,
                             dest_page, *, bits: int, block_n: int, k_gran: str,
                             shared_kv: bool = False):
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
    keep = (full != 0)
    dest = torch.clamp_max(dest_page.long(), kw_pool.shape[0] - 1)[keep]

    def commit(pool, new):
        pool[dest] = new[keep].to(pool.dtype)

    for (w_dst, s_dst, z_dst), res, gran in _sides(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                                                   v_scale_pool, v_zero_pool, k_res, v_res,
                                                   k_gran, shared_kv):
        w, s, z = quantizer.quantize_and_pack(res, bits, gran, param_dtype=param_dtype)
        commit(w_dst, w)
        commit(s_dst, s)
        commit(z_dst, z)
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool


def append_residual(k_res, v_res, res_len, k_new, v_new, mask=None):
    """Write one new token per sequence into the residual rows
    ``min(res_len[b], block_n - 1)`` (in place).  Returns
    ``(res_len_after, full)``.

    ``mask`` ([B] bool, optional) freezes sequences: a ``False`` row keeps
    its residual and ``res_len`` unchanged.  ``v_res`` None (shared_kv):
    K alone."""
    block_n = k_res.shape[2]
    rows = torch.arange(k_new.shape[0], device=k_new.device)
    at = torch.clamp(res_len.long(), max=block_n - 1)
    for res, new in ((k_res, k_new), (v_res, v_new)):
        if res is None:  # shared_kv: no V residual
            continue
        new = new[:, :, 0].to(res.dtype)  # [B, H, d]
        if mask is not None:
            new = torch.where(mask[:, None, None], new, res[rows, :, at])
        res[rows, :, at] = new
    step = 1 if mask is None else mask.to(torch.int32)
    rl = res_len + step
    return rl, rl == block_n


def _commit_lengths(pack_blocks, res_len, rl, full):
    pack_blocks.copy_(torch.where(full, pack_blocks + 1, pack_blocks))
    res_len.copy_(torch.where(full, torch.zeros_like(rl), rl))


def append_flush_ref(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, k_new,
                     v_new, pack_blocks, res_len, arrive=None, *, mask=None, bits: int,
                     block_n: int, k_gran: str, shared_kv: bool = False,
                     flush=residual_flush_ref):
    """A dense cache's decode append, in place: the new token (k_new/v_new
    [B, H, 1, d]) into the residual, the rows it fills flushed into block
    ``pack_blocks[b]`` by ``flush``, then ``pack_blocks += full`` and
    ``res_len = full ? 0 : res_len + step``.  ``arrive`` (the kernel's
    counter) is not used.  ``flush`` takes :func:`residual_flush_ref`'s
    arguments; passing the kernel's flush mode gives the unfused op sequence
    the fused kernel replaces."""
    rl, full = append_residual(k_res, None if shared_kv else v_res, res_len, k_new, v_new,
                               mask)
    flush(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, full.to(torch.int32),
          pack_blocks, bits=bits, block_n=block_n, k_gran=k_gran, shared_kv=shared_kv)
    _commit_lengths(pack_blocks, res_len, rl, full)
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def paged_append_flush_ref(kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
                           v_zero_pool, k_res, v_res, k_new, v_new, page_table,
                           pack_blocks, res_len, arrive=None, *, mask=None, bits: int,
                           block_n: int, k_gran: str, shared_kv: bool = False,
                           flush=paged_residual_flush_ref, page_lo: int = 0,
                           pages_total: int | None = None):
    """A paged cache's decode append, in place: as :func:`append_flush_ref`,
    the destination of row ``b`` being ``page_table[b, clamp(pack_blocks[b],
    0, nb_max - 1)]`` when its residual filled, else its scratch page ``b``,
    clamped to ``[0, P - 1]``.  With a page range (the pools hold pages
    ``[page_lo, page_lo + P)`` of ``pages_total``), the destination is
    clamped to ``[0, pages_total - 1]`` and a row whose page lies outside
    the range flushes nothing; residuals and lengths as without it."""
    b, nb_max = page_table.shape
    n_pages = kw_pool.shape[0]
    rl, full = append_residual(k_res, None if shared_kv else v_res, res_len, k_new, v_new,
                               mask)
    rows = torch.arange(b, device=rl.device)
    blk = torch.clamp(pack_blocks.long(), 0, nb_max - 1)
    dest = torch.where(full, page_table[rows, blk], rows.to(torch.int32))
    total = n_pages if pages_total is None else pages_total
    dest = torch.clamp(dest, 0, total - 1) - page_lo
    write = full & (dest >= 0) & (dest < n_pages)
    flush(kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool, k_res,
          v_res, write.to(torch.int32), torch.clamp(dest, 0, n_pages - 1), bits=bits,
          block_n=block_n, k_gran=k_gran, shared_kv=shared_kv)
    _commit_lengths(pack_blocks, res_len, rl, full)
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool
