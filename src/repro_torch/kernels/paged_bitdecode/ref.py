"""Plain PyTorch version of the paged low-bit decode attention: gather each
sequence's pool pages through its page-table row into the dense layout, then
run the dense version (``kernels/bitdecode/ref.py``), which also owns the
``shared_kv`` and ``draft_bits`` semantics."""
from __future__ import annotations

import torch

from repro_torch.kernels.bitdecode import ref as bd_ref


def gather_pages(pool, page_table):
    """pool [P, H, ...] + page_table [B, nb] -> [B, H, nb, ...]."""
    if pool is None:  # shared_kv: no V-side pools
        return None
    return pool[page_table.long()].movedim(2, 1)


def paged_bitdecode_attention_ref(q, kw_pool, k_scale_pool, k_zero_pool,
                                  vw_pool, v_scale_pool, v_zero_pool, k_res,
                                  v_res, page_table, pack_blocks, res_len, *,
                                  bits: int, block_n: int = 128,
                                  sm_scale: float | None = None,
                                  k_gran: str = "channel", shared_kv: bool = False,
                                  d_v: int | None = None, num_splits: int = 1,
                                  draft_bits: int | None = None, block_lo: int = 0,
                                  n_blocks: int | None = None, read_res: bool = True,
                                  page_lo: int = 0):
    """q: [B, H_kv, g, d_k]; pools [P, H_kv, npr, d] (words) and
    [P, H_kv, d_k | block_n] (params); page_table int32 [B, nb_max];
    k_res/v_res bf16 [B, H_kv, N_r, d].  The column window (``block_lo``,
    ``n_blocks``, ``read_res``) is the dense version's block window over the
    table's columns; page ids less ``page_lo`` are clamped into ``[0, P)``,
    as the kernel reads them.  Returns (out [B, H, g, d_v] f32, lse
    [B, H, g] f32)."""
    nb_max = page_table.shape[1]
    lo = min(block_lo, nb_max)
    hi = nb_max if n_blocks is None else min(nb_max, lo + n_blocks)
    page_table = torch.clamp(page_table[:, lo:hi].long() - page_lo, 0, kw_pool.shape[0] - 1)
    if lo or hi < nb_max:
        pack_blocks = torch.clamp(pack_blocks - block_lo, 0, hi - lo)
    if not read_res:
        res_len = torch.zeros_like(res_len)
    pools = [gather_pages(p, page_table) for p in (
        kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool)]
    return bd_ref.bitdecode_attention_ref(
        q, *pools, k_res, v_res, pack_blocks, res_len, bits=bits,
        block_n=block_n, sm_scale=sm_scale, k_gran=k_gran, shared_kv=shared_kv,
        d_v=d_v, num_splits=num_splits, draft_bits=draft_bits,
    )
