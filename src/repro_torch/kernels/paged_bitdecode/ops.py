"""Entry point of the paged low-bit decode attention (the paper's Page
setting): the split-KV CUDA kernel (``csrc/paged_bitdecode.cu``) and, with
more than one split, the dense kernel's merge (``bitdecode_merge``), or the
plain PyTorch version (``ref.py``).

The split count resolves as the dense wrapper's does, over the page table's
width (``page_table.shape[1]``): a step's launch shape depends on the
table's shape alone, not on how full any row is; the kernel cuts each row's
work by that row's own lengths on the device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.paged_bitdecode import ref as _ref


def paged_bitdecode_cuda(q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
                         v_zero_pool, k_res, v_res, page_table, pack_blocks, res_len, *,
                         bits: int, block_n: int, sm_scale: float, k_gran: str, num_splits,
                         draft_bits: int | None = None, shared_kv: bool = False,
                         d_v: int | None = None, block_lo: int = 0,
                         n_blocks: int | None = None, read_res: bool = True,
                         page_lo: int = 0):
    """The kernel (and merge) on CUDA tensors: (out, lse); ``draft_bits``,
    ``shared_kv`` and the column window (``block_lo``, ``n_blocks``,
    ``read_res``) as in ``bitdecode.ops.bitdecode_cuda``; ``page_lo`` rebases
    the table's page ids into pools that hold pages ``[page_lo, page_lo +
    P)``, clamped into them."""
    b, h, g, d_k = q.shape
    n_pages, _, npr, _ = kw_pool.shape
    nb_max = page_table.shape[1]
    window = bd_ops.block_window(nb_max, block_lo, n_blocks, read_res) + (int(page_lo),)
    d_v = d_v if shared_kv else vw_pool.shape[-1]
    res_n = k_res.shape[2]
    bd_ops.check_kernel_shapes(g=g, d_k=d_k, d_v=d_v, block_n=block_n, bits=bits, npr=npr,
                               res_n=res_n, shared_kv=shared_kv, k_gran=k_gran)
    arrays = bd_ops.cache_operands((kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
                                    v_zero_pool, k_res, v_res), "pools and residuals",
                                   shared_kv)
    arrays += [page_table.to(torch.int32).contiguous(), pack_blocks.to(torch.int32).contiguous(),
               res_len.to(torch.int32).contiguous()]
    units = bd_ops.work_units(nb_max if n_blocks is None else n_blocks, block_n, bits, res_n)
    k_channel = k_gran == "channel"
    splits = bd_ops.resolve_num_splits(num_splits, b, h, units, q.device, g=g, d=d_k,
                                       block_n=block_n, bits=bits, k_channel=k_channel,
                                       shared_kv=shared_kv, d_v=d_v)
    return bd_ops.launch_decode(
        "paged_bitdecode", bd_ops.query_operand(q), arrays,
        (d_k, d_v, nb_max, n_pages, block_n, res_n, bits, int(k_channel), int(shared_kv)),
        d_v=d_v, num_splits=splits, sm_scale=sm_scale,
        shift=bd_ops.draft_shift(bits, draft_bits), window=window)


def paged_bitdecode_attention(q, kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                              v_scale_pool, v_zero_pool, k_res, v_res,
                              page_table, pack_blocks, res_len, *, bits: int,
                              block_n: int = 128, sm_scale: float | None = None,
                              k_gran: str = "channel", shared_kv: bool = False,
                              d_v: int | None = None, impl: str = "auto",
                              num_splits: int | str | None = "auto",
                              return_lse: bool = False,
                              draft_bits: int | None = None, block_lo: int = 0,
                              n_blocks: int | None = None, read_res: bool = True,
                              page_lo: int = 0):
    """Fused low-bit decode attention over the page pools + bf16 residual.

    q: [B, H_kv, g, d_k] (query-transformed); see ref.py for the shapes.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors).
    ``draft_bits`` (the speculative draft read) and ``shared_kv`` (MLA
    latent pools: V is the first ``d_v`` channels of K) run in the kernel
    as in the dense wrapper.  The plain version resolves
    ``num_splits="auto"`` to 1; explicit integers are honoured.  The column
    window (``block_lo``, ``n_blocks``, ``read_res``) walks table columns
    ``[block_lo, block_lo + n_blocks)`` as the dense wrapper's block window
    does; ``page_lo`` rebases the table's page ids into pools holding pages
    ``[page_lo, page_lo + P)`` (a rank's page-affine pools), clamped into
    them.  The defaults are the whole call.
    """
    d_k = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if draft_bits is not None and draft_bits >= bits:
        draft_bits = None  # a full-fidelity read is the normal path
    impl = _build.resolve_impl(impl, q, kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                               v_scale_pool, v_zero_pool, k_res, v_res, page_table,
                               pack_blocks, res_len)
    if shared_kv and d_v is None:
        raise ValueError("shared_kv requires d_v")
    if impl == "torch":
        out, lse = _ref.paged_bitdecode_attention_ref(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, shared_kv=shared_kv, d_v=d_v,
            num_splits=bd_ops.resolve_num_splits(num_splits, 1, 1, 1, "cpu"),  # "auto": 1
            draft_bits=draft_bits, block_lo=block_lo, n_blocks=n_blocks, read_res=read_res,
            page_lo=page_lo,
        )
    else:
        out, lse = paged_bitdecode_cuda(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, num_splits=num_splits, draft_bits=draft_bits,
            shared_kv=shared_kv, d_v=d_v, block_lo=block_lo, n_blocks=n_blocks,
            read_res=read_res, page_lo=page_lo,
        )
    return (out, lse) if return_lse else out
