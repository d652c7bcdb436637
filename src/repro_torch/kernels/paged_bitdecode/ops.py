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
                         draft_bits: int | None = None):
    """The kernel (and merge) on CUDA tensors: (out, lse); ``draft_bits`` as
    in ``bitdecode.ops.bitdecode_cuda``."""
    b, h, g, d_k = q.shape
    n_pages, _, npr, _ = kw_pool.shape
    nb_max = page_table.shape[1]
    d_v, res_n = vw_pool.shape[-1], k_res.shape[2]
    bd_ops.check_kernel_shapes(g=g, d_k=d_k, d_v=d_v, block_n=block_n, bits=bits, npr=npr,
                               res_n=res_n)
    if any(t.dtype != torch.bfloat16 for t in (k_scale_pool, v_scale_pool, k_res, v_res)):
        raise ValueError("the CUDA decode kernel takes bf16 params and residuals")
    arrays = [bd_ops.kernel_operand(t, "pools and residuals") for t in (
        kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool, k_res, v_res)]
    arrays += [page_table.to(torch.int32).contiguous(), pack_blocks.to(torch.int32).contiguous(),
               res_len.to(torch.int32).contiguous()]
    units = bd_ops.work_units(nb_max, block_n, bits, res_n)
    splits = bd_ops.resolve_num_splits(num_splits, b, h, units, q.device, g=g, d=d_k,
                                       block_n=block_n, bits=bits,
                                       k_channel=k_gran == "channel")
    return bd_ops.launch_decode(
        "paged_bitdecode", bd_ops.query_operand(q), arrays,
        (d_k, d_v, nb_max, n_pages, block_n, res_n, bits, int(k_gran == "channel")),
        d_v=d_v, num_splits=splits, sm_scale=sm_scale,
        shift=bd_ops.draft_shift(bits, draft_bits))


def paged_bitdecode_attention(q, kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                              v_scale_pool, v_zero_pool, k_res, v_res,
                              page_table, pack_blocks, res_len, *, bits: int,
                              block_n: int = 128, sm_scale: float | None = None,
                              k_gran: str = "channel", shared_kv: bool = False,
                              d_v: int | None = None, impl: str = "auto",
                              num_splits: int | str | None = "auto",
                              return_lse: bool = False,
                              draft_bits: int | None = None):
    """Fused low-bit decode attention over the page pools + bf16 residual.

    q: [B, H_kv, g, d_k] (query-transformed); see ref.py for the shapes.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors).
    ``draft_bits`` (the speculative draft read) runs in the kernel as in
    the dense wrapper; ``shared_kv`` (MLA latent pools) exists in the plain
    version only: on CUDA tensors it raises unless the caller asks for
    ``impl='torch'``.  The plain version resolves ``num_splits="auto"`` to
    1; explicit integers are honoured.
    """
    d_k = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if draft_bits is not None and draft_bits >= bits:
        draft_bits = None  # a full-fidelity read is the normal path
    impl = _build.resolve_impl(impl, q, kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                               v_scale_pool, v_zero_pool, k_res, v_res, page_table,
                               pack_blocks, res_len)
    if impl == "cuda" and shared_kv:
        raise ValueError("shared_kv has no CUDA kernel; pass impl='torch' for the plain "
                         "version")
    if impl == "torch":
        out, lse = _ref.paged_bitdecode_attention_ref(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, shared_kv=shared_kv, d_v=d_v,
            num_splits=bd_ops.resolve_num_splits(num_splits, 1, 1, 1, "cpu"),  # "auto": 1
            draft_bits=draft_bits,
        )
    else:
        out, lse = paged_bitdecode_cuda(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, num_splits=num_splits, draft_bits=draft_bits,
        )
    return (out, lse) if return_lse else out
