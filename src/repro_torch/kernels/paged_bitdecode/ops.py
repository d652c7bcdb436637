"""Entry point of the paged low-bit decode attention (the paper's Page
setting): the split-KV CUDA kernel (``csrc/paged_bitdecode.cu``) followed by
the logsumexp merge, or the plain PyTorch version (``ref.py``).

The split count resolves as the dense wrapper's does, over the page table's
width (``page_table.shape[1]``): a step's work and its split boundaries then
depend on the table's shape alone, not on how full any row is.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bitdecode import ops as bd_ops
from repro_torch.kernels.bitdecode import ref as bd_ref
from repro_torch.kernels.paged_bitdecode import ref as _ref


def paged_bitdecode_partials_cuda(q, kw_pool, k_scale_pool, k_zero_pool,
                                  vw_pool, v_scale_pool, v_zero_pool, k_res,
                                  v_res, page_table, pack_blocks, res_len, *,
                                  bits: int, block_n: int, sm_scale: float,
                                  k_gran: str, num_splits: int):
    """Launch the kernel: per-split partials (o [S, B, H, g, d_v] f32,
    lse [S, B, H, g] f32)."""
    b, h, g, d_k = q.shape
    n_pages, _, npr, _ = kw_pool.shape
    nb_max = page_table.shape[1]
    d_v = vw_pool.shape[-1]
    res_n = k_res.shape[2]
    if npr * 32 != block_n * bits:
        raise ValueError(f"packed words {kw_pool.shape} do not match bits={bits}, "
                         f"block_n={block_n}")
    if d_k % 2:
        raise ValueError(f"d_k={d_k} must be even")
    arrays = [q.to(torch.bfloat16).contiguous(), kw_pool, k_scale_pool, k_zero_pool,
              vw_pool, v_scale_pool, v_zero_pool, k_res, v_res]
    if any(not t.is_contiguous() for t in arrays):
        raise ValueError("the CUDA decode kernel takes contiguous pools and residuals")
    if any(t.dtype != torch.bfloat16 for t in (k_scale_pool, v_scale_pool, k_res, v_res)):
        raise ValueError("the CUDA decode kernel takes bf16 params and residuals")
    table = page_table.to(torch.int32).contiguous()
    pb = pack_blocks.to(torch.int32).contiguous()
    rl = res_len.to(torch.int32).contiguous()
    num_splits = max(1, min(num_splits, nb_max))
    bps = -(-nb_max // num_splits)
    o = torch.empty((num_splits, b, h, g, d_v), dtype=torch.float32, device=q.device)
    lse = torch.empty((num_splits, b, h, g), dtype=torch.float32, device=q.device)
    _build.launch(
        "paged_bitdecode", *(t.data_ptr() for t in arrays), table.data_ptr(),
        pb.data_ptr(), rl.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, g, d_k,
        d_v, nb_max, n_pages, block_n, res_n, bits, int(k_gran == "channel"),
        num_splits, bps, float(sm_scale), _build.stream_of(q),
    )
    return o, lse


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
    ``shared_kv`` (MLA latent pools) and ``draft_bits`` (truncated draft
    read) exist in the plain version only: on CUDA tensors they raise unless
    the caller asks for ``impl='torch'``.  The plain version resolves
    ``num_splits="auto"`` to 1; explicit integers are honoured.
    """
    b, h, g, d_k = q.shape
    nb_max = page_table.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    if draft_bits is not None and draft_bits >= bits:
        draft_bits = None  # a full-fidelity read is the normal path
    impl = _build.resolve_impl(impl, q, kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                               v_scale_pool, v_zero_pool, k_res, v_res, page_table,
                               pack_blocks, res_len)
    if impl == "cuda" and (shared_kv or draft_bits is not None):
        raise ValueError("shared_kv and draft_bits have no CUDA kernel; pass impl='torch' "
                         "for the plain version")
    if num_splits in (None, "auto") and impl == "torch":
        num_splits = 1
    else:
        num_splits = bd_ops.resolve_num_splits(num_splits, b, h, nb_max, q.device)

    if impl == "torch":
        out, lse = _ref.paged_bitdecode_attention_ref(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, shared_kv=shared_kv, d_v=d_v,
            num_splits=num_splits, draft_bits=draft_bits,
        )
    else:
        o_parts, lse_parts = paged_bitdecode_partials_cuda(
            q, kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool,
            k_res, v_res, page_table, pack_blocks, res_len, bits=bits, block_n=block_n,
            sm_scale=sm_scale, k_gran=k_gran, num_splits=num_splits,
        )
        if o_parts.shape[0] == 1:
            out, lse = o_parts[0], lse_parts[0]
        else:
            out, lse = bd_ref.merge_partials(o_parts, lse_parts)
    return (out, lse) if return_lse else out
