"""Entry point of the fused residual flush (quantize + pack + commit): the
CUDA kernel (``csrc/residual_flush.cu``) or its plain PyTorch version."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.residual_flush import ref as _ref


def residual_flush_cuda(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                        full, dest_block, *, bits: int, block_n: int, k_gran: str):
    """Launch the kernel: one program per (b, h); programs of rows with
    ``full[b] == 0`` return at once.  Updates the packed arrays in place."""
    b, h, nb, npr, d_k = kw.shape
    d_v = vw.shape[-1]
    if k_res.shape != (b, h, block_n, d_k) or v_res.shape != (b, h, block_n, d_v):
        raise ValueError("residual buffers must be [B, H, block_n, d]")
    if npr * 32 != block_n * bits:
        raise ValueError(f"packed words {kw.shape} do not match bits={bits}, block_n={block_n}")
    arrays = (kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res)
    if any(not t.is_contiguous() for t in arrays):
        raise ValueError("the CUDA flush writes the cache in place: arrays must be contiguous")
    if (k_scale.dtype, v_scale.dtype, k_res.dtype, v_res.dtype) != (torch.bfloat16,) * 4:
        raise ValueError("the CUDA flush takes bf16 params and bf16 residuals")
    full = full.to(torch.int32).contiguous()
    dest = dest_block.to(torch.int32).contiguous()
    _build.launch(
        "residual_flush", *(t.data_ptr() for t in arrays), full.data_ptr(),
        dest.data_ptr(), b, h, nb, block_n, d_k, d_v, bits,
        int(k_gran == "channel"), _build.stream_of(kw),
    )
    return kw, k_scale, k_zero, vw, v_scale, v_zero


def residual_flush(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                   full, dest_block, *, bits: int, block_n: int, k_gran: str,
                   impl: str = "auto"):
    """Commit the bf16 residual of every sequence with ``full[b] != 0`` into
    packed block ``dest_block[b]`` (clamped to ``nb - 1``), in place.

    Callers run it on every decode step: neither path reads ``full`` on the
    host.  impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors).
    """
    args = (kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res, full, dest_block)
    fn = residual_flush_cuda if _build.resolve_impl(impl, *args) == "cuda" else _ref.residual_flush_ref
    return fn(*args, bits=bits, block_n=block_n, k_gran=k_gran)
