"""Entry points of the fused residual flush (quantize + pack + commit), dense
and paged: the CUDA kernels (``csrc/residual_flush.cu``) or their plain
PyTorch versions."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.residual_flush import ref as _ref


def _check_flush_args(arrays, b, h, npr, bits, block_n):
    """``arrays``: kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res."""
    kw, vw, k_res, v_res = arrays[0], arrays[3], arrays[6], arrays[7]
    if (tuple(k_res.shape) != (b, h, block_n, kw.shape[-1])
            or tuple(v_res.shape) != (b, h, block_n, vw.shape[-1])):
        raise ValueError("residual buffers must be [B, H, block_n, d]")
    if npr * 32 != block_n * bits:
        raise ValueError(f"packed words do not match bits={bits}, block_n={block_n}")
    if any(not t.is_contiguous() for t in arrays):
        raise ValueError("the CUDA flush writes the cache in place: arrays must be contiguous")
    if tuple(arrays[i].dtype for i in (1, 4, 6, 7)) != (torch.bfloat16,) * 4:
        raise ValueError("the CUDA flush takes bf16 params and bf16 residuals")


def residual_flush_cuda(kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res,
                        full, dest_block, *, bits: int, block_n: int, k_gran: str):
    """Launch the kernel: one program per (b, h); programs of rows with
    ``full[b] == 0`` return at once.  Updates the packed arrays in place."""
    b, h, nb, npr, d_k = kw.shape
    d_v = vw.shape[-1]
    arrays = (kw, k_scale, k_zero, vw, v_scale, v_zero, k_res, v_res)
    _check_flush_args(arrays, b, h, npr, bits, block_n)
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


def paged_residual_flush_cuda(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                              v_scale_pool, v_zero_pool, k_res, v_res, full,
                              dest_page, *, bits: int, block_n: int, k_gran: str):
    """Launch the paged kernel: one program per (b, h); programs of rows with
    ``full[b] == 0`` return at once.  Updates the pools in place."""
    n_pages, h, npr, d_k = kw_pool.shape
    b, d_v = k_res.shape[0], vw_pool.shape[-1]
    arrays = (kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
              v_zero_pool, k_res, v_res)
    _check_flush_args(arrays, b, h, npr, bits, block_n)
    full = full.to(torch.int32).contiguous()
    dest = dest_page.to(torch.int32).contiguous()
    _build.launch(
        "paged_residual_flush", *(t.data_ptr() for t in arrays), full.data_ptr(),
        dest.data_ptr(), b, h, n_pages, block_n, d_k, d_v, bits,
        int(k_gran == "channel"), _build.stream_of(kw_pool),
    )
    return kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool, v_zero_pool


def paged_residual_flush(kw_pool, k_scale_pool, k_zero_pool, vw_pool,
                         v_scale_pool, v_zero_pool, k_res, v_res, full,
                         dest_page, *, bits: int, block_n: int, k_gran: str,
                         impl: str = "auto"):
    """Paged face: commit the bf16 residual of every sequence with
    ``full[b] != 0`` into pool page ``min(dest_page[b], P - 1)`` of the shared
    ``[P, H, ...]`` pools, in place.  ``dest_page`` entries must be pairwise
    distinct: callers point rows that do not flush at their own scratch page
    (pool pages ``[0, B)``).  Launched every decode step, like the dense
    flush: neither path reads ``full`` on the host.
    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors)."""
    args = (kw_pool, k_scale_pool, k_zero_pool, vw_pool, v_scale_pool,
            v_zero_pool, k_res, v_res, full, dest_page)
    fn = (paged_residual_flush_cuda if _build.resolve_impl(impl, *args) == "cuda"
          else _ref.paged_residual_flush_ref)
    return fn(*args, bits=bits, block_n=block_n, k_gran=k_gran)
