"""Entry points of the fused KV quantize + pack (K1): the CUDA kernel
(``csrc/kv_quant.cu``) or its plain PyTorch version (``ref.py``).

* :func:`quantize_kv`, the JAX function's counterpart: one tensor into fresh
  outputs, or into ``out=`` views in place;
* :func:`quantize_kv_pair`: a layer's K and V in one launch, straight into
  the cache's views (``core/qcache.py``).

Every launch counts once under ``kv_quant``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import layout
from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import ref as _ref

MAX_HEAD_DIM = 576  # the kernel's head dims: multiples of 8 up to this
MAX_BLOCK_N = 256


def _input(x, block_n: int):
    """x [B, H, S, d] as the kernel reads it: bf16, unit channel stride
    (copied to it if need be), 16-byte aligned rows."""
    if x.ndim != 4:
        raise ValueError(f"x must be [B, H, S, d], got {tuple(x.shape)}")
    if x.shape[2] % block_n:
        raise ValueError(f"S={x.shape[2]} must be a multiple of block_n={block_n}")
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the CUDA kernel takes bf16 inputs, got {x.dtype}")
    d = x.shape[-1]
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kv_quant takes head dims that are multiples of 8 up to "
                         f"{MAX_HEAD_DIM}, got {d}; use impl='torch'")
    if x.stride(-1) != 1:
        x = x.contiguous()
    if x.data_ptr() % 16 or any(st % 8 for st in x.stride()[:3]):
        raise ValueError("the CUDA kernel reads x in 16-byte chunks: align its rows")
    return x


def _fresh(x, bits: int, granularity: str, block_n: int, param_dtype):
    b, h, s, d = x.shape
    nb, npr = s // block_n, layout.words_per_block(block_n, bits)
    n_params = d if granularity == "channel" else block_n
    words = torch.empty((b, h, nb, npr, d), dtype=torch.int32, device=x.device)
    scale = torch.empty((b, h, nb, n_params), dtype=param_dtype, device=x.device)
    return words, scale, torch.empty_like(scale)


def _check_out(out, x, bits: int, granularity: str, block_n: int):
    """``out`` = (words [B, H, nb, npr, d] int32, scale, zero [B, H, nb, d or
    block_n] bf16): views with a unit last stride, the words 16-byte aligned."""
    b, h, s, d = x.shape
    nb, npr = s // block_n, layout.words_per_block(block_n, bits)
    n_params = d if granularity == "channel" else block_n
    words, scale, zero = out
    if (tuple(words.shape) != (b, h, nb, npr, d)
            or tuple(scale.shape) != (b, h, nb, n_params) or scale.shape != zero.shape):
        raise ValueError(f"out must be words [B, H, nb, npr, d] = {(b, h, nb, npr, d)} and "
                         f"scale / zero {(b, h, nb, n_params)}, got {tuple(words.shape)}, "
                         f"{tuple(scale.shape)}, {tuple(zero.shape)}")
    if words.dtype != torch.int32 or scale.dtype != torch.bfloat16 or zero.dtype != torch.bfloat16:
        raise ValueError("out must be int32 words and bf16 scale / zero")
    if any(t.stride(-1) != 1 for t in out):
        raise ValueError("out views must have a unit channel stride")
    if words.data_ptr() % 16 or any(st % 4 for st in words.stride()[:4]):
        raise ValueError("the CUDA kernel stores words in 16-byte chunks: align them")


def _launch(tensors, bits: int, k_gran: str, block_n: int) -> None:
    """One launch over ``tensors``: [(x, out)] for K (params per ``k_gran``)
    and, if a second is given, V (params per token)."""
    strides = []
    for x, (words, scale, zero) in tensors:
        strides += [*x.stride()[:3], *words.stride()[:4], *scale.stride()[:3],
                    *zero.stride()[:3]]
    (xk, (kw, ks, kz)), (xv, (vw, vs, vz)) = tensors[0], tensors[-1]
    b, h, s, dk = xk.shape
    if len(tensors) == 2 and tuple(xv.shape[:3]) != (b, h, s):
        raise ValueError(f"K and V must share B, H, S: {tuple(xk.shape)} vs {tuple(xv.shape)}")
    _build.launch(
        "kv_quant", xk.data_ptr(), xv.data_ptr(), kw.data_ptr(), ks.data_ptr(), kz.data_ptr(),
        vw.data_ptr(), vs.data_ptr(), vz.data_ptr(), (ctypes.c_longlong * len(strides))(*strides),
        b, h, s // block_n, block_n, dk, xv.shape[-1], bits, int(k_gran == "channel"),
        len(tensors), _build.stream_of(xk),
    )


def _check_block(bits: int, block_n: int, granularity: str) -> None:
    layout.words_per_block(block_n, bits)
    if block_n > MAX_BLOCK_N:
        raise ValueError(f"the CUDA kv_quant takes block_n up to {MAX_BLOCK_N}, got {block_n}")
    if granularity not in ("channel", "tensor"):
        raise ValueError(f"unknown granularity {granularity!r}")


def quantize_kv_cuda(x, bits: int, granularity: str, *, block_n: int = 128,
                     param_dtype=torch.bfloat16, out=None):
    """Launch the kernel on x[B, H, S, d] (bf16 on the card; strides are read
    as they are).  Same outputs as :func:`ref.quantize_kv_ref`, bit for bit,
    fresh or written into ``out``."""
    if param_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes bf16 params")
    _check_block(bits, block_n, granularity)
    x = _input(x, block_n)
    if out is None:
        out = _fresh(x, bits, granularity, block_n, param_dtype)
    _check_out(out, x, bits, granularity, block_n)
    _launch([(x, out)], bits, granularity, block_n)
    return tuple(out)


def quantize_kv(x, bits: int, granularity: str, *, block_n: int = 128,
                param_dtype=torch.bfloat16, impl: str = "auto", out=None):
    """Quantize + pack x[B, H, S, d] into (words[B, H, nb, npr, d], scale, zero),
    fresh or into the views ``out`` (written in place and returned).

    impl: 'cuda' (the kernel), 'torch' (the plain version) or 'auto' (the
    kernel for a CUDA tensor, the plain version for a CPU tensor).
    """
    if _build.resolve_impl(impl, x, *(out or ())) == "cuda":
        return quantize_kv_cuda(x, bits, granularity, block_n=block_n,
                                param_dtype=param_dtype, out=out)
    result = _ref.quantize_kv_ref(x, bits, granularity, block_n=block_n,
                                  param_dtype=param_dtype)
    return result if out is None else tuple(_ref.write_into(out, result))


def quantize_kv_pair_cuda(k, v, bits: int, k_gran: str, *, block_n: int = 128, out_k, out_v):
    """One launch of the kernel over K and V, into ``out_k`` / ``out_v``."""
    _check_block(bits, block_n, k_gran)
    k, v = _input(k, block_n), _input(v, block_n)
    _check_out(out_k, k, bits, k_gran, block_n)
    _check_out(out_v, v, bits, "tensor", block_n)
    _launch([(k, out_k), (v, out_v)], bits, k_gran, block_n)
    return out_k, out_v


def quantize_kv_pair(k, v, bits: int, k_gran: str, *, block_n: int = 128, out_k, out_v,
                     impl: str = "auto"):
    """Quantize + pack a layer's k and v [B, H, S, d] into the views
    ``out_k`` / ``out_v`` = (words, scale, zero), in place: K with params per
    ``k_gran``, V per token.  On the card one launch does both.

    impl: 'cuda' | 'torch' | 'auto' (the kernel for CUDA tensors)."""
    args = (k, v, *out_k, *out_v)
    fn = (quantize_kv_pair_cuda if _build.resolve_impl(impl, *args) == "cuda"
          else _ref.quantize_kv_pair_ref)
    return fn(k, v, bits, k_gran, block_n=block_n, out_k=out_k, out_v=out_v)
