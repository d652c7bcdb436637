"""Min/max quantization policies for the low-bit KV cache (paper §V-B).

* **channel-wise** (K default): one (scale, zero) pair per channel per block,
  statistics taken along the token axis.  Params per block: ``[d]``.
* **tensor-wise** (V always): one pair per token, statistics taken along the
  channel axis.  Params per block: ``[block_n]``.

Asymmetric uint quantization ``q = clip(round((x - zero) / scale))``: the
params are cast to ``param_dtype`` *before* quantizing, the divisions are
true IEEE divisions on the CPU and the card alike (a multiply by the
reciprocal changes codes and scales) and ``torch.round`` rounds half to
even.  Written this way the codes, words and params equal the
JAX reference bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import layout

_EPS = 1e-6


def _minmax_params(xmin, xmax, bits, param_dtype):
    # qmax as a tensor on the data's device: divided by a Python number,
    # PyTorch's CUDA kernel multiplies by the number's reciprocal, and an
    # exact bf16 tie of the quotient then rounds the other way
    qmax = torch.full((), float(layout.qmax(bits)), dtype=torch.float32, device=xmax.device)
    scale = torch.clamp_min((xmax - xmin) / qmax, _EPS)
    return scale.to(param_dtype), xmin.to(param_dtype)


def quant_params(x: torch.Tensor, bits: int, granularity: str, *,
                 param_dtype=torch.bfloat16):
    """(scale, zero) of a block x[..., block_n, d]: ``[..., d]`` (channel) or
    ``[..., block_n]`` (tensor)."""
    x = x.float()
    if granularity == "channel":
        return _minmax_params(x.amin(dim=-2), x.amax(dim=-2), bits, param_dtype)
    if granularity == "tensor":
        return _minmax_params(x.amin(dim=-1), x.amax(dim=-1), bits, param_dtype)
    raise ValueError(f"unknown granularity {granularity!r}")


def _broadcast_params(p: torch.Tensor, granularity: str) -> torch.Tensor:
    if granularity == "channel":
        return p[..., None, :]  # [..., 1, d]
    if granularity == "tensor":
        return p[..., :, None]  # [..., n, 1]
    raise ValueError(granularity)


def quantize_block(x, scale, zero, bits: int, granularity: str) -> torch.Tensor:
    """x[..., block_n, d] -> codes int32[..., block_n, d]."""
    s = _broadcast_params(scale.float(), granularity)
    z = _broadcast_params(zero.float(), granularity)
    q = torch.round((x.float() - z) / s)
    return torch.clamp(q, 0, layout.qmax(bits)).to(torch.int32)


def dequantize_block(q, scale, zero, granularity: str, *, dtype=torch.bfloat16):
    s = _broadcast_params(scale.float(), granularity)
    z = _broadcast_params(zero.float(), granularity)
    return (q.float() * s + z).to(dtype)


def quantize_and_pack(x, bits: int, granularity: str, *, param_dtype=torch.bfloat16):
    """Block x[..., block_n, d] -> (words int32[..., block_n // R, d], scale, zero)."""
    scale, zero = quant_params(x, bits, granularity, param_dtype=param_dtype)
    q = quantize_block(x, scale, zero, bits, granularity)
    return layout.pack_strided(q, bits), scale, zero


def unpack_and_dequantize(words, scale, zero, bits: int, granularity: str, *,
                          dtype=torch.bfloat16):
    q = layout.unpack_strided(words, bits)
    return dequantize_block(q, scale, zero, granularity, dtype=dtype)
