"""Plain PyTorch version of the fused quantize + pack (Residual) kernel."""
from __future__ import annotations

import torch

from repro_torch.core import quantizer


def quantize_kv_ref(x, bits: int, granularity: str, *, block_n: int = 128,
                    param_dtype=torch.bfloat16):
    """Quantize + pack x[B, H, S, d] (S % block_n == 0) with the strided
    block layout.

    Returns words int32 [B, H, nb, npr, d] and scale/zero [B, H, nb, d]
    (channel) or [B, H, nb, block_n] (tensor).
    """
    b, h, s, d = x.shape
    if s % block_n:
        raise ValueError(f"S={s} must be a multiple of block_n={block_n}")
    xb = x.reshape(b, h, s // block_n, block_n, d)
    return quantizer.quantize_and_pack(xb, bits, granularity, param_dtype=param_dtype)


def write_into(out, result):
    """Copy ``result`` (words, scale, zero) into the views ``out``."""
    for dst, src in zip(out, result):
        dst.copy_(src)
    return out


def quantize_kv_pair_ref(k, v, bits: int, k_gran: str, *, block_n: int = 128, out_k, out_v):
    """The pair's plain version: K (params per ``k_gran``) and V (per token)
    through :func:`quantize_kv_ref`, each copied into its ``(words, scale,
    zero)`` views."""
    for x, gran, out in ((k, k_gran, out_k), (v, "tensor", out_v)):
        write_into(out, quantize_kv_ref(x, bits, gran, block_n=block_n,
                                        param_dtype=out[1].dtype))
    return out_k, out_v
