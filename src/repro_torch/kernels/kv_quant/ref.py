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
