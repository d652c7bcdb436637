"""Entry point of the fused KV quantize + pack: the CUDA kernel
(``csrc/kv_quant.cu``) or its plain PyTorch version (``ref.py``)."""
from __future__ import annotations

import torch

from repro_torch.core import layout
from repro_torch.kernels import _build
from repro_torch.kernels.kv_quant import ref as _ref


def quantize_kv_cuda(x, bits: int, granularity: str, *, block_n: int = 128,
                     param_dtype=torch.bfloat16):
    """Launch the kernel on x[B, H, S, d] (bf16 on the card, unit channel
    stride; other strides are read as they are).  Same outputs as
    :func:`ref.quantize_kv_ref`, bit for bit."""
    b, h, s, d = x.shape
    if s % block_n:
        raise ValueError(f"S={s} must be a multiple of block_n={block_n}")
    if x.dtype != torch.bfloat16 or param_dtype != torch.bfloat16:
        raise ValueError("the CUDA kernel takes bf16 inputs and bf16 params")
    if granularity not in ("channel", "tensor"):
        raise ValueError(f"unknown granularity {granularity!r}")
    if x.stride(-1) != 1:
        x = x.contiguous()
    nb = s // block_n
    npr = layout.words_per_block(block_n, bits)
    np_ = d if granularity == "channel" else block_n
    words = torch.empty((b, h, nb, npr, d), dtype=torch.int32, device=x.device)
    scale = torch.empty((b, h, nb, np_), dtype=param_dtype, device=x.device)
    zero = torch.empty_like(scale)
    sb, sh, st, _ = x.stride()
    _build.launch(
        "kv_quant", x.data_ptr(), sb, sh, st, words.data_ptr(), scale.data_ptr(),
        zero.data_ptr(), b, h, nb, block_n, d, bits,
        int(granularity == "channel"), _build.stream_of(x),
    )
    return words, scale, zero


def quantize_kv(x, bits: int, granularity: str, *, block_n: int = 128,
                param_dtype=torch.bfloat16, impl: str = "auto"):
    """Quantize + pack x[B, H, S, d] into (words[B, H, nb, npr, d], scale, zero).

    impl: 'cuda' (the kernel), 'torch' (the plain version) or 'auto' (the
    kernel for a CUDA tensor, the plain version for a CPU tensor).
    """
    if _build.resolve_impl(impl, x) == "cuda":
        return quantize_kv_cuda(x, bits, granularity, block_n=block_n,
                                param_dtype=param_dtype)
    return _ref.quantize_kv_ref(x, bits, granularity, block_n=block_n,
                                param_dtype=param_dtype)
