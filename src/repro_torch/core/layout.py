"""Strided low-bit packing layout (paper §IV-A(1)), shared by every kernel.

A block of ``block_n`` tokens × ``d`` channels is quantized to ``bits``-wide
unsigned codes and packed into int32 words, ``R = 32 // bits`` codes a word:

    word[i, c]  packs tokens  {k * (block_n // R) + i : k in [0, R)}
    bit-field k of word[i, c] = q[k * (block_n // R) + i, c]

so extracting bit-plane ``k`` (one shift, one mask) yields the contiguous
token range ``[k*block_n/R, (k+1)*block_n/R)``, and stacking the planes in
order gives the block back in natural token order.  Plane ``R-1`` may set the
sign bit (bits=8: ``255 << 24``); torch's int32 ``<<`` wraps like the JAX
reference, and unpack masks after an arithmetic shift so the sign never
leaks into a code.
"""
from __future__ import annotations

import torch

SUPPORTED_BITS = (2, 4, 8)
WORD_BITS = 32


def packing_ratio(bits: int) -> int:
    """Values per int32 word (paper's R = word / beta)."""
    if bits not in SUPPORTED_BITS:
        raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got {bits}")
    return WORD_BITS // bits


def words_per_block(block_n: int, bits: int) -> int:
    r = packing_ratio(bits)
    if block_n % r:
        raise ValueError(f"block_n={block_n} must be a multiple of R={r}")
    return block_n // r


def qmax(bits: int) -> int:
    return (1 << bits) - 1


def pack_strided(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack codes int32[..., block_n, d] in [0, 2**bits) into
    int32[..., block_n // R, d] with the strided layout."""
    r = packing_ratio(bits)
    *lead, n, d = q.shape
    npr = words_per_block(n, bits)
    planes = q.to(torch.int32).reshape(*lead, r, npr, d)
    word = planes[..., 0, :, :].clone()
    for k in range(1, r):
        word |= planes[..., k, :, :] << (bits * k)
    return word


def unpack_strided(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_strided`: int32[..., npr, d] ->
    int32[..., npr * R, d] in natural token order."""
    r = packing_ratio(bits)
    mask = qmax(bits)
    planes = [(w >> (bits * k)) & mask for k in range(r)]
    stacked = torch.stack(planes, dim=-3)  # [..., R, npr, d]
    *lead, _, npr, d = stacked.shape
    return stacked.reshape(*lead, r * npr, d)
