"""Shared model layers: RMSNorm, RoPE, the SwiGLU MLP, embeddings."""
from __future__ import annotations

import torch

from repro_torch.models.params import P


def rmsnorm_def(d: int):
    return {"w": P((d,), "ones", torch.float32)}


def rmsnorm(p, x, *, eps: float = 1e-6):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["w"]).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, *, theta: float):
    """Split-half rotary embedding; x: [B, S, H, d], positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions.float()[:, :, None] * freqs[None, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_def(d: int, d_ff: int):
    return {"wi": P((d, 2 * d_ff)), "wo": P((d_ff, d))}


def silu(x):
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype: how XLA evaluates a bf16 ``jax.nn.silu``.  A
    sigmoid rounded once differs from it in about a third of bf16 elements,
    enough to move the smoke model's logits past the reference tolerance."""
    return x * (1 / (1 + torch.exp(-x)))


def mlp(p, x):
    """SwiGLU: ``wi`` projects to ``[u | g]``; returns ``(u * silu(g)) @ wo``."""
    u, g = torch.matmul(x, p["wi"]).chunk(2, dim=-1)
    return torch.matmul(u * silu(g), p["wo"])


def embed_def(vocab: int, d: int):
    return {"table": P((vocab, d), "embed")}


def embed(p, tokens):
    return p["table"][tokens]


def unembed_def(d: int, vocab: int):
    return {"w": P((d, vocab))}


def unembed(p, x, true_vocab: int | None = None):
    logits = torch.matmul(x, p["w"]).float()
    return mask_padded_vocab(logits, true_vocab)


def mask_padded_vocab(logits, true_vocab: int | None):
    """Mask logits of vocab-padding ids (see ArchConfig.padded_vocab)."""
    v = logits.shape[-1]
    if true_vocab is None or true_vocab == v:
        return logits
    ids = torch.arange(v, device=logits.device)
    return torch.where(ids < true_vocab, logits, -1e30)
