"""Shared model layers: norms, RoPE, the MLPs, embeddings."""
from __future__ import annotations

import math

import torch
import torch.utils.checkpoint

from repro_torch.models.params import P


def remat(cfg, fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass when
    ``cfg.remat == "full"`` (``torch.utils.checkpoint``, the JAX package's
    ``jax.checkpoint`` around the same unit); the values are the same either
    way.  Without autograd (prefill, decode) it is a plain call."""
    if cfg.remat == "full" and torch.is_grad_enabled():
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def rmsnorm_def(d: int, *, plus_one: bool = False):
    """A ``(1 + w)`` norm starts from w = 0, the identity scale (the JAX
    package draws w = 1; see models/params.py)."""
    return {"w": P((d,), "zeros" if plus_one else "ones", torch.float32)}


def rmsnorm(p, x, *, eps: float = 1e-6, plus_one: bool = False):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    w = p["w"] + 1.0 if plus_one else p["w"]
    return (xf * torch.rsqrt(var + eps) * w).to(x.dtype)


def layernorm_def(d: int):
    return {"w": P((d,), "ones", torch.float32), "b": P((d,), "zeros", torch.float32)}


def layernorm(p, x, *, eps: float = 1e-5):
    """LayerNorm with bias over the last axis, population variance, in f32."""
    xf = x.float()
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * p["w"] + p["b"]).to(x.dtype)


def norm_def(kind: str, d: int, *, plus_one: bool = False):
    return layernorm_def(d) if kind == "ln" else rmsnorm_def(d, plus_one=plus_one)


def apply_norm(kind: str, p, x, *, plus_one: bool = False):
    return layernorm(p, x) if kind == "ln" else rmsnorm(p, x, plus_one=plus_one)


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, *, theta: float, sections=None):
    """Split-half rotary embedding; x: [B, S, H, d], positions: [B, S] int.

    M-RoPE (Qwen2-VL): ``sections = (t, h, w)`` splits the d/2 frequency
    bands into groups, and group i reads its own position stream
    ``positions[i]`` of ``positions`` [3, B, S] (temporal for text, the
    patch grid's rows and columns for image patches)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    if sections is None:
        ang = positions.float()[:, :, None] * freqs[None, None, :]
    else:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs positions [3, B, S], got {tuple(positions.shape)}")
        bands = torch.split(freqs, list(sections))
        ang = torch.cat([positions[i].float()[:, :, None] * f[None, None, :]
                         for i, f in enumerate(bands)], dim=-1)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def mlp_def(d: int, d_ff: int, act: str = "swiglu", bias: bool = False):
    defs = {"wi": P((d, 2 * d_ff if act in ("swiglu", "geglu") else d_ff)),
            "wo": P((d_ff, d))}
    if bias:
        defs["bi"] = P((defs["wi"].shape[-1],), "zeros", torch.float32)
        defs["bo"] = P((d,), "zeros", torch.float32)
    return defs


def silu(x):
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each op
    rounded to x's dtype: how XLA evaluates a bf16 ``jax.nn.silu``.  A
    sigmoid rounded once differs from it in about a third of bf16 elements,
    enough to move the smoke model's logits past the reference tolerance."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x):
    """``log(1 + exp(x))`` as JAX writes it, ``logaddexp(x, 0)`` (``max(x,
    0) + log1p(exp(-|x|))``).  PyTorch's ``F.softplus`` returns x itself
    above its threshold of 20, which differs."""
    return torch.logaddexp(x, const(0.0, x))


def const(value: float, x) -> torch.Tensor:
    """``value`` rounded to x's dtype, as a 0-d tensor on x's device.  It is
    filled on the device, not copied from the host, so it neither waits on
    the card nor breaks a CUDA graph capture."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def gelu(x):
    """The tanh form of GELU as XLA evaluates a bf16 ``jax.nn.gelu``: the
    constants rounded to x's dtype, ``x ** 3`` as two products, every op
    rounded to x's dtype.  On every normal bf16 input it equals JAX bit for
    bit (XLA flushes subnormals to zero; PyTorch keeps them)."""
    c, k = const(0.044715, x), const((2.0 / math.pi) ** 0.5, x)
    return x * ((torch.tanh((x + x * x * x * c) * k) + 1.0) * 0.5)


def mlp(p, x, act: str = "swiglu"):
    """``wi``, the activation, ``wo``; biases ``bi``/``bo`` where the
    definition has them, cast to the activation dtype before the add.
    swiglu / geglu: ``wi`` projects to ``[u | g]`` and the product is
    ``u * silu(g)`` / ``u * gelu(g)``; gelu: ``gelu(x @ wi)``."""
    h = torch.matmul(x, p["wi"])
    if "bi" in p:
        h = h + p["bi"].to(h.dtype)
    if act == "swiglu":
        u, g = h.chunk(2, dim=-1)
        h = u * silu(g)
    elif act == "geglu":
        u, g = h.chunk(2, dim=-1)
        h = u * gelu(g)
    elif act == "gelu":
        h = gelu(h)
    else:
        raise ValueError(f"unknown activation {act!r}")
    out = torch.matmul(h, p["wo"])
    if "bo" in p:
        out = out + p["bo"].to(out.dtype)
    return out


def embed_def(vocab: int, d: int):
    return {"table": P((vocab, d), "embed")}


def embed(p, tokens):
    return p["table"][tokens]


def unembed_def(d: int, vocab: int):
    return {"w": P((d, vocab))}


def unembed(p, x, true_vocab: int | None = None):
    logits = torch.matmul(x, p["w"]).float()
    return mask_padded_vocab(logits, true_vocab)


def tied_unembed(p, x, true_vocab: int | None = None):
    """Logits through the embedding table (tied embeddings)."""
    logits = torch.matmul(x, p["table"].t()).float()
    return mask_padded_vocab(logits, true_vocab)


def mask_padded_vocab(logits, true_vocab: int | None):
    """Mask logits of vocab-padding ids (see ArchConfig.padded_vocab)."""
    v = logits.shape[-1]
    if true_vocab is None or true_vocab == v:
        return logits
    ids = torch.arange(v, device=logits.device)
    return torch.where(ids < true_vocab, logits, -1e30)
