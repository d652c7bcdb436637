"""Mamba2 (SSD) mixer: the port of the JAX package's ``models/mamba2.py``.

A chunked parallel scan for the prompt (:func:`ssd_chunked`) and an O(1)
recurrent update for decode (:func:`mamba2_decode`), with a causal depthwise
conv on the xBC stream and a gated RMSNorm output.  BitDecoding does not
apply to the mixer itself (its decode state has a constant size); it applies
to the hybrid's shared attention block (``transformer.HybridLM``).

The JAX package has no Pallas kernel here: the SSD, the conv and the
recurrent update are XLA einsums, and here they are plain PyTorch products.
The numerics follow JAX compiled as written: the prefill's conv is a chain
of bf16 multiply-adds, the SSD and the recurrent update run in f32, the
gated norm takes ``y * silu(z)`` in bf16.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.params import P

CONV_K = 4


def mamba2_def(cfg) -> dict:
    d, di, h = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_heads
    n, g = cfg.ssm_state, cfg.mamba_groups
    conv_dim = di + 2 * g * n
    return {
        "in_proj": P((d, 2 * di + 2 * g * n + h)),
        "conv_w": P((CONV_K, conv_dim), "normal", torch.float32, scale=0.2),
        "conv_b": P((conv_dim,), "zeros", torch.float32),
        "a_log": P((h,), "zeros", torch.float32),  # A = -exp(a_log)
        "dt_bias": P((h,), "zeros", torch.float32),
        "d_skip": P((h,), "ones", torch.float32),
        "norm": layers.rmsnorm_def(di),
        "out_proj": P((di, d)),
    }


def _split_proj(cfg, zxbcdt):
    """The in-projection's output -> (z, xBC, dt)."""
    di, gn = cfg.mamba_d_inner, cfg.mamba_groups * cfg.ssm_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gn], zxbcdt[..., 2 * di + 2 * gn:]


def _conv_train(p, xbc):
    """Causal depthwise conv along S of xbc [B, S, C], in xbc's dtype: each
    tap's product and each partial sum rounded, as JAX's
    ``sum(pad[:, i:i + S] * w[i])``."""
    w = p["conv_w"].to(xbc.dtype)
    s = xbc.shape[1]
    pad = torch.nn.functional.pad(xbc, (0, 0, CONV_K - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, CONV_K):
        out = out + pad[:, i:i + s] * w[i]
    return layers.silu(out + p["conv_b"].to(xbc.dtype))


def _repeat_groups(t, rep: int, dim: int):
    """Each group of axis ``dim`` repeated ``rep`` times in place (JAX's
    ``jnp.repeat``: head h reads group h // rep), by expand and reshape."""
    shape = list(t.shape)
    t = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return t.reshape(*shape[:dim], shape[dim] * rep, *shape[dim + 1:])


def _segsum(x):
    """Stable segment sum: x [..., T] -> [..., T, T], entry (t, s) the sum
    of x over (s, t] below the diagonal, -inf above it."""
    t = x.shape[-1]
    xc = torch.cumsum(x, dim=-1)
    ss = xc[..., :, None] - xc[..., None, :]
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    return ss.masked_fill(~mask, float("-inf"))


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int):
    """Minimal SSD (the Mamba2 paper's Listing 1).  x [B, S, H, P]; dt [B,
    S, H] (softplus'd); a_log [H]; b, c [B, S, G, N]; all f32, S a multiple
    of ``chunk``.  Returns (y [B, S, H, P], the final state [B, H, P, N]).

    The intra-chunk term is ``(C B^T * L) x`` as one elementwise product and
    one batched matrix product (not a three-operand contraction); the
    inter-chunk recurrence is a loop over chunks (JAX's ``lax.scan``)."""
    bsz, s, h, pdim = x.shape
    g, n = b.shape[2], b.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    nc, rep = s // chunk, h // g

    a = -torch.exp(a_log)
    da = dt * a  # [B, S, H]: log-decay per step
    xdt = x * dt[..., None]

    da_c = da.reshape(bsz, nc, chunk, h)
    x_c = xdt.reshape(bsz, nc, chunk, h, pdim)
    b_ch = _repeat_groups(b.reshape(bsz, nc, chunk, g, n), rep, 3)  # [B, nc, T, H, N]
    c_ch = _repeat_groups(c.reshape(bsz, nc, chunk, g, n), rep, 3)

    # 1. intra-chunk (diagonal blocks): [B, nc, H, T, T] scores, masked decay
    da_h = da_c.permute(0, 1, 3, 2)  # [B, nc, H, T]
    decay = torch.exp(_segsum(da_h))
    ch_, bh_, xh_ = (t.permute(0, 1, 3, 2, 4) for t in (c_ch, b_ch, x_c))  # [B, nc, H, T, .]
    scores = torch.matmul(ch_, bh_.transpose(-1, -2))
    y_diag = torch.matmul(scores * decay, xh_)  # [B, nc, H, T, P]

    # 2. chunk-final states: decay from step t to the chunk's end
    cum = torch.cumsum(da_h, dim=-1)  # [B, nc, H, T]
    decay_tail = torch.exp(cum[..., -1:] - cum)
    # [B, nc, H, P, N]
    states = torch.matmul((xh_ * decay_tail[..., None]).transpose(-1, -2), bh_)

    # 3. inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(da_h.sum(-1))  # [B, nc, H]
    carry = torch.zeros((bsz, h, pdim, n), dtype=torch.float32, device=x.device)
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, dim=1)  # [B, nc, H, P, N]

    # 4. the entering state's contribution at each position
    y_off = torch.matmul(ch_, prev_states.transpose(-1, -2)) * torch.exp(cum)[..., None]
    y = (y_diag + y_off).permute(0, 1, 3, 2, 4).reshape(bsz, s, h, pdim)
    return y, carry


def _mamba2_forward(p, cfg, x):
    di, g, n, h = cfg.mamba_d_inner, cfg.mamba_groups, cfg.ssm_state, cfg.mamba_heads
    bsz, s = x.shape[:2]
    pdim = di // h
    z, xbc_raw, dt = _split_proj(cfg, torch.matmul(x, p["in_proj"]))
    xbc = _conv_train(p, xbc_raw)
    xin = xbc[..., :di].reshape(bsz, s, h, pdim)
    b = xbc[..., di:di + g * n].reshape(bsz, s, g, n)
    c = xbc[..., di + g * n:].reshape(bsz, s, g, n)
    dt = layers.softplus(dt.float() + p["dt_bias"])
    pad = (-s) % cfg.mamba_chunk

    def padded(t):  # the tail chunk padded with zero-dt steps: an identity
        return torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) if pad else t

    y, final = ssd_chunked(padded(xin.float()), padded(dt), p["a_log"], padded(b.float()),
                           padded(c.float()), chunk=cfg.mamba_chunk)
    y = y[:, :s] + xin.float() * p["d_skip"][:, None]
    y = y.reshape(bsz, s, di).to(x.dtype)
    y = layers.rmsnorm(p["norm"], y * layers.silu(z))
    return torch.matmul(y, p["out_proj"]), final, xbc_raw


def mamba2_train(p, cfg, x):
    """The training forward of x [B, S, d]: out [B, S, d], no state kept."""
    return _mamba2_forward(p, cfg, x)[0]


def mamba2_prefill(p, cfg, x):
    """The chunked-parallel prefill of x [B, S, d]: returns (out [B, S, d],
    the decode state), the state the SSD's final state and the last
    CONV_K - 1 raw xBC rows in bf16, left-padded with zeros when the prompt
    is shorter than the conv window."""
    out, final, xbc_raw = _mamba2_forward(p, cfg, x)
    conv = xbc_raw[:, -(CONV_K - 1):].to(torch.bfloat16)
    short = CONV_K - 1 - xbc_raw.shape[1]
    if short > 0:
        conv = torch.nn.functional.pad(conv, (0, 0, short, 0))
    return out, {"ssm": final, "conv": conv}


def mamba2_init_state(cfg, batch: int, device) -> dict:
    di, g, n, h = cfg.mamba_d_inner, cfg.mamba_groups, cfg.ssm_state, cfg.mamba_heads
    return {
        "ssm": torch.zeros((batch, h, di // h, n), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_K - 1, di + 2 * g * n), dtype=torch.bfloat16,
                            device=device),
    }


def mamba2_decode(p, cfg, x, state):
    """One token x [B, 1, d] through the O(1) recurrent update of ``state``
    (``{"ssm", "conv"}``); returns (out [B, 1, d], the new state).  The
    state is read, not written: the caller copies the new one in place."""
    di, g, n, h = cfg.mamba_d_inner, cfg.mamba_groups, cfg.ssm_state, cfg.mamba_heads
    pdim = di // h
    z, xbc, dt = _split_proj(cfg, torch.matmul(x, p["in_proj"]))
    hist = torch.cat([state["conv"], xbc.to(torch.bfloat16)], dim=1)  # the rolling window
    conv = (hist.float() * p["conv_w"]).sum(1) + p["conv_b"]
    xbc_t = layers.silu(conv)
    xin = xbc_t[:, :di].reshape(-1, h, pdim)
    rep = h // g
    bh = _repeat_groups(xbc_t[:, di:di + g * n].reshape(-1, g, n), rep, 1)  # [B, H, N]
    ch = _repeat_groups(xbc_t[:, di + g * n:].reshape(-1, g, n), rep, 1)
    dtv = layers.softplus(dt[:, 0].float() + p["dt_bias"])  # [B, H]
    decay = torch.exp(dtv * -torch.exp(p["a_log"]))
    ssm = (state["ssm"] * decay[:, :, None, None]
           + xin[..., None] * bh[:, :, None, :] * dtv[:, :, None, None])
    y = torch.matmul(ssm, ch[..., None])[..., 0] + xin * p["d_skip"][:, None]
    y = y.reshape(-1, 1, di).to(x.dtype)
    y = layers.rmsnorm(p["norm"], y * layers.silu(z))
    return torch.matmul(y, p["out_proj"]), {"ssm": ssm, "conv": hist[:, 1:]}
