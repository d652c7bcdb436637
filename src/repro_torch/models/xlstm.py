"""xLSTM blocks: the port of the JAX package's ``models/xlstm.py``.

The mLSTM (a matrix memory per head) and the sLSTM (scalar memories with a
block-diagonal recurrence) are attention-free: their decode state has a
constant size, so BitDecoding's cache does not apply and no kernel of the
port runs here.  The JAX package computes both recurrences with XLA, outside
any Pallas kernel; here they are plain PyTorch, as its products are.

JAX's ``_chunked_time_scan`` (a ``lax.scan`` over time under
``jax.checkpoint``) becomes a loop over time steps
(:func:`_chunked_time_scan`), each whole chunk of ``xlstm_time_chunk``
steps under ``torch.utils.checkpoint`` when autograd records the step; the
checkpoint changes no forward value.  :func:`mlstm_chunkwise` is the exact
chunkwise-parallel form of the mLSTM, taken for prompts of whole
``xlstm_time_chunk`` chunks when ``cfg.xlstm_chunkwise`` is set.

The numerics follow JAX compiled as written: the q/k/v, sLSTM input and
recurrence products are bf16 products rounded to bf16 and then taken to
f32, the gate product is f32, every state is f32, and the stabiliser ``m``
starts at -1e30.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.models import layers
from repro_torch.models.attention import _proj
from repro_torch.models.params import P

M_INIT = -1e30  # the stabiliser's start: below any log-gate


def _log_sigmoid(f_pre):
    """``log sigmoid(f)`` as JAX writes it, ``-softplus(-f)``."""
    return -layers.softplus(-f_pre)


def _chunked_time_scan(cell, state, s: int, chunk: int, *, remat: bool):
    """``cell(state, t) -> (state, y_t)`` for t = 0 .. s - 1; returns (the
    last state, the y_t stacked on axis 1).  With ``remat`` (the caller's
    inputs carry an autograd graph) each whole chunk
    of ``chunk`` steps runs under ``torch.utils.checkpoint``: the backward
    keeps only the states at chunk boundaries and recomputes a chunk's
    steps, instead of keeping S copies of the mLSTM's matrix memory (JAX's
    sqrt remat, repro/models/xlstm.py:22); the steps past the last whole
    chunk run plain, as in JAX."""
    def run(st, lo, hi):
        ys = []
        for t in range(lo, hi):
            st, y = cell(st, t)
            ys.append(y)
        return st, torch.stack(ys, 1)

    if not remat:
        return run(state, 0, s)
    parts = []
    for lo in range(0, s - s % chunk, chunk):
        state, ys = torch.utils.checkpoint.checkpoint(run, state, lo, lo + chunk,
                                                      use_reentrant=False)
        parts.append(ys)
    if s % chunk:
        state, ys = run(state, s - s % chunk, s)
        parts.append(ys)
    return state, torch.cat(parts, 1)


# ------------------------------------------------------------------ mLSTM


def mlstm_def(cfg) -> dict:
    """The mLSTM's parameters: the JAX tree, ``wqkv`` and ``wif`` drawn at
    their true fan-in d (JAX divides by the heads axis; models/params.py)."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "wqkv": P((d, 3, h, dh), fan_in=d),
        "wif": P((d, 2, h), "normal", torch.float32, fan_in=d),
        "bif": P((2, h), "zeros", torch.float32),
        "wo_gate": P((d, d)),
        "norm": layers.rmsnorm_def(d),
        "wo": P((d, d)),
    }


def mlstm_init_state(cfg, batch: int, device) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h
    return {
        "C": torch.zeros((batch, h, dh, dh), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, dh), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), M_INIT, dtype=torch.float32, device=device),
    }


def _mlstm_cell(state, qkv_if):
    """One step of the stabilised mLSTM recurrence: q, k, v [B, H, dh] and
    the gates' pre-activations i, f [B, H], all f32.  Returns (the new
    state, h [B, H, dh])."""
    q, k, v, i_pre, f_pre = qkv_if
    c, n, m = state["C"], state["n"], state["m"]
    logf_m = _log_sigmoid(f_pre) + m
    m_new = torch.maximum(logf_m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf_m - m_new)
    c = f_g[..., None, None] * c + i_g[..., None, None] * (v[..., :, None] * k[..., None, :])
    n = f_g[..., None] * n + i_g[..., None] * k
    hv = torch.matmul(c, q[..., None])[..., 0]  # [B, H, dh]: C q (C is v k^T)
    denom = torch.clamp_min((n * q).sum(-1).abs(), 1.0)
    return {"C": c, "n": n, "m": m_new}, hv / denom[..., None]


def _mlstm_inner(p, cfg, x, state):
    """x [B, S, d] -> (y [B, S, d] in x's dtype, the new state): the
    chunkwise form for a prompt of whole chunks when the config asks for it,
    else the sequential recurrence, one step a token."""
    b, s, d = x.shape
    dh = d // cfg.n_heads
    qkv = _proj(x, p["wqkv"]).float()  # [B, S, 3, H, dh]
    q, k, v = qkv[:, :, 0], qkv[:, :, 1] / layers.const(dh**0.5, qkv), qkv[:, :, 2]
    gates = _proj(x.float(), p["wif"]) + p["bif"]  # [B, S, 2, H]
    i_pre, f_pre = gates[:, :, 0], gates[:, :, 1]
    if cfg.xlstm_chunkwise and s % cfg.xlstm_time_chunk == 0:
        y, state = mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk=cfg.xlstm_time_chunk)
        return y.reshape(b, s, d).to(x.dtype), state
    state, ys = _chunked_time_scan(
        lambda st, t: _mlstm_cell(st, (q[:, t], k[:, t], v[:, t], i_pre[:, t], f_pre[:, t])),
        state, s, cfg.xlstm_time_chunk, remat=qkv.requires_grad)
    return ys.reshape(b, s, d).to(x.dtype), state


def mlstm_block(p, cfg, x, state=None):
    """The mLSTM mixer with its output gate and norm: x [B, S, d] ->
    (out [B, S, d], the new state).  ``state`` None: a fresh one.  The
    state passed in is read, not written."""
    if state is None:
        state = mlstm_init_state(cfg, x.shape[0], x.device)
    y, state = _mlstm_inner(p, cfg, x, state)
    gate = layers.silu(torch.matmul(x, p["wo_gate"]))
    y = layers.rmsnorm(p["norm"], y) * gate
    return torch.matmul(y, p["wo"]), state


def mlstm_chunkwise(q, k, v, i_pre, f_pre, state, *, chunk: int):
    """The chunkwise-parallel mLSTM, exact against the sequential cell: the
    matrix memory C materialises only at chunk boundaries, and within a
    chunk the weights form a masked, separable matrix (with F_t the running
    sum of log f and g_s = i_s - F_s, W_ts = exp(F_t - m_t) exp(g_s)), so
    each chunk is a few products.  q, k, v [B, S, H, dh] (k scaled by
    1 / sqrt(dh)); i_pre, f_pre [B, S, H]; state {"C" [B, H, dh, dh], "n"
    [B, H, dh], "m" [B, H]}; S a multiple of ``chunk``.  Returns (h [B, S,
    H, dh], the state after the last token).  The chunks run in a loop
    (JAX's ``lax.scan``)."""
    s = q.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()[None, :, :, None]
    zero = torch.zeros((), dtype=q.dtype, device=q.device)
    c0, n0, m0 = state["C"], state["n"], state["m"]
    hs = []
    for lo in range(0, s, chunk):
        qb, kb, vb = (t[:, lo:lo + chunk] for t in (q, k, v))  # [B, L, H, dh]
        ib, fb = i_pre[:, lo:lo + chunk], f_pre[:, lo:lo + chunk]  # [B, L, H]
        big_f = torch.cumsum(_log_sigmoid(fb), dim=1)
        g = ib - big_f
        m_t = big_f + torch.maximum(torch.cummax(g, dim=1).values, m0[:, None, :])
        # per-pair log-weights [B, t, s, H], combined in log space so that
        # neither factor of the separable form overflows alone; masked below
        # the diagonal
        scores_log = (big_f[:, :, None, :] - m_t[:, :, None, :]) + g[:, None, :, :]
        w_ts = torch.where(tri, torch.exp(scores_log), zero)
        qk = torch.einsum("blhd,bshd->blsh", qb, kb)
        y_intra = torch.einsum("blsh,bshd->blhd", qk * w_ts, vb)
        decay_in = torch.exp(big_f + m0[:, None, :] - m_t)  # [B, L, H]
        y_inter = decay_in[..., None] * torch.einsum("blhk,bhvk->blhv", qb, c0)
        n_t = decay_in[..., None] * n0[:, None] + torch.einsum("blsh,bshd->blhd", w_ts, kb)
        denom = torch.clamp_min(torch.einsum("blhd,blhd->blh", qb, n_t).abs(), 1.0)
        hs.append((y_intra + y_inter) / denom[..., None])
        # the state after the chunk's last token
        m_l = m_t[:, -1]
        w_l = torch.exp(big_f[:, -1:, :] - m_l[:, None] + g)  # [B, L, H]: a weight per s
        decay = torch.exp(big_f[:, -1] + m0 - m_l)
        c0 = decay[..., None, None] * c0 + torch.einsum("bshv,bshk->bhvk",
                                                        vb * w_l[..., None], kb)
        n0 = decay[..., None] * n0 + torch.einsum("bshk,bsh->bhk", kb, w_l)
        m0 = m_l
    return torch.cat(hs, dim=1), {"C": c0, "n": n0, "m": m0}


# ------------------------------------------------------------------ sLSTM


def slstm_def(cfg) -> dict:
    """The sLSTM's parameters: the JAX tree, ``wx`` drawn at its true fan-in
    d, the recurrence ``r`` (gate, head, out, in) at JAX's 0.02."""
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    return {
        "wx": P((d, 4, h, dh), fan_in=d),
        "r": P((4, h, dh, dh), "normal", torch.bfloat16, scale=0.02),
        "b": P((4, h, dh), "zeros", torch.float32),
        "norm": layers.rmsnorm_def(d),
        "wo": P((d, d)),
    }


def slstm_init_state(cfg, batch: int, device) -> dict:
    h = cfg.n_heads
    dh = cfg.d_model // h

    def z():
        return torch.zeros((batch, h, dh), dtype=torch.float32, device=device)

    return {"c": z(), "n": z(), "h": z(),
            "m": torch.full((batch, h, dh), M_INIT, dtype=torch.float32, device=device)}


def _slstm_cell(p, state, wx_t):
    """One sLSTM step: ``wx_t`` [B, 4, H, dh] f32, the input's contribution
    to the (z, i, f, o) gates.  Returns (the new state, h [B, H, dh]).

    The recurrence ``rec[b, g, h, v] = sum_k h[b, h, k] r[g, h, v, k]`` is
    one batched product over (g, h) of ``r``'s own [v, k] matrices with the
    heads' state vectors, a bf16 product rounded to bf16 as JAX's einsum:
    ``r`` is read in place, never re-laid out."""
    hb = state["h"].to(torch.bfloat16).permute(1, 2, 0)  # [H, dh, B]
    rec = torch.matmul(p["r"], hb).permute(3, 0, 1, 2).float()  # [g, H, v, B] -> [B, g, H, v]
    z_pre, i_pre, f_pre, o_pre = (wx_t + rec + p["b"]).unbind(1)
    z_t = torch.tanh(z_pre)
    o_t = torch.sigmoid(o_pre)
    logf_m = _log_sigmoid(f_pre) + state["m"]
    m_new = torch.maximum(logf_m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(logf_m - m_new)
    c = f_g * state["c"] + i_g * z_t
    n = f_g * state["n"] + i_g
    h_t = o_t * c / torch.clamp_min(n, 1.0)
    return {"c": c, "n": n, "h": h_t, "m": m_new}, h_t


def _slstm_inner(p, cfg, x, state):
    """x [B, S, d] -> (y [B, S, d] in x's dtype, the new state): the
    recurrence one step a token (the sLSTM has no parallel form)."""
    b, s, d = x.shape
    wx = _proj(x, p["wx"]).float()  # [B, S, 4, H, dh]
    state, ys = _chunked_time_scan(lambda st, t: _slstm_cell(p, st, wx[:, t]), state, s,
                                   cfg.xlstm_time_chunk, remat=wx.requires_grad)
    return ys.reshape(b, s, d).to(x.dtype), state


def slstm_block(p, cfg, x, state=None):
    """The sLSTM mixer with its norm: x [B, S, d] -> (out [B, S, d], the new
    state).  ``state`` None: a fresh one.  The state passed in is read, not
    written."""
    if state is None:
        state = slstm_init_state(cfg, x.shape[0], x.device)
    y, state = _slstm_inner(p, cfg, x, state)
    return torch.matmul(layers.rmsnorm(p["norm"], y), p["wo"]), state
