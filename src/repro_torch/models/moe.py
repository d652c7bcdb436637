"""Token-choice top-k Mixture-of-Experts with capacity-based dispatch, one
group per sequence: the JAX package's ``models/moe.py`` in PyTorch.

Each sequence of ``x [B, S, d]`` is a group.  A token's top-k experts come
from an f32 router (softmax or sigmoid scores, optionally renormalised over
the k).  Within its group a slot ``(token, j)`` takes the next free
position of its expert's buffer of ``cap`` rows, counted over the
flattened ``[S * k]`` slots in token order; slots at or past ``cap`` are
dropped.  The expert FFN (SwiGLU) runs as two batched products over all
``E`` experts' buffers, and each token sums its k weighted outputs in top-k
order, one bf16 add at a time, as JAX's bf16 scatter-add does.

Nothing here reads a device value on the host, so a decode step through it
captures as a CUDA graph; and no step accumulates through atomics, so a
replay is bit for bit the eager step.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.params import P


def moe_def(cfg) -> dict:
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_expert
    defs = {
        "router": P((d, e), "normal", torch.float32),
        "wi": P((e, d, 2 * f)),
        "wo": P((e, f, d)),
    }
    if cfg.n_shared_experts:
        defs["shared"] = layers.mlp_def(d, cfg.n_shared_experts * f, cfg.act)
    return defs


def capacity(cfg, group_tokens: int) -> int:
    """Rows of each expert's buffer for a group of ``group_tokens`` tokens:
    1 for a decode step (a token's k experts are distinct), rounded up to a
    multiple of 8 once it reaches 8."""
    c = max(1, int(group_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts))
    return c if c < 8 else -(-c // 8) * 8


def route(p, cfg, x):
    """x [B, S, d] -> (router logits [B, S, E] f32, top-k weights [B, S, k]
    f32, top-k experts [B, S, k] int64), the k in descending score order."""
    logits = torch.matmul(x.float(), p["router"])
    if cfg.router_score == "sigmoid":  # DeepSeek-V3 style
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    top_w, top_e = torch.topk(scores, cfg.top_k, dim=-1)
    if cfg.router_norm_topk:
        top_w = top_w / (top_w.sum(dim=-1, keepdim=True) + 1e-9)
    return logits, top_w, top_e


def slots(top_e, n_experts: int, cap: int):
    """Buffer positions of the flattened slots ``[B, S * k]``: each slot's
    0-based rank among its group's slots of the same expert, in token
    order, and whether it is kept (rank < ``cap``)."""
    flat_e = top_e.flatten(1)
    hit = flat_e[..., None] == torch.arange(n_experts, device=top_e.device)
    pos = hit.cumsum(dim=1).gather(-1, flat_e[..., None])[..., 0] - 1
    return flat_e, pos, pos < cap


def dispatch(x, flat_e, pos, keep, n_experts: int, cap: int):
    """x [B, S, d] -> the experts' buffers ``[E, B * cap, d]`` (expert e's
    rows of group b at ``b * cap``) and each slot's row in them.  A dropped
    slot writes to a spare row past the buffers, which is sliced away: the
    buffers hold exactly JAX's, whose dropped slots add a zero."""
    b, s, d = x.shape
    k = flat_e.shape[1] // s
    groups = torch.arange(b, device=x.device)[:, None]
    row = (flat_e * b + groups) * cap + pos.clamp(max=cap - 1)
    spare = n_experts * b * cap
    buf = x.new_zeros((spare + 1, d))
    src = x[:, :, None].expand(b, s, k, d).reshape(b * s * k, d)
    buf.index_copy_(0, torch.where(keep, row, spare).flatten(), src)
    return buf[:spare].view(n_experts, b * cap, d), row


def experts(p, xe):
    """SwiGLU of every expert over its buffer: [E, N, d] -> [E, N, d]."""
    u, g = torch.bmm(xe, p["wi"]).chunk(2, dim=-1)
    return torch.bmm(u * layers.silu(g), p["wo"])


def combine(ye, row, keep, top_w, shape):
    """Each slot's expert output times its weight (bf16), summed over a
    token's k slots in top-k order, one bf16 add at a time."""
    b, s, d = shape
    vals = ye.reshape(-1, d).index_select(0, row.flatten()).view(b, s, -1, d)
    vals = torch.where(keep.view(b, s, -1, 1), vals, 0)
    terms = vals * top_w.to(vals.dtype)[..., None]
    out = terms[:, :, 0]
    for j in range(1, terms.shape[2]):
        out = out + terms[:, :, j]
    return out


def aux_loss(logits, top_e, n_experts: int):
    """The Switch-style load-balancing term: E times the sum over experts
    of (share of slots routed to it) x (mean router probability)."""
    hit = top_e[..., None] == torch.arange(n_experts, device=top_e.device)
    me = hit.float().mean(dim=(0, 1, 2))
    pe = torch.softmax(logits, dim=-1).mean(dim=(0, 1))
    return n_experts * (me * pe).sum()


def moe_ffn(p, cfg, x):
    """x [B, S, d] -> (out [B, S, d], aux).  The capacity follows the
    call's (padded) length S, as in JAX."""
    b, s, d = x.shape
    e = cfg.n_experts
    cap = capacity(cfg, s)
    logits, top_w, top_e = route(p, cfg, x)
    flat_e, pos, keep = slots(top_e, e, cap)
    xe, row = dispatch(x, flat_e, pos, keep, e, cap)
    out = combine(experts(p, xe), row, keep, top_w, x.shape)
    if cfg.n_shared_experts:
        out = out + layers.mlp(p["shared"], x, cfg.act)
    return out.to(x.dtype), aux_loss(logits, top_e, e)
