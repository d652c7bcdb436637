"""Plain PyTorch version of the flash-prefill kernel: naive causal (or full)
attention with the kernel's mixed-precision choices, bf16 operands and f32
scores, softmax and accumulation."""
from __future__ import annotations

import torch

MASK_VALUE = -1e37


def flash_prefill_ref(q, k, v, *, sm_scale: float | None = None, causal: bool = True):
    """q [B, Hq, S, d]; k, v [B, Hkv, T, d] -> (out [B, Hq, S, d] bf16,
    lse [B, Hq, S] f32).  Query head h reads KV head h // (Hq / Hkv).
    Causal needs T == S; full attention takes any T."""
    b, hq, s, d = q.shape
    g = hq // k.shape[1]
    if sm_scale is None:
        sm_scale = 1.0 / d**0.5
    kx = k.to(torch.bfloat16).float().repeat_interleave(g, dim=1)
    vx = v.to(torch.bfloat16).float().repeat_interleave(g, dim=1)
    scores = torch.matmul(q.to(torch.bfloat16).float(), kx.transpose(-1, -2)) * sm_scale
    if causal:
        if k.shape[2] != s:
            raise ValueError(f"causal attention needs S == T, got {s} over {k.shape[2]}")
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, MASK_VALUE)
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    l = torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul((p / l).to(torch.bfloat16).float(), vx)
    return out.to(torch.bfloat16), (m + torch.log(l))[..., 0]
