"""Attention entry points: query transformation, decode dispatch, blockwise
prefill attention.

Query transformation (paper §V-A): the decode query ``[B, 1, h_q, d]`` is
reshaped to ``[B, h_kv, g_q, d]`` (``g_q = h_q / h_kv``) so the query heads
that share a KV head become the rows of one product; MHA (g_q = 1) and GQA
(g_q > 1) run through the same kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core import qcache
from repro_torch.core.qcache import QuantKVCache
from repro_torch.kernels.bitdecode import ops as bd_ops

MASK_VALUE = -1e37  # finite: with -inf an empty split or block turns into NaN


def query_transform(q: torch.Tensor, h_kv: int) -> torch.Tensor:
    """[B, 1, h_q, d] -> [B, h_kv, g_q, d].  Head h shares KV head h // g_q."""
    b, s1, h_q, d = q.shape
    if s1 != 1:
        raise ValueError(f"decode expects q_len=1, got {s1}")
    if h_q % h_kv:
        raise ValueError(f"h_q={h_q} not divisible by h_kv={h_kv}")
    return q.reshape(b, h_kv, h_q // h_kv, d)


def inverse_query_transform(o: torch.Tensor) -> torch.Tensor:
    """[B, h_kv, g_q, d_v] -> [B, 1, h_q, d_v]."""
    b, h_kv, g_q, d_v = o.shape
    return o.reshape(b, 1, h_kv * g_q, d_v)


def decode_attention(q, cache: QuantKVCache, *, sm_scale: float | None = None,
                     impl: str = "auto", num_splits="auto"):
    """Low-bit fused decode attention of q [B, 1, h_q, d_k] against the cache;
    returns f32 [B, 1, h_q, d_v].  ``num_splits`` is the in-kernel split-KV
    count ('auto' or an integer)."""
    qt = query_transform(q, cache.kw.shape[1])
    out = bd_ops.bitdecode_attention(
        qt, cache.kw, cache.k_scale, cache.k_zero, cache.vw, cache.v_scale,
        cache.v_zero, cache.k_res, cache.v_res, cache.pack_blocks, cache.res_len,
        bits=cache.bits, block_n=cache.block_n, sm_scale=sm_scale,
        k_gran=cache.k_gran, impl=impl, num_splits=num_splits,
    )
    return inverse_query_transform(out)


def decode_append_attention(q, cache: QuantKVCache, k_new, v_new, *,
                            quant_impl: str = "auto", mask=None, **attn_kwargs):
    """The per-token hot path: append the new KV token (residual write +
    flush, in place) and run fused low-bit decode attention over the updated
    cache.  Returns ``(out, cache)``.  ``attn_kwargs`` go to
    :func:`decode_attention`."""
    cache = qcache.append_decode(cache, k_new, v_new, quant_impl=quant_impl, mask=mask)
    return decode_attention(q, cache, **attn_kwargs), cache


def blockwise_attention(q, k, v, *, sm_scale: float | None = None,
                        block_k: int = 512):
    """Causal flash-style attention in plain PyTorch: q [B, S, h_q, d_k],
    k/v [B, S, h_kv, d]; returns f32 [B, S, h_q, d_v].

    Walks KV blocks of ``block_k`` with online-softmax carries and never
    builds the [S, T] score matrix.  Products take bf16 operands with f32
    accumulation (float32 matmuls of bf16-rounded values).
    """
    b, s, h_q, d_k = q.shape
    _, t, h_kv, d_v = v.shape
    g = h_q // h_kv
    if sm_scale is None:
        sm_scale = 1.0 / (d_k**0.5)
    # [B, h_kv, S*g, d]: rows ordered (s, g) so a row's position is row // g
    qg = (q.to(torch.bfloat16).float().reshape(b, s, h_kv, g, d_k)
          .permute(0, 2, 1, 3, 4).reshape(b, h_kv, s * g, d_k))
    kf = k.to(torch.bfloat16).float().permute(0, 2, 1, 3)  # [B, h_kv, T, d_k]
    vf = v.to(torch.bfloat16).float().permute(0, 2, 1, 3)
    rows = (torch.arange(s * g, device=q.device) // g)[:, None]

    m = torch.full((b, h_kv, s * g, 1), MASK_VALUE, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, h_kv, s * g, d_v), dtype=torch.float32, device=q.device)
    for lo in range(0, t, block_k):
        kj, vj = kf[:, :, lo:lo + block_k], vf[:, :, lo:lo + block_k]
        sblk = torch.matmul(qg, kj.transpose(-1, -2)) * sm_scale
        cols = torch.arange(lo, lo + kj.shape[2], device=q.device)[None, :]
        sblk = torch.where(cols <= rows, sblk, MASK_VALUE)
        m_new = torch.maximum(m, sblk.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sblk - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(torch.bfloat16).float(), vj)
        m = m_new
    out = acc / l
    return out.reshape(b, h_kv, s, g, d_v).permute(0, 2, 1, 3, 4).reshape(b, s, h_q, d_v)
