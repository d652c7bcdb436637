"""Model-level attention block: projections (with optional biases and q/k
RMSNorm) + RoPE + the BitDecoding cache.

Prefill runs blockwise flash attention and builds the quantized cache from
its K/V; decode appends to the cache and runs the fused low-bit kernel
through the query transformation (core/attention.py).  The encoder-decoder's
cross attention reads a *static* quantized cache of the encoder's K/V, built
once after encoding (:func:`build_cross_cache`).
"""
from __future__ import annotations

import torch

from repro_torch.core import attention as catt
from repro_torch.core import qcache
from repro_torch.models import layers
from repro_torch.models.params import P

# The training forward's attention.  The JAX package trains through
# ``blockwise_attention``'s default impl="xla" (repro/models/attention.py:60),
# plain XLA code outside any Pallas kernel (its flash kernel is forward
# only), so here it is the plain online-softmax loop, which autograd
# differentiates: the counterpart of that XLA code, as ``torch.matmul`` is of
# the projections' einsums, and not a fallback.  K6 writes its output through
# ctypes, with no autograd graph (``core.attention.blockwise_attention``
# refuses it under autograd).
TRAIN_IMPL = "torch"


def attn_def(cfg) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": P((d, hq, hd), fan_in=d),
        "wk": P((d, hkv, hd), fan_in=d),
        "wv": P((d, hkv, hd), fan_in=d),
        "wo": P((hq, hd, d), fan_in=hq * hd),
    }
    if cfg.attn_bias:
        defs["bq"] = P((hq, hd), "zeros", torch.float32)
        defs["bk"] = P((hkv, hd), "zeros", torch.float32)
        defs["bv"] = P((hkv, hd), "zeros", torch.float32)
    if cfg.qk_norm:
        defs["qnorm"] = layers.rmsnorm_def(hd)
        defs["knorm"] = layers.rmsnorm_def(hd)
    return defs


def _proj(x, w):
    """x [B, S, d] @ w [d, H, k] -> [B, S, H, k]."""
    return torch.matmul(x, w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *w.shape[1:])


def _out(o, w):
    """o [B, S, H, k] @ w [H, k, d] -> [B, S, d]."""
    return torch.matmul(o.reshape(*o.shape[:2], -1), w.reshape(-1, w.shape[-1]))


def _qkv(p, cfg, x, positions):
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if cfg.attn_bias:  # biases cast to the activation dtype before the add
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if cfg.qk_norm:  # over the head dim, before RoPE: the cache holds normed K
        q = layers.rmsnorm(p["qnorm"], q)
        k = layers.rmsnorm(p["knorm"], k)
    q = layers.apply_rope(q, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    k = layers.apply_rope(k, positions, theta=cfg.rope_theta, sections=cfg.mrope_sections)
    return q, k, v


def attn_train(p, cfg, x, positions, *, causal=True, impl="auto"):
    """x [B, S, d] -> [B, S, d]: attention over x itself with no cache
    (the encoder's self attention is full, ``causal=False``).  ``impl``
    picks the prefill attention, as in :func:`attn_prefill_cache`."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = catt.blockwise_attention(q, k, v, causal=causal, block_k=cfg.attn_block_k,
                                   impl=impl)
    return _out(out.to(x.dtype), p["wo"])


def attn_prefill_cache(p, cfg, x, positions, max_seq: int, *, impl="auto",
                       quant_impl="auto", lengths=None, prior=None, prior_len=None):
    """Causal attention over the prompt, and a cache built from its K/V.

    ``impl`` picks the prefill attention (``core.attention.blockwise_attention``:
    the flash-prefill kernel on the card), ``quant_impl`` the quantize kernel.

    ``lengths`` ([B] int32, optional) marks a ragged right-padded batch:
    per-sequence cache occupancy follows the true lengths.

    ``prior`` (optional ``(k_prior, v_prior)``, each ``[B, T, H, d]``) marks
    a *suffix* prefill (prefix sharing): ``x`` holds only the divergent
    suffix, whose attention also covers the first ``prior_len[b]`` prior
    tokens (dequantized shared pages, K already rotated;
    ``qcache.dequant_prior``).  The cache holds suffix content only, and
    ``positions`` must be the suffix's global ones (``prior_len + arange``)."""
    q, k, v = _qkv(p, cfg, x, positions)
    if prior is not None:
        out = catt.prefix_suffix_attention(q, k, v, *prior, prior_len)
    else:
        out = catt.blockwise_attention(q, k, v, block_k=cfg.attn_block_k, impl=impl)
    cache = qcache.init_cache(
        x.shape[0], cfg.n_kv_heads, cfg.head_dim, max_seq, bits=cfg.kv_bits,
        block_n=cfg.kv_block, k_gran=cfg.kv_gran, device=x.device,
    )
    cache = qcache.prefill(cache, k.transpose(1, 2), v.transpose(1, 2),
                           lengths=lengths, quant_impl=quant_impl)
    return _out(out.to(x.dtype), p["wo"]), cache


def attn_decode(p, cfg, x, positions, cache, *, impl="auto", quant_impl="auto",
                num_splits="auto", mask=None, draft_bits=None):
    """x: [B, 1, d]; appends to the cache (in place), then runs the fused
    low-bit decode kernel.  ``impl`` picks the attention kernel,
    ``quant_impl`` the flush, ``num_splits`` the split-KV count; ``mask``
    and ``draft_bits`` are the speculative modes of
    ``core.attention.decode_append_attention``.  A static cache is read
    with :func:`cross_attn_decode`, which appends nothing."""
    q, k, v = _qkv(p, cfg, x, positions)
    out, cache = catt.decode_append_attention(
        q, cache, k.transpose(1, 2), v.transpose(1, 2), quant_impl=quant_impl,
        mask=mask, draft_bits=draft_bits, impl=impl, num_splits=num_splits,
    )
    return _out(out.to(x.dtype), p["wo"]), cache


def cross_attn_def(cfg) -> dict:
    """The cross block's parameters: those of :func:`attn_def`.  Its biases
    (with ``attn_bias``) are in the tree, as in JAX, but cross attention
    reads none of them."""
    return attn_def(cfg)


def mem_kv(p, mem):
    """The encoder memory's K and V, [B, T, H, d]: projections alone, no
    bias and no RoPE."""
    return _proj(mem, p["wk"]), _proj(mem, p["wv"])


def cross_attn_train(p, cfg, x, mem, *, kv=None, impl="auto"):
    """Cross attention of x [B, S, d] over the encoder memory mem [B, T, d],
    full-precision and full (no mask): S != T in general, which the
    flash-prefill kernel's full mode takes on the card.  ``kv``: the
    memory's :func:`mem_kv`, if the caller has it already."""
    k, v = mem_kv(p, mem) if kv is None else kv
    out = catt.blockwise_attention(_proj(x, p["wq"]), k, v, causal=False,
                                   block_k=cfg.attn_block_k, impl=impl)
    return _out(out.to(x.dtype), p["wo"])


def build_cross_cache(p, cfg, mem, *, kv=None, quant_impl="auto"):
    """The static quantized cache of the encoder memory's K/V, built once
    (the paper's offline case, Fig. 1a): ``mem.shape[1]`` tokens, full
    blocks packed, the tail in the bf16 residual, which no decode step
    appends to or flushes.  ``kv`` as for :func:`cross_attn_train`."""
    k, v = mem_kv(p, mem) if kv is None else kv
    cache = qcache.init_cache(
        mem.shape[0], cfg.n_kv_heads, cfg.head_dim, mem.shape[1], bits=cfg.kv_bits,
        block_n=cfg.kv_block, k_gran=cfg.kv_gran, device=mem.device,
    )
    return qcache.prefill(cache, k.transpose(1, 2), v.transpose(1, 2), quant_impl=quant_impl)


def cross_attn_decode(p, cfg, x, cross_cache, *, impl="auto", num_splits="auto"):
    """x [B, 1, d] -> [B, 1, d]: the decode read of the static cross cache
    (the fused low-bit kernel, no append); the query has no bias and no
    RoPE."""
    out = catt.decode_attention(_proj(x, p["wq"]), cross_cache, impl=impl,
                                num_splits=num_splits)
    return _out(out.to(x.dtype), p["wo"])
