"""Multi-head Latent Attention (DeepSeek-V2/V3) with a quantized latent cache.

The prefill and the training forward use the expanded form; the decode the
*absorbed* form, where the queries are projected into the latent space
(``q_nope @ W_uk``) and attention runs straight against the cached latent
stream ``[c_kv ; k_rope]``.
BitDecoding applies to the latent cache itself (``shared_kv``): one quantized
stream feeds both the scores and the values (V is its first ``kv_lora``
channels), and ``g_q = n_heads`` query rows share its one KV head.

The entry points take the arguments of ``models/attention.py``'s, so the
decoder calls either by the config's ``mixer``.  The products outside the
attention are ``torch.matmul`` / ``torch.einsum`` in bf16, as the JAX package
leaves its ``einsum`` s to XLA; the decode's two absorbed products are module
functions (:func:`absorb_query`, :func:`absorb_output`) that ``mla_decode``
calls by name, so a profile can time them.
"""
from __future__ import annotations

import torch

from repro_torch.core import attention as catt
from repro_torch.core import qcache
from repro_torch.models import layers
from repro_torch.models.attention import _out, _proj
from repro_torch.models.params import P


def mla_def(cfg) -> dict:
    d, h = cfg.d_model, cfg.n_heads
    ql, kvl = cfg.q_lora, cfg.kv_lora
    dn, dr, dv = cfg.qk_nope, cfg.qk_rope, cfg.v_head_dim
    return {
        "q_down": P((d, ql)),
        "q_norm": layers.rmsnorm_def(ql),
        "q_up": P((ql, h, dn + dr), fan_in=ql),
        "kv_down": P((d, kvl + dr)),
        "kv_norm": layers.rmsnorm_def(kvl),
        "k_up": P((kvl, h, dn), fan_in=kvl),
        "v_up": P((kvl, h, dv), fan_in=kvl),
        "wo": P((h, dv, d), fan_in=h * dv),
    }


def _sm_scale(cfg) -> float:
    return 1.0 / (cfg.qk_nope + cfg.qk_rope) ** 0.5


def _latent(p, cfg, x, positions):
    """x [B, S, d] -> (c_kv [B, S, kv_lora], k_rope [B, S, qk_rope]) with RoPE."""
    kvr = torch.matmul(x, p["kv_down"])
    c_kv = layers.rmsnorm(p["kv_norm"], kvr[..., : cfg.kv_lora])
    k_rope = layers.apply_rope(kvr[..., cfg.kv_lora:][:, :, None, :], positions,
                               theta=cfg.rope_theta)[:, :, 0]
    return c_kv, k_rope


def _queries(p, cfg, x, positions):
    c_q = layers.rmsnorm(p["q_norm"], torch.matmul(x, p["q_down"]))
    q = _proj(c_q, p["q_up"])
    q_rope = layers.apply_rope(q[..., cfg.qk_nope:], positions, theta=cfg.rope_theta)
    return q[..., : cfg.qk_nope], q_rope


def _expand(p, cfg, c, r):
    """Latent parts c [B, T, kv_lora] and r [B, T, qk_rope] -> per-head
    (k [B, T, h, qk_nope + qk_rope], v [B, T, h, v_head_dim]) through the
    up-projections, the rope part shared by every head."""
    b, t = c.shape[:2]
    k_nope = _proj(c, p["k_up"])
    k_rope = r[:, :, None, :].expand(b, t, cfg.n_heads, cfg.qk_rope).to(k_nope.dtype)
    return torch.cat([k_nope, k_rope], dim=-1), _proj(c, p["v_up"])


def _expand_latent(p, cfg, lat):
    """Latent ``[B, T, kv_lora + qk_rope]`` -> the expanded per-head (k, v).
    The absorbed decode score ``q_eff . lat`` equals the expanded ``q . k``,
    so attending an expanded *dequantized* latent prior gives the suffix
    prefill the view of shared pages that the paged decode has."""
    return _expand(p, cfg, lat[..., : cfg.kv_lora], lat[..., cfg.kv_lora:])


def _expanded_qkv(p, cfg, x, positions):
    """The expanded form's q [B, S, h, qk_nope + qk_rope], k (the same
    width) and v [B, S, h, v_head_dim] of x [B, S, d], and the latent parts
    (c_kv, k_rope) they came from."""
    c_kv, k_rope = _latent(p, cfg, x, positions)
    q_nope, q_rope = _queries(p, cfg, x, positions)
    k, v = _expand(p, cfg, c_kv, k_rope)
    return torch.cat([q_nope, q_rope], dim=-1), k, v, (c_kv, k_rope)


def mla_train(p, cfg, x, positions, *, impl="auto"):
    """x [B, S, d] -> [B, S, d]: the expanded-form causal attention with no
    cache (the training forward; ``impl`` as for :func:`mla_prefill_cache`).
    JAX pins q, k and v to a batch x head placement here (``constrain``,
    repro/models/mla.py:71-75), which is a no-op off a mesh: the placements
    come with multi-rank training (ROADMAP queue A, item 12.5)."""
    q, k, v, _ = _expanded_qkv(p, cfg, x, positions)
    out = catt.blockwise_attention(q, k, v, sm_scale=_sm_scale(cfg), block_k=cfg.attn_block_k,
                                   impl=impl)
    return _out(out.to(x.dtype), p["wo"])


def mla_init_cache(cfg, batch: int, max_seq: int, *, block_align=None, device=None):
    """The latent cache: one KV 'head' of width kv_lora + qk_rope, shared_kv,
    K's params per channel."""
    return qcache.init_cache(
        batch, 1, cfg.kv_lora + cfg.qk_rope, max_seq, bits=cfg.kv_bits,
        block_n=cfg.kv_block, k_gran="channel", shared_kv=True, block_align=block_align,
        device=device,
    )


def mla_init_paged_cache(cfg, n_pages: int, batch: int, nb_max: int, *,
                         layers: int | None = None, device=None):
    """The paged latent cache (the serving engine's layout): the one
    quantized latent stream in shared pools, no V-side pools at all."""
    return qcache.init_paged_cache(
        n_pages, batch, 1, cfg.kv_lora + cfg.qk_rope, nb_max, bits=cfg.kv_bits,
        block_n=cfg.kv_block, k_gran="channel", shared_kv=True, layers=layers,
        device=device,
    )


def mla_prefill_cache(p, cfg, x, positions, max_seq: int, *, impl="auto",
                      quant_impl="auto", lengths=None, prior=None, prior_len=None):
    """Prefill attention (the expanded form) and the latent cache built from
    the prompt.

    ``impl`` picks the prefill attention (``core.attention.blockwise_attention``:
    the flash-prefill kernel through its padded route on the card).
    ``prior`` (prefix sharing, serving engine) is the dequantized shared
    latent prior ``(lat [B, T, 1, kv_lora + qk_rope], None)`` from
    ``qcache.dequant_prior`` on a shared_kv paged cache: ``x`` holds only
    the divergent suffix, whose expanded Q/K/V attend the expanded prior
    through ``core.attention.prefix_suffix_attention`` (plain PyTorch;
    ``positions`` are suffix-global).  The cache holds suffix latents only.
    """
    q, k, v, (c_kv, k_rope) = _expanded_qkv(p, cfg, x, positions)
    if prior is None:
        out = catt.blockwise_attention(q, k, v, sm_scale=_sm_scale(cfg),
                                       block_k=cfg.attn_block_k, impl=impl)
    else:
        k_prior, v_prior = _expand_latent(p, cfg, prior[0][:, :, 0, :])
        out = catt.prefix_suffix_attention(q, k, v, k_prior, v_prior, prior_len,
                                           sm_scale=_sm_scale(cfg))
    lat = torch.cat([c_kv, k_rope], dim=-1)[:, None]  # [B, 1, S, kv_lora + qk_rope]
    cache = mla_init_cache(cfg, x.shape[0], max_seq, device=x.device)
    cache = qcache.prefill(cache, lat, None, lengths=lengths, quant_impl=quant_impl)
    return _out(out.to(x.dtype), p["wo"]), cache


def absorb_query(q_nope, k_up):
    """The absorbed query: q_nope [B, 1, h, qk_nope] through W_uk into the
    latent space, [B, 1, h, kv_lora] (bf16)."""
    return torch.einsum("bshk,lhk->bshl", q_nope, k_up)


def absorb_output(out_lat, v_up):
    """The latent attention output [B, 1, h, kv_lora] up through W_uv:
    [B, 1, h, v_head_dim] (bf16)."""
    return torch.einsum("bshl,lhk->bshk", out_lat, v_up)


def mla_decode(p, cfg, x, positions, cache, *, impl="auto", quant_impl="auto",
               num_splits="auto", mask=None, draft_bits=None):
    """The absorbed-form decode of x [B, 1, d] against the latent cache,
    which it appends to in place: ``q_eff = [q_nope @ W_uk ; q_rope]`` of
    width kv_lora + qk_rope attends the latent stream (K3 / K4 in their
    shared_kv mode, ``d_v = kv_lora``), and the latent output goes up through
    ``v_up`` and ``wo``.  ``impl``, ``quant_impl``, ``num_splits``, ``mask``
    and ``draft_bits`` as in ``models.attention.attn_decode``."""
    q_nope, q_rope = _queries(p, cfg, x, positions)  # [B, 1, h, *]
    c_kv, k_rope = _latent(p, cfg, x, positions)
    lat = torch.cat([c_kv, k_rope], dim=-1)[:, None]  # [B, H = 1, S = 1, kv_lora + qk_rope]
    q_eff = torch.cat([absorb_query(q_nope, p["k_up"]), q_rope], dim=-1)
    out_lat, cache = catt.decode_append_attention(
        q_eff, cache, lat, None, quant_impl=quant_impl, mask=mask, draft_bits=draft_bits,
        sm_scale=_sm_scale(cfg), d_v=cfg.kv_lora, impl=impl, num_splits=num_splits,
    )  # [B, 1, h, kv_lora]
    return _out(absorb_output(out_lat.to(x.dtype), p["v_up"]), p["wo"]), cache
