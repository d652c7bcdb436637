"""Decoder-only LM with the BitDecoding cache: the dense attention family
(LLaMA-2/3, Gemma, StarCoder2, Command-R), the MoE family (Qwen3-MoE) and
MLA (DeepSeek-V3: ``models/mla.py``, a latent ``shared_kv`` cache): RMSNorm,
``(1 + w)`` RMSNorm or LayerNorm with bias; SwiGLU, GeGLU or GELU MLPs, with
or without biases, or top-k MoE FFNs (``models/moe.py``); optional q/k
RMSNorm; sequential or parallel residual; untied, tied or scaled embeddings.

The layers form stacks of one block kind each, as in the JAX package:
``[("mlp", n)]`` for a dense model, ``[("mlp", first_dense_layers), ("moe",
rest)]`` for an MoE model (the first stack only when it has layers),
``[("none", n)]`` without a FFN.  Per-layer parameters carry a leading
``layers`` axis (``stack_i``), and the layers run in a Python loop over
views of them.  The decode state is

    {"caches": [QuantKVCache stacked over a stack's layers, per stack],
     "pos": int32 [B]}

and :meth:`DecoderLM.decode_step` updates its caches in place.  The serving
engine's state (:meth:`DecoderLM.init_paged_decode_state`) has the same shape
with a ``PagedQuantKVCache`` per stack; ``decode_step`` serves both.
"""
from __future__ import annotations

import torch

from repro_torch.core import qcache
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as mattn
from repro_torch.models import layers, mla, moe
from repro_torch.models.family import PagedSpec
from repro_torch.models.params import P, init_tree, stack

_LATER = "ROADMAP queue A, item 10 (the other model families)"


def _check_supported(cfg) -> None:
    if cfg.mixer not in ("attn", "mla"):
        raise NotImplementedError(f"mixer={cfg.mixer!r} is not ported yet: {_LATER}")
    if cfg.vision_stub:
        raise NotImplementedError(f"the vision stub is not ported yet: {_LATER}")
    if cfg.mrope_sections:
        raise NotImplementedError(f"M-RoPE is not ported yet: {_LATER}")
    if not cfg.rope:
        raise NotImplementedError(f"attention without RoPE is not ported yet: {_LATER}")


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class DecoderLM:
    """Dense, MoE or MLA decoder-only LM (attention or MLA mixer; MLP or MoE
    FFN, per ``cfg``)."""

    def __init__(self, cfg):
        _check_supported(cfg)
        self.cfg = cfg
        self.mla = cfg.mixer == "mla"
        # the mixer's prefill and decode: the same arguments for both kinds
        self._prefill_attn = mla.mla_prefill_cache if self.mla else mattn.attn_prefill_cache
        self._decode_attn = mla.mla_decode if self.mla else mattn.attn_decode
        if cfg.n_experts:
            fd = cfg.first_dense_layers
            self.stacks = ([("mlp", fd)] if fd else []) + [("moe", cfg.n_layers - fd)]
        elif cfg.d_ff:
            self.stacks = [("mlp", cfg.n_layers)]
        else:
            self.stacks = [("none", cfg.n_layers)]

    # ------------------------------------------------------------ params

    def _norm_def(self):
        cfg = self.cfg
        return layers.norm_def(cfg.norm, cfg.d_model, plus_one=cfg.rms_plus_one)

    def _norm(self, p, x):
        cfg = self.cfg
        return layers.apply_norm(cfg.norm, p, x, plus_one=cfg.rms_plus_one)

    def _block_def(self, kind):
        cfg = self.cfg
        defs = {"ln1": self._norm_def(),
                "attn": mla.mla_def(cfg) if self.mla else mattn.attn_def(cfg)}
        if kind == "mlp":
            defs["mlp"] = layers.mlp_def(cfg.d_model, cfg.d_ff, cfg.act, cfg.attn_bias)
        elif kind == "moe":
            defs["moe"] = moe.moe_def(cfg)
        if kind != "none" and not cfg.parallel_residual:
            defs["ln2"] = self._norm_def()
        return defs

    def param_defs(self):
        cfg = self.cfg
        defs = {
            "embed": layers.embed_def(cfg.padded_vocab, cfg.d_model),
            "final_norm": self._norm_def(),
        }
        if not cfg.tie_embeddings:
            defs["unembed"] = layers.unembed_def(cfg.d_model, cfg.padded_vocab)
        for i, (kind, n) in enumerate(self.stacks):
            defs[f"stack_{i}"] = stack(self._block_def(kind), n)
        if cfg.mtp:  # the multi-token-prediction head: JAX's loss reads it, no forward path
            defs["mtp"] = {"norm": layers.norm_def(cfg.norm, cfg.d_model),
                           "proj": P((cfg.d_model, cfg.d_model))}
        return defs

    def init(self, gen: torch.Generator, device=None):
        """Random parameters drawn from ``gen``, on ``device`` (the card
        unless given)."""
        return init_tree(self.param_defs(), gen, device)

    def _embed(self, params, tokens):
        x = layers.embed(params["embed"], tokens)
        if self.cfg.embed_scale:  # the scale rounded to x's dtype first, as in JAX
            x = x * layers.const(self.cfg.d_model**0.5, x)
        return x

    def _logits(self, params, x):
        x = self._norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return layers.tied_unembed(params["embed"], x, self.cfg.vocab)
        return layers.unembed(params["unembed"], x, self.cfg.vocab)

    def _ffn(self, p, kind, h):
        if kind == "moe":  # the auxiliary loss dropped, as JAX's forward paths do
            return moe.moe_ffn(p["moe"], self.cfg, h)[0]
        return layers.mlp(p["mlp"], h, self.cfg.act)

    def _block(self, p, kind, x, attend):
        """One block of ``kind`` around ``attend(h) -> (a, cache)``: under
        ``parallel_residual`` ``x + a + f`` with the MLP on the same normed
        input (only an "mlp" block has one there, as in JAX), else ``x + a``
        and then the FFN (MLP or MoE; none for "none") over its own norm."""
        parallel = self.cfg.parallel_residual
        h = self._norm(p["ln1"], x)
        a, cache = attend(h)
        x = x + a
        if kind == "none" or (parallel and kind != "mlp"):
            return x, cache
        return x + self._ffn(p, kind, h if parallel else self._norm(p["ln2"], x)), cache

    # ------------------------------------------------------------ prefill

    def prefill(self, params, batch, max_seq: int, *, lengths=None, impl: str = "auto",
                quant_impl: str = "auto", prior=None, prior_len=None):
        """Process the prompt ``batch["tokens"]`` [B, L], build the quantized
        caches and return ``(last_logits [B, 1, V], state)``.

        ``lengths`` ([B] int32, optional): the batch is ragged, right-padded
        to L.  Cache occupancy follows the true lengths and the logits are
        those of each sequence's last real token.  ``impl`` picks the prefill
        attention (the flash-prefill kernel for 'cuda' and, on the card,
        'auto'), ``quant_impl`` the quantize kernel ('auto' | 'cuda' |
        'torch').  A suffix prefill's attention is plain PyTorch whatever
        ``impl`` says (``core.attention.prefix_suffix_attention``).

        ``prior`` / ``prior_len`` make this a *suffix* prefill (prefix
        sharing, serving engine): ``batch["tokens"]`` holds only the
        divergent suffix of each prompt, ``prior`` is a per-stack list of
        ``(k_prior, v_prior)`` (``[layers, B, T, H, d]``, dequantized shared
        pages; ``qcache.dequant_prior``) whose first ``prior_len[b]`` tokens
        the suffix attends; for MLA the pair is ``(latent, None)`` and each
        layer expands the latent through its own up-projections.  Positions
        start at ``prior_len``, the caches hold suffix content only, and
        ``pos`` counts ``prior_len + lengths``.
        """
        if prior is not None and (lengths is None or prior_len is None):
            raise ValueError("suffix prefill needs lengths and prior_len")
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = self._embed(params, tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        if prior is not None:
            if len(prior) != len(self.stacks):
                raise ValueError(f"prior holds {len(prior)} stacks, the model {len(self.stacks)}")
            prior_len = prior_len.to(device=x.device, dtype=torch.int32)
            positions = prior_len[:, None] + positions
        caches = []
        for i, (kind, n) in enumerate(self.stacks):
            layer_caches = []
            for li in range(n):
                p = _layer(params[f"stack_{i}"], li)
                layer_prior = None if prior is None else tuple(
                    None if part is None else part[li] for part in prior[i])
                x, cache = self._block(p, kind, x, lambda h: self._prefill_attn(
                    p["attn"], self.cfg, h, positions, max_seq, impl=impl,
                    quant_impl=quant_impl, lengths=lengths, prior=layer_prior,
                    prior_len=prior_len,
                ))
                layer_caches.append(cache)
            caches.append(qcache.stack_caches(layer_caches))
        if lengths is None:
            x_last = x[:, -1:]
            pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        else:
            lengths = lengths.to(device=x.device, dtype=torch.int32)
            last = torch.clamp(lengths.long() - 1, 0, s - 1)
            x_last = x[torch.arange(b, device=x.device), last][:, None]
            pos = lengths.clone() if prior_len is None else lengths + prior_len
        return self._logits(params, x_last), {"caches": caches, "pos": pos}

    # ------------------------------------------------------------ decode

    def init_decode_state(self, batch_size: int, max_seq: int, *, device=None):
        """Empty caches and positions on ``device`` (the card unless given)."""
        cfg = self.cfg
        device = resolve_device(device)

        def one():
            if self.mla:
                return mla.mla_init_cache(cfg, batch_size, max_seq, device=device)
            return qcache.init_cache(
                batch_size, cfg.n_kv_heads, cfg.head_dim, max_seq, bits=cfg.kv_bits,
                block_n=cfg.kv_block, k_gran=cfg.kv_gran, device=device)

        caches = [qcache.stack_caches([one() for _ in range(n)]) for _, n in self.stacks]
        return {"caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def paged_spec(self) -> PagedSpec:
        """Declared cache family (``models/family.py``): split K/V pools, or
        for MLA one shared_kv latent pool of width kv_lora + qk_rope whose
        first kv_lora channels are V; suffix prefill supported (prefix
        sharing)."""
        cfg = self.cfg
        if self.mla:
            return PagedSpec(
                paged=True, block_n=cfg.kv_block, n_kv_heads=1,
                d_k=cfg.kv_lora + cfg.qk_rope, d_v=cfg.kv_lora, shared_kv=True,
                page_layers=sum(n for _, n in self.stacks), supports_prior=True,
            )
        return PagedSpec(
            paged=True, block_n=cfg.kv_block, n_kv_heads=cfg.n_kv_heads,
            d_k=cfg.head_dim, d_v=cfg.head_dim,
            page_layers=sum(n for _, n in self.stacks), supports_prior=True,
        )

    def init_paged_decode_state(self, batch_size: int, *, n_pages: int, nb_max: int,
                                device=None):
        """Paged decode state for the serving engine, on ``device`` (the card
        unless given): per stack, a ``PagedQuantKVCache`` stacked over its
        layers, whose one page table (``[B, nb_max]``, expanded over the
        layers) the engine fills from its host mirror."""
        cfg = self.cfg
        device = resolve_device(device)
        if self.mla:
            caches = [mla.mla_init_paged_cache(cfg, n_pages, batch_size, nb_max, layers=n,
                                               device=device) for _, n in self.stacks]
        else:
            caches = [qcache.init_paged_cache(
                n_pages, batch_size, cfg.n_kv_heads, cfg.head_dim, nb_max,
                bits=cfg.kv_bits, block_n=cfg.kv_block, k_gran=cfg.kv_gran,
                layers=n, device=device,
            ) for _, n in self.stacks]
        return {"caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def decode_step(self, params, state, tokens, *, impl="auto", quant_impl="auto",
                    num_splits="auto", mask=None, draft_bits=None):
        """tokens [B, 1] -> (logits [B, 1, V], state).  The caches of
        ``state`` are updated in place; the returned state holds the same
        caches and ``pos + 1``.  ``num_splits`` is the decode attention's
        split-KV count ('auto' or an integer).

        Self-speculative decoding (``serve/speculative.py``): ``mask`` ([B]
        bool) freezes the caches of the rows that are ``False`` (the verify
        pass; the JAX package's ``masked_append``), ``draft_bits`` makes every
        layer's append residual-only and its read truncated to that width
        (the draft pass; JAX's ``use_draft``).  The returned ``pos + 1`` is
        unmasked: the caller freezes ``pos`` itself."""
        x = self._embed(params, tokens)
        pos = state["pos"]
        positions = pos[:, None]
        for i, (kind, n) in enumerate(self.stacks):
            stacked = state["caches"][i]
            for li in range(n):
                p = _layer(params[f"stack_{i}"], li)
                x, _ = self._block(p, kind, x, lambda h: self._decode_attn(
                    p["attn"], self.cfg, h, positions, stacked.layer(li),
                    impl=impl, quant_impl=quant_impl, num_splits=num_splits,
                    mask=mask, draft_bits=draft_bits,
                ))
        return self._logits(params, x), {"caches": state["caches"], "pos": pos + 1}
