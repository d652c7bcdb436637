"""Decoder-only LMs with the BitDecoding cache.

:class:`DecoderLM`: the dense attention family (LLaMA-2/3, Gemma, StarCoder2,
Command-R), the MoE family (Qwen3-MoE) and MLA (DeepSeek-V3:
``models/mla.py``, a latent ``shared_kv`` cache): RMSNorm,
``(1 + w)`` RMSNorm or LayerNorm with bias; SwiGLU, GeGLU or GELU MLPs, with
or without biases, or top-k MoE FFNs (``models/moe.py``); optional q/k
RMSNorm; sequential or parallel residual; untied, tied or scaled embeddings;
and the VLM stub (Qwen2-VL): precomputed patch embeddings ahead of the text,
with M-RoPE positions (``layers.apply_rope(sections=...)``).

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

:class:`HybridLM`: the Zamba2 hybrid, a Mamba2 backbone (``models/mamba2.py``)
with one shared attention + MLP block, each invocation with its own
quantized cache, and the Mamba2 states as constant-size side state.

:class:`XLSTMLM`: the recurrent xLSTM family, super-blocks of mLSTM blocks
and one sLSTM block (``models/xlstm.py``), with no KV cache: its whole
decode state is constant-size side state, served by the engine's
exact-length shim (``paged=False``).
"""
from __future__ import annotations

import torch

from repro_torch.core import qcache
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as mattn
from repro_torch.models import layers, mamba2, mla, moe, xlstm
from repro_torch.models.family import PagedSpec
from repro_torch.models.params import P, init_tree, stack

_LATER = "ROADMAP queue A, item 10 (the other model families)"


def _ce_loss(logits, labels, mask):
    """The masked mean token cross entropy of logits [..., V] (log-softmax
    in f32) at ``labels``, over the positions where ``mask`` is nonzero."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, labels[..., None].long())[..., 0]
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _next_token_loss(logits, batch, shift: int = 1):
    """:func:`_ce_loss` of position t's logits against the label at t +
    ``shift``."""
    return _ce_loss(logits[:, :-shift], batch["labels"][:, shift:],
                    batch["loss_mask"][:, shift:])


def _check_supported(cfg, mixers=("attn", "mla")) -> None:
    """Refuse what the port does not run: another mixer and attention
    without RoPE."""
    if cfg.mixer not in mixers:
        raise NotImplementedError(f"mixer={cfg.mixer!r} is not ported yet: {_LATER}")
    if not cfg.rope:
        raise NotImplementedError(f"attention without RoPE is not ported yet: {_LATER}")


def _layer(tree, i: int):
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _mrope_positions(cfg, b: int, s_total: int, device) -> torch.Tensor:
    """M-RoPE position ids [3, B, S] of the stub front: the patches on a
    (t = 0, h, w) grid, the text continuing on all three streams at
    ``max(patch_grid)``."""
    gh, gw = cfg.patch_grid
    idx = torch.arange(cfg.n_patches, device=device)
    text = torch.arange(s_total - cfg.n_patches, device=device) + max(gh, gw)
    pos = torch.stack([torch.cat([torch.zeros_like(idx), text]),
                       torch.cat([idx // gw, text]), torch.cat([idx % gw, text])])
    return pos[:, None, :].expand(3, b, s_total)


def _mrope_decode_positions(cfg, pos) -> torch.Tensor:
    """pos [B] (absolute, patch slots included) -> [3, B, 1]: the text
    stream of :func:`_mrope_positions` continued."""
    t = pos - cfg.n_patches + max(cfg.patch_grid)
    return t[None, :, None].expand(3, pos.shape[0], 1)


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
        if cfg.mtp:  # the multi-token-prediction head: only the loss reads it
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

    def _front(self, params, batch):
        """The prefill's input [B, S, d] and positions ([B, S], or [3, B, S]
        with M-RoPE): the embedded tokens, behind ``batch["patches"]``
        [B, n_patches, d] with the vision stub."""
        cfg = self.cfg
        x = self._embed(params, batch["tokens"])
        if cfg.vision_stub:
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        b, s = x.shape[:2]
        if cfg.mrope_sections:
            return x, _mrope_positions(cfg, b, s, x.device)
        return x, torch.arange(s, device=x.device)[None].expand(b, s)

    def _logits(self, params, x):
        x = self._norm(params["final_norm"], x)
        if self.cfg.tie_embeddings:
            return layers.tied_unembed(params["embed"], x, self.cfg.vocab)
        return layers.unembed(params["unembed"], x, self.cfg.vocab)

    # ------------------------------------------------------------ train

    def _mixer_train(self, p, h, positions):
        fn = mla.mla_train if self.mla else mattn.attn_train
        return fn(p, self.cfg, h, positions, impl=mattn.TRAIN_IMPL)

    def _block_train(self, p, kind, x, positions):
        """One block of the training forward: (x, its MoE auxiliary loss,
        f32 0 for a block without one)."""
        cfg = self.cfg
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        h = self._norm(p["ln1"], x)
        x = x + self._mixer_train(p["attn"], h, positions)
        if kind == "none" or (cfg.parallel_residual and kind != "mlp"):
            return x, aux
        h2 = h if cfg.parallel_residual else self._norm(p["ln2"], x)
        if kind == "moe":
            f, aux = moe.moe_ffn(p["moe"], cfg, h2)
        else:
            f = layers.mlp(p["mlp"], h2, cfg.act)
        return x + f, aux

    def loss(self, params, batch):
        """The training loss of ``batch`` (``tokens``, ``labels``,
        ``loss_mask`` [B, S]; ``patches`` ahead of them with the vision
        stub): the next-token cross entropy over the text, plus 0.3 times
        the MTP head's t + 2 cross entropy (``cfg.mtp``), plus the MoE
        layers' summed auxiliary loss weighted by ``aux_loss_weight /
        n_layers``.  Each block runs under ``layers.remat`` (JAX's
        ``jax.checkpoint`` of the scan body)."""
        cfg = self.cfg
        x, positions = self._front(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, (kind, n) in enumerate(self.stacks):
            for li in range(n):
                x, a = layers.remat(cfg, self._block_train, _layer(params[f"stack_{i}"], li),
                                    kind, x, positions)
                aux = aux + a
        lead = cfg.n_patches if cfg.vision_stub else 0  # the logits over the text alone
        loss = _next_token_loss(self._logits(params, x)[:, lead:], batch)
        if cfg.mtp:  # the simplified multi-token-prediction head: t + 2
            h = layers.apply_norm(cfg.norm, params["mtp"]["norm"], x)
            h = torch.matmul(h, params["mtp"]["proj"])
            loss = loss + 0.3 * _next_token_loss(self._logits(params, h)[:, lead:], batch, 2)
        if cfg.n_experts:
            loss = loss + cfg.aux_loss_weight * aux / cfg.n_layers
        return loss

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
        caches and return ``(last_logits [B, 1, V], state)``.  With the
        vision stub, ``batch["patches"]`` [B, n_patches, d] go ahead of the
        tokens: the caches and ``pos`` count them, and ``lengths`` counts
        text tokens alone.

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
        ``pos`` counts ``prior_len + lengths``.  It needs a token-only front
        (no vision stub, no M-RoPE).
        """
        cfg = self.cfg
        if prior is not None and (cfg.vision_stub or cfg.mrope_sections):
            raise ValueError("suffix prefill (prior=) requires a token-only front "
                             "(no vision/M-RoPE)")
        if prior is not None and (lengths is None or prior_len is None):
            raise ValueError("suffix prefill needs lengths and prior_len")
        x, positions = self._front(params, batch)
        b, s = x.shape[:2]
        n_lead = cfg.n_patches if cfg.vision_stub else 0  # the patches ahead of the text
        if lengths is not None:
            lengths = lengths.to(device=x.device, dtype=torch.int32) + n_lead
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
            last = torch.clamp(lengths.long() - 1, 0, s - 1)
            x_last = x[torch.arange(b, device=x.device), last][:, None]
            pos = lengths.clone() if prior_len is None else lengths + prior_len
        return self._logits(params, x_last), {"caches": caches, "pos": pos}

    # ------------------------------------------------------------ decode

    def init_decode_state(self, batch_size: int, max_seq: int, *, mesh=None,
                          splitkv_axis: str = "data", device=None):
        """Empty caches and positions on ``device`` (the card unless given).
        With a ``mesh``, the packed-block capacity is rounded up to the
        ``splitkv_axis`` size, so every rank's window of a split-KV walk
        (``dist.splitkv``) is equally wide (mesh-aligned allocation)."""
        cfg = self.cfg
        device = resolve_device(device)
        align = qcache.splitkv_block_align(mesh, splitkv_axis)

        def one():
            if self.mla:
                return mla.mla_init_cache(cfg, batch_size, max_seq, block_align=align,
                                          device=device)
            return qcache.init_cache(
                batch_size, cfg.n_kv_heads, cfg.head_dim, max_seq, bits=cfg.kv_bits,
                block_n=cfg.kv_block, k_gran=cfg.kv_gran, block_align=align, device=device)

        caches = [qcache.stack_caches([one() for _ in range(n)]) for _, n in self.stacks]
        return {"caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def paged_spec(self) -> PagedSpec | None:
        """Declared cache family (``models/family.py``): split K/V pools, or
        for MLA one shared_kv latent pool of width kv_lora + qk_rope whose
        first kv_lora channels are V; suffix prefill supported (prefix
        sharing).  None for a token-plus-patch front (the vision stub,
        M-RoPE): the serving engine cannot feed its prefill."""
        cfg = self.cfg
        if cfg.vision_stub or cfg.mrope_sections:
            return None
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
        if self.cfg.mrope_sections:
            positions = _mrope_decode_positions(self.cfg, pos)
        else:
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


class HybridLM:
    """Zamba2-style hybrid: ``n_super`` super-blocks of ``attn_every`` Mamba2
    layers and one invocation of the SHARED attention + MLP block (one set
    of weights, a quantized cache per invocation), then a tail of the
    leftover Mamba2 layers.  The parameter tree is JAX's: ``main`` stacked
    ``[n_super, attn_every, ...]``, ``tail`` ``[tail, ...]``,
    ``shared_attn``, ``embed``, ``final_norm``, ``unembed``.  The decode
    state is

        {"ssm_main": {"ssm": f32 [n_super, attn_every, B, H, P, N],
                      "conv": bf16 [n_super, attn_every, B, CONV_K - 1, C]},
         "ssm_tail": {... [tail, B, ...]},  (only with a tail)
         "caches": [a cache stacked over the n_super invocations],
         "pos": int32 [B]}

    and :meth:`decode_step` updates all of it in place.  Prompts prefill at
    their exact length (no ``lengths``): the recurrent states would absorb
    right-padding."""

    def __init__(self, cfg):
        _check_supported(cfg, mixers=("mamba2",))
        if cfg.vision_stub or cfg.mrope_sections:  # the JAX hybrid would ignore them
            raise NotImplementedError(f"{cfg.name}: the hybrid has no vision stub or M-RoPE "
                                      f"(nor has the JAX package's): {_LATER}")
        if cfg.attn_every < 1:
            raise ValueError(f"the hybrid needs attn_every >= 1, got {cfg.attn_every}")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_every
        self.tail = cfg.n_layers - self.n_super * cfg.attn_every

    # ------------------------------------------------------------ params

    def _mamba_def(self):
        cfg = self.cfg
        return {"ln": layers.norm_def(cfg.norm, cfg.d_model), "mixer": mamba2.mamba2_def(cfg)}

    def _shared_def(self):
        cfg = self.cfg
        return {"ln1": layers.norm_def(cfg.norm, cfg.d_model), "attn": mattn.attn_def(cfg),
                "ln2": layers.norm_def(cfg.norm, cfg.d_model),
                "mlp": layers.mlp_def(cfg.d_model, cfg.d_ff, cfg.act)}

    def param_defs(self):
        cfg = self.cfg
        defs = {
            "embed": layers.embed_def(cfg.padded_vocab, cfg.d_model),
            "final_norm": layers.norm_def(cfg.norm, cfg.d_model),
            "unembed": layers.unembed_def(cfg.d_model, cfg.padded_vocab),
            "shared_attn": self._shared_def(),
            "main": stack(stack(self._mamba_def(), cfg.attn_every), self.n_super),
        }
        if self.tail:
            defs["tail"] = stack(self._mamba_def(), self.tail)
        return defs

    def init(self, gen: torch.Generator, device=None):
        """Random parameters drawn from ``gen``, on ``device`` (the card
        unless given)."""
        return init_tree(self.param_defs(), gen, device)

    def _logits(self, params, x):
        x = layers.apply_norm(self.cfg.norm, params["final_norm"], x)
        return layers.unembed(params["unembed"], x, self.cfg.vocab)

    def _mamba_layers(self, params):
        """(layer parameters, side-state path, index) of every Mamba2 layer
        in order: the super-blocks' (each followed by the shared block) and
        the tail's."""
        for i in range(self.n_super):
            group = _layer(params["main"], i)
            for j in range(self.cfg.attn_every):
                yield _layer(group, j), "ssm_main", (i, j)
        for i in range(self.tail):
            yield _layer(params["tail"], i), "ssm_tail", (i,)

    def _shared_block(self, p, x, attend):
        """The shared attention + MLP block around ``attend(h) -> (a, cache)``."""
        cfg = self.cfg
        a, cache = attend(layers.apply_norm(cfg.norm, p["ln1"], x))
        x = x + a
        return x + layers.mlp(p["mlp"], layers.apply_norm(cfg.norm, p["ln2"], x), cfg.act), cache

    # ------------------------------------------------------------ train

    def _mamba_train(self, lp, x):
        cfg = self.cfg
        return x + mamba2.mamba2_train(lp["mixer"], cfg,
                                       layers.apply_norm(cfg.norm, lp["ln"], x))

    def _super_train(self, group, shared, x, positions):
        """One super-block of the training forward: its Mamba2 layers, then
        the shared block."""
        for j in range(self.cfg.attn_every):
            x = self._mamba_train(_layer(group, j), x)
        return self._shared_block(shared, x, lambda h: (mattn.attn_train(
            shared["attn"], self.cfg, h, positions, impl=mattn.TRAIN_IMPL), None))[0]

    def loss(self, params, batch):
        """The next-token cross entropy of ``batch`` (``tokens``,
        ``labels``, ``loss_mask`` [B, S]).  Each super-block runs under
        ``layers.remat``; the tail's layers do not, as in JAX."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = layers.embed(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        for i in range(self.n_super):
            x = layers.remat(self.cfg, self._super_train, _layer(params["main"], i),
                             params["shared_attn"], x, positions)
        for i in range(self.tail):
            x = self._mamba_train(_layer(params["tail"], i), x)
        return _next_token_loss(self._logits(params, x), batch)

    # ------------------------------------------------------------ prefill

    def prefill(self, params, batch, max_seq: int, *, impl: str = "auto",
                quant_impl: str = "auto", lengths=None, prior=None, prior_len=None):
        """Process the prompt ``batch["tokens"]`` [B, S], every row real to
        its last token: the SSD scans build the Mamba2 states, the shared
        block's invocations their quantized caches (``impl`` the
        flash-prefill kernel on the card, ``quant_impl`` the quantize
        kernel).  Returns ``(last_logits [B, 1, V], state)``.  ``lengths``
        and ``prior`` raise: the states would absorb right-padding, and
        pages hold no prefix SSM states."""
        if lengths is not None or prior is not None or prior_len is not None:
            raise ValueError("the hybrid prefills at the exact length: it takes no lengths, "
                             "prior or prior_len")
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = layers.embed(params["embed"], tokens)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        shared = params["shared_attn"]
        states = {"ssm_main": [], "ssm_tail": []}
        caches = []
        for lp, path, idx in self._mamba_layers(params):
            out, st = mamba2.mamba2_prefill(lp["mixer"], cfg, layers.apply_norm(
                cfg.norm, lp["ln"], x))
            x = x + out
            states[path].append(st)
            if path == "ssm_main" and idx[1] == cfg.attn_every - 1:
                x, cache = self._shared_block(shared, x, lambda h: mattn.attn_prefill_cache(
                    shared["attn"], cfg, h, positions, max_seq, impl=impl,
                    quant_impl=quant_impl))
                caches.append(cache)
        state = {"ssm_main": _stack_states(states["ssm_main"], (self.n_super, cfg.attn_every))}
        if self.tail:
            state["ssm_tail"] = _stack_states(states["ssm_tail"], (self.tail,))
        state["caches"] = [qcache.stack_caches(caches)]
        state["pos"] = torch.full((b,), s, dtype=torch.int32, device=x.device)
        return self._logits(params, x[:, -1:]), state

    # ------------------------------------------------------------ decode

    def _side_states(self, batch_size: int, device) -> dict:
        cfg = self.cfg
        one = mamba2.mamba2_init_state(cfg, batch_size, device)

        def stacked(lead):
            return {k: v.expand(*lead, *v.shape).contiguous() for k, v in one.items()}

        st = {"ssm_main": stacked((self.n_super, cfg.attn_every))}
        if self.tail:
            st["ssm_tail"] = stacked((self.tail,))
        return st

    def init_decode_state(self, batch_size: int, max_seq: int, *, mesh=None,
                          splitkv_axis: str = "data", device=None):
        """Zero Mamba2 states, empty caches and positions on ``device`` (the
        card unless given); ``mesh`` aligns the block capacity as
        ``DecoderLM.init_decode_state`` does."""
        cfg = self.cfg
        device = resolve_device(device)
        caches = [qcache.stack_caches([qcache.init_cache(
            batch_size, cfg.n_kv_heads, cfg.head_dim, max_seq, bits=cfg.kv_bits,
            block_n=cfg.kv_block, k_gran=cfg.kv_gran,
            block_align=qcache.splitkv_block_align(mesh, splitkv_axis), device=device)
            for _ in range(self.n_super)])]
        return {**self._side_states(batch_size, device), "caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def paged_spec(self) -> PagedSpec:
        """A mixed cache family: the shared block's caches (one a
        super-block invocation) page; the Mamba2 states are constant-size
        per-slot side state the engine splices at admission and that never
        touch the page table.  ``exact_prefill``: prompts prefill at their
        exact length; ``supports_prior=False``: prefix sharing would need
        prefix SSM states, which pages do not hold."""
        cfg = self.cfg
        side = (("ssm_main", 2),) + ((("ssm_tail", 1),) if self.tail else ())
        return PagedSpec(
            paged=True, block_n=cfg.kv_block, n_kv_heads=cfg.n_kv_heads, d_k=cfg.head_dim,
            d_v=cfg.head_dim, page_layers=self.n_super, side_state=side, exact_prefill=True,
            supports_prior=False,
        )

    def init_paged_decode_state(self, batch_size: int, *, n_pages: int, nb_max: int,
                                device=None):
        """Paged decode state for the serving engine, on ``device`` (the card
        unless given): one ``PagedQuantKVCache`` stacked over the ``n_super``
        shared-block invocations; the Mamba2 states stay dense per slot."""
        cfg = self.cfg
        device = resolve_device(device)
        caches = [qcache.init_paged_cache(
            n_pages, batch_size, cfg.n_kv_heads, cfg.head_dim, nb_max, bits=cfg.kv_bits,
            block_n=cfg.kv_block, k_gran=cfg.kv_gran, layers=self.n_super, device=device)]
        return {**self._side_states(batch_size, device), "caches": caches,
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def mamba_decode(self, lp, x, st) -> torch.Tensor:
        """One Mamba2 layer's decode step, its state ``st`` (views into the
        stacked side state) updated in place."""
        cfg = self.cfg
        out, new = mamba2.mamba2_decode(lp["mixer"], cfg,
                                        layers.apply_norm(cfg.norm, lp["ln"], x), st)
        st["ssm"].copy_(new["ssm"])
        st["conv"].copy_(new["conv"])
        return x + out

    def shared_decode(self, shared, x, positions, cache, **attn_kw) -> torch.Tensor:
        """One invocation of the shared block in a decode step, its cache
        appended in place (``mattn.attn_decode``)."""
        return self._shared_block(shared, x, lambda h: mattn.attn_decode(
            shared["attn"], self.cfg, h, positions, cache, **attn_kw))[0]

    def decode_step(self, params, state, tokens, *, impl="auto", quant_impl="auto",
                    num_splits="auto", mask=None, draft_bits=None):
        """tokens [B, 1] -> (logits [B, 1, V], state).  The Mamba2 states
        and the caches of ``state`` are updated in place (``copy_`` into its
        tensors, so a captured CUDA graph's buffers stay the state); the
        returned state holds the same tensors and ``pos + 1``.  ``mask`` and
        ``draft_bits`` act on the shared block's attention as in
        ``DecoderLM.decode_step``; the Mamba2 states advance on every row
        (the verify pass restores a dead row's, ``speculative.VerifyPass``)."""
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens)
        pos = state["pos"]
        positions = pos[:, None]
        shared = params["shared_attn"]
        stacked = state["caches"][0]
        attn_kw = dict(impl=impl, quant_impl=quant_impl, num_splits=num_splits, mask=mask,
                       draft_bits=draft_bits)
        for lp, path, idx in self._mamba_layers(params):
            side = state[path]
            x = self.mamba_decode(lp, x, {k: v[idx] for k, v in side.items()})
            if path == "ssm_main" and idx[1] == cfg.attn_every - 1:
                x = self.shared_decode(shared, x, positions, stacked.layer(idx[0]), **attn_kw)
        return self._logits(params, x), {**state, "pos": pos + 1}


def _stack_states(states: list[dict], lead: tuple) -> dict:
    """Per-layer Mamba2 states (in layer order) stacked under ``lead``."""
    return {k: torch.stack([st[k] for st in states]).reshape(*lead, *states[0][k].shape)
            for k in states[0]}


class XLSTMLM:
    """xLSTM: ``n_super`` super-blocks of ``mlstm_per_slstm`` mLSTM blocks
    and one sLSTM block, each block ``x + mixer(norm(x))``.  The parameter
    tree is JAX's: ``blocks`` with ``mlstm`` stacked ``[n_super,
    mlstm_per_slstm, ...]`` and ``slstm`` ``[n_super, ...]``, ``embed``,
    ``final_norm``, ``unembed``.  The decode state is

        {"blocks": {"mlstm": {"C": f32 [n_super, per, B, H, dh, dh],
                              "n": f32 [n_super, per, B, H, dh],
                              "m": f32 [n_super, per, B, H]},
                    "slstm": {"c", "n", "h", "m": f32 [n_super, B, H, dh]}},
         "pos": int32 [B]}

    and :meth:`decode_step` updates it in place (``copy_`` into its
    tensors, so a captured CUDA graph advances it).  No KV cache: the
    ``impl``/``quant_impl``/``mask``/``draft_bits`` arguments the engine
    passes change nothing, and prompts prefill at their exact length."""

    def __init__(self, cfg):
        per = cfg.mlstm_per_slstm + 1
        if cfg.n_layers % per:
            raise ValueError(f"n_layers={cfg.n_layers} is not a multiple of the super-block "
                             f"({cfg.mlstm_per_slstm} mLSTM + 1 sLSTM)")
        self.cfg = cfg
        self.n_super = cfg.n_layers // per

    # ------------------------------------------------------------ params

    def _block_def(self, mixer_def):
        return {"ln": layers.norm_def(self.cfg.norm, self.cfg.d_model), "mixer": mixer_def}

    def param_defs(self):
        cfg = self.cfg
        super_def = {"mlstm": stack(self._block_def(xlstm.mlstm_def(cfg)), cfg.mlstm_per_slstm),
                     "slstm": self._block_def(xlstm.slstm_def(cfg))}
        return {
            "embed": layers.embed_def(cfg.padded_vocab, cfg.d_model),
            "final_norm": layers.norm_def(cfg.norm, cfg.d_model),
            "unembed": layers.unembed_def(cfg.d_model, cfg.padded_vocab),
            "blocks": stack(super_def, self.n_super),
        }

    def init(self, gen: torch.Generator, device=None):
        """Random parameters drawn from ``gen``, on ``device`` (the card
        unless given)."""
        return init_tree(self.param_defs(), gen, device)

    def _super_train(self, group, x):
        """One super-block of the training forward from fresh states, which
        are dropped: its mLSTM blocks, then its sLSTM block (the sequential
        cells, as JAX trains them)."""
        cfg = self.cfg
        for j in range(cfg.mlstm_per_slstm):
            lp = _layer(group["mlstm"], j)
            h = layers.apply_norm(cfg.norm, lp["ln"], x)
            x = x + xlstm.mlstm_block(lp["mixer"], cfg, h)[0]
        lp = group["slstm"]
        return x + xlstm.slstm_block(lp["mixer"], cfg, layers.apply_norm(cfg.norm, lp["ln"], x))[0]

    def loss(self, params, batch):
        """The next-token cross entropy of ``batch`` (``tokens``,
        ``labels``, ``loss_mask`` [B, S]); each super-block runs under
        ``layers.remat``, each whole time chunk of its recurrences under
        ``xlstm._chunked_time_scan``'s checkpoint."""
        x = layers.embed(params["embed"], batch["tokens"])
        for i in range(self.n_super):
            x = layers.remat(self.cfg, self._super_train, _layer(params["blocks"], i), x)
        return _next_token_loss(self._logits(params, x), batch)

    def _logits(self, params, x):
        x = layers.apply_norm(self.cfg.norm, params["final_norm"], x)
        return layers.unembed(params["unembed"], x, self.cfg.vocab)

    # ------------------------------------------------------------ the blocks

    def mlstm_layer(self, lp, x, st) -> torch.Tensor:
        """One mLSTM block over x [B, S, d] from the state ``st`` (views into
        the stacked state), which takes the new state in place."""
        out, new = xlstm.mlstm_block(lp["mixer"], self.cfg,
                                     layers.apply_norm(self.cfg.norm, lp["ln"], x), st)
        for k, v in new.items():
            st[k].copy_(v)
        return x + out

    def slstm_layer(self, lp, x, st) -> torch.Tensor:
        """One sLSTM block, as :meth:`mlstm_layer`."""
        out, new = xlstm.slstm_block(lp["mixer"], self.cfg,
                                     layers.apply_norm(self.cfg.norm, lp["ln"], x), st)
        for k, v in new.items():
            st[k].copy_(v)
        return x + out

    def _forward(self, params, x, blocks):
        """x [B, S, d] through every block in order, the recurrent states
        ``blocks`` (the decode state's) updated in place."""
        for i in range(self.n_super):
            group = _layer(params["blocks"], i)
            for j in range(self.cfg.mlstm_per_slstm):
                x = self.mlstm_layer(_layer(group["mlstm"], j), x,
                                     {k: v[i, j] for k, v in blocks["mlstm"].items()})
            x = self.slstm_layer(group["slstm"], x, {k: v[i] for k, v in blocks["slstm"].items()})
        return x

    # ------------------------------------------------------------ serving

    def paged_spec(self) -> PagedSpec:
        """No KV anywhere: the whole decode state is constant-size recurrent
        side state, spliced per slot at admission (the batch on axis 2 of
        the mLSTM states, 1 of the sLSTM's, after the super-block stacking).
        ``paged=False`` routes the serving engine's exact-length shim."""
        return PagedSpec(
            paged=False, block_n=self.cfg.kv_block, n_kv_heads=0, d_k=0, d_v=0,
            side_state=(("blocks/mlstm", 2), ("blocks/slstm", 1)), exact_prefill=True,
        )

    def init_decode_state(self, batch_size: int, max_seq: int = 0, *, device=None):
        """Fresh recurrent states (``C``, ``n``, ``c``, ``h`` zero, the
        stabilisers ``m`` at -1e30) and positions on ``device`` (the card
        unless given); ``max_seq`` is unused (constant-size state)."""
        cfg = self.cfg
        device = resolve_device(device)

        def stacked(one, lead):
            return {k: v.expand(*lead, *v.shape).contiguous() for k, v in one.items()}

        return {"blocks": {
                    "mlstm": stacked(xlstm.mlstm_init_state(cfg, batch_size, device),
                                     (self.n_super, cfg.mlstm_per_slstm)),
                    "slstm": stacked(xlstm.slstm_init_state(cfg, batch_size, device),
                                     (self.n_super,))},
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def prefill(self, params, batch, max_seq: int = 0, *, impl: str = "auto",
                quant_impl: str = "auto", lengths=None, prior=None, prior_len=None):
        """Process the prompt ``batch["tokens"]`` [B, S], every row real to
        its last token, from fresh states.  Returns ``(last_logits [B, 1,
        V], state)``.  ``lengths`` and ``prior`` raise: the recurrent states
        would absorb right-padding, and there is no cache to share."""
        if lengths is not None or prior is not None or prior_len is not None:
            raise ValueError("xLSTM prefills at the exact length: it takes no lengths, prior "
                             "or prior_len")
        tokens = batch["tokens"]
        x = layers.embed(params["embed"], tokens)
        state = self.init_decode_state(tokens.shape[0], device=x.device)
        x = self._forward(params, x, state["blocks"])
        state["pos"].fill_(tokens.shape[1])
        return self._logits(params, x[:, -1:]), state

    def decode_step(self, params, state, tokens, *, impl="auto", quant_impl="auto",
                    num_splits="auto", mask=None, draft_bits=None):
        """tokens [B, 1] -> (logits [B, 1, V], state): every recurrent state
        advanced in place on every row (the speculative verify pass restores
        a dead row's, ``speculative.VerifyPass``); the returned state holds
        the same tensors and ``pos + 1``."""
        x = self._forward(params, layers.embed(params["embed"], tokens), state["blocks"])
        return self._logits(params, x), {**state, "pos": state["pos"] + 1}
