"""Encoder-decoder LM (the SeamlessM4T backbone).  The modality front end is
a stub: the encoder reads precomputed frame embeddings ``batch["frames"]``.

Decode keeps two BitDecoding caches per decoder layer:

* self attention: a growing quantized cache, appended in place each step
  (the residual and its flush, as in ``DecoderLM``);
* cross attention: a *static* quantized cache of the encoder memory's K/V,
  built once at prefill (``attention.build_cross_cache``), the paper's
  offline case (Fig. 1a): the same kernels, its tail held in the bf16
  residual and never flushed.

The parameter tree is JAX's: ``embed``, ``enc_norm``, ``final_norm``,
``unembed``, and the ``encoder`` / ``decoder`` stacks with a leading layer
axis; the layers run in a Python loop over views of them.  The decode state
is

    {"self": QuantKVCache stacked over the decoder layers,
     "cross": QuantKVCache stacked over the decoder layers,
     "pos": int32 [B]}

The serving engine does not run this family (``paged_spec`` is None: a
request carries no frame embeddings).  :meth:`EncDecLM.loss` is the training
loss, over ``batch["frames"]`` and the decoder's tokens.
"""
from __future__ import annotations

import torch

from repro_torch.core import qcache
from repro_torch.core.device import resolve_device
from repro_torch.models import attention as mattn
from repro_torch.models import layers
from repro_torch.models.params import init_tree, stack
from repro_torch.models.transformer import _layer, _next_token_loss


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


class EncDecLM:
    """A pre-norm encoder (full self attention) and decoder (causal self
    attention, cross attention over the encoder memory, MLP)."""

    def __init__(self, cfg):
        if not cfg.encdec or cfg.mixer != "attn" or not cfg.rope:
            raise ValueError(f"{cfg.name}: EncDecLM needs encdec=True with RoPE attention")
        self.cfg = cfg

    # ------------------------------------------------------------ params

    def _enc_def(self):
        cfg = self.cfg
        return {
            "ln1": layers.norm_def(cfg.norm, cfg.d_model),
            "attn": mattn.attn_def(cfg),
            "ln2": layers.norm_def(cfg.norm, cfg.d_model),
            "mlp": layers.mlp_def(cfg.d_model, cfg.d_ff, cfg.act, cfg.attn_bias),
        }

    def _dec_def(self):
        cfg = self.cfg
        return {**self._enc_def(), "ln_x": layers.norm_def(cfg.norm, cfg.d_model),
                "xattn": mattn.cross_attn_def(cfg)}

    def param_defs(self):
        cfg = self.cfg
        return {
            "embed": layers.embed_def(cfg.padded_vocab, cfg.d_model),
            "enc_norm": layers.norm_def(cfg.norm, cfg.d_model),
            "final_norm": layers.norm_def(cfg.norm, cfg.d_model),
            "unembed": layers.unembed_def(cfg.d_model, cfg.padded_vocab),
            "encoder": stack(self._enc_def(), cfg.enc_layers),
            "decoder": stack(self._dec_def(), cfg.dec_layers),
        }

    def init(self, gen: torch.Generator, device=None):
        """Random parameters drawn from ``gen``, on ``device`` (the card
        unless given)."""
        return init_tree(self.param_defs(), gen, device)

    def _norm(self, p, x):
        return layers.apply_norm(self.cfg.norm, p, x)

    def _mlp(self, p, x):
        return x + layers.mlp(p["mlp"], self._norm(p["ln2"], x), self.cfg.act)

    def _logits(self, params, x):
        return layers.unembed(params["unembed"], self._norm(params["final_norm"], x),
                              self.cfg.vocab)

    # ------------------------------------------------------------ encoder

    def _enc_layer(self, p, x, positions, impl):
        x = x + mattn.attn_train(p["attn"], self.cfg, self._norm(p["ln1"], x), positions,
                                 causal=False, impl=impl)
        return self._mlp(p, x)

    def encode(self, params, frames, *, impl: str = "auto"):
        """frames [B, T, d] (the stub front end's output) -> memory [B, T, d]
        (bf16): full self attention (the flash-prefill kernel's full mode on
        the card), RoPE over 0..T-1.  Each layer runs under ``layers.remat``
        (a plain call without autograd)."""
        cfg = self.cfg
        x = frames.to(torch.bfloat16)
        positions = _positions(*x.shape[:2], x.device)
        for li in range(cfg.enc_layers):
            x = layers.remat(cfg, self._enc_layer, _layer(params["encoder"], li), x,
                             positions, impl)
        return self._norm(params["enc_norm"], x)

    # ------------------------------------------------------------ train

    def _dec_layer_train(self, p, x, mem, positions):
        cfg = self.cfg
        x = x + mattn.attn_train(p["attn"], cfg, self._norm(p["ln1"], x), positions,
                                 impl=mattn.TRAIN_IMPL)
        x = x + mattn.cross_attn_train(p["xattn"], cfg, self._norm(p["ln_x"], x), mem,
                                       impl=mattn.TRAIN_IMPL)
        return self._mlp(p, x)

    def loss(self, params, batch):
        """The next-token cross entropy of the decoder's ``tokens`` /
        ``labels`` / ``loss_mask`` [B, S] given the encoder's ``frames`` [B,
        T, d]; every encoder and decoder layer under ``layers.remat``."""
        mem = self.encode(params, batch["frames"], impl=mattn.TRAIN_IMPL)
        tokens = batch["tokens"]
        x = layers.embed(params["embed"], tokens)
        positions = _positions(*tokens.shape, x.device)
        for li in range(self.cfg.dec_layers):
            x = layers.remat(self.cfg, self._dec_layer_train, _layer(params["decoder"], li), x,
                             mem, positions)
        return _next_token_loss(self._logits(params, x), batch)

    # ------------------------------------------------------------ decode

    def init_decode_state(self, batch_size: int, max_seq: int, *, device=None):
        """Empty self caches of ``max_seq`` tokens, empty cross caches of
        ``cfg.enc_len`` and positions, on ``device`` (the card unless
        given)."""
        cfg = self.cfg
        device = resolve_device(device)

        def caches(n_tokens):
            return qcache.stack_caches([qcache.init_cache(
                batch_size, cfg.n_kv_heads, cfg.head_dim, n_tokens, bits=cfg.kv_bits,
                block_n=cfg.kv_block, k_gran=cfg.kv_gran, device=device)
                for _ in range(cfg.dec_layers)])

        return {"self": caches(max_seq), "cross": caches(cfg.enc_len),
                "pos": torch.zeros((batch_size,), dtype=torch.int32, device=device)}

    def paged_spec(self):
        """None: not serveable by the engine, whose requests carry no frame
        embeddings for the prefill (``models/family.py``)."""
        return None

    def prefill(self, params, batch, max_seq: int, *, impl: str = "auto",
                quant_impl: str = "auto"):
        """Encode ``batch["frames"]``, build the static cross caches (of
        ``frames.shape[1]`` tokens) and prefill the decoder's self caches
        from ``batch["tokens"]`` [B, S], every row real to its last token.
        Returns ``(last_logits [B, 1, V], state)``.  ``impl`` picks the
        prefill attention (the flash-prefill kernel on the card: full for
        the encoder and the cross attention, causal for the decoder's self
        attention), ``quant_impl`` the quantize kernel."""
        cfg = self.cfg
        mem = self.encode(params, batch["frames"], impl=impl)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = layers.embed(params["embed"], tokens)
        positions = _positions(b, s, x.device)
        self_caches, cross_caches = [], []
        for li in range(cfg.dec_layers):
            p = _layer(params["decoder"], li)
            a, cache = mattn.attn_prefill_cache(p["attn"], cfg, self._norm(p["ln1"], x),
                                                positions, max_seq, impl=impl,
                                                quant_impl=quant_impl)
            x = x + a
            self_caches.append(cache)
            kv = mattn.mem_kv(p["xattn"], mem)  # one projection for the cache and the attention
            cross_caches.append(mattn.build_cross_cache(p["xattn"], cfg, mem, kv=kv,
                                                        quant_impl=quant_impl))
            x = x + mattn.cross_attn_train(p["xattn"], cfg, self._norm(p["ln_x"], x), mem,
                                           kv=kv, impl=impl)
            x = self._mlp(p, x)
        state = {"self": qcache.stack_caches(self_caches),
                 "cross": qcache.stack_caches(cross_caches),
                 "pos": torch.full((b,), s, dtype=torch.int32, device=x.device)}
        return self._logits(params, x[:, -1:]), state

    def decode_step(self, params, state, tokens, *, impl="auto", quant_impl="auto",
                    num_splits="auto"):
        """tokens [B, 1] -> (logits [B, 1, V], state).  The self caches are
        appended in place, the cross caches only read; the returned state
        holds the same caches and ``pos + 1``."""
        cfg = self.cfg
        x = layers.embed(params["embed"], tokens)
        pos = state["pos"]
        positions = pos[:, None]
        for li in range(cfg.dec_layers):
            p = _layer(params["decoder"], li)
            a, _ = mattn.attn_decode(p["attn"], cfg, self._norm(p["ln1"], x), positions,
                                     state["self"].layer(li), impl=impl,
                                     quant_impl=quant_impl, num_splits=num_splits)
            x = x + a
            x = x + mattn.cross_attn_decode(p["xattn"], cfg, self._norm(p["ln_x"], x),
                                            state["cross"].layer(li), impl=impl,
                                            num_splits=num_splits)
            x = self._mlp(p, x)
        return self._logits(params, x), {**state, "pos": pos + 1}
