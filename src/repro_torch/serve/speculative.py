"""Self-speculative decoding on the hierarchical quantized cache: the port of
the JAX package's ``serve/speculative.py``.

The paper's cache is a draft/verify hierarchy: low-bit packed blocks plus a
bf16 residual tail, behind one page table and one set of weights.  Two
passes over the engine's decode state exploit it:

* **draft** (:class:`DraftPass`): ``spec_k - 1`` greedy decode steps
  against the truncated read of the same pools: every packed code read at
  its top ``spec_bits`` bits (the decode kernels' ``draft_bits``), appends
  residual-only into the pass's own copy of the residuals, ``res_len`` and
  ``pos`` (``qcache.widen_residual`` / ``draft_append``), and the recurrent
  side state (the hybrid's Mamba2 states, xLSTM's states) advanced in the
  pass's own copy.  No second model, no second table, no pool write.  Over
  the exact-length shim's dense caches the same holds, the packed blocks
  read in place of the pools.
* **verify** (:class:`VerifyPass`): ``spec_k`` full-fidelity decode steps
  over the ``[B, spec_k]`` feed matrix, written in place into the engine's
  state, with a per-row alive mask that freezes a row's cache (the append
  kernel's ``mask``) and ``pos`` from the step after its draft diverges.

Where the JAX package jits each pass into one program (a ``lax.scan``), the
port captures each as one CUDA graph (``async_runtime.CapturedPass``): a
pass is one replay from the host, its inputs static buffers filled with
``core.device.upload``.  On the CPU the same bodies run eagerly.

Acceptance (host side, ``ServeEngine._advance_spec``): a draft token is
accepted iff it equals the verify argmax before it; the longest matching
prefix is kept and the verify token replaces the first mismatch.  Accepted
tokens are exact matches and a masked append leaves a live row as an
unmasked one would, so the emitted streams and the caches equal
``spec_k = 1`` bit for bit.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import qcache
from repro_torch.kernels.bitdecode.ops import RES_TOKENS
from repro_torch.models.family import get_path, set_path, tensors_at
from repro_torch.serve.async_runtime import CapturedPass


def _mask_leaf(alive, new, old, bdim: int):
    """Select per row between ``new`` and ``old`` on the batch axis ``bdim``."""
    sel = alive.reshape((1,) * bdim + (-1,) + (1,) * (new.dim() - bdim - 1))
    return torch.where(sel, new, old)


def freeze_dead_lanes(state, st_new, saved: dict, alive, side_state) -> None:
    """In place: ``state["pos"]`` takes ``st_new["pos"]`` on live rows and
    keeps its value on dead ones, and so does every declared recurrent
    side-state path (``saved``: its values before the step).  The cache
    appends are masked in the step itself; this covers what the model
    updates unconditionally (``saved[path]``: the path's tensors in
    ``tensors_at`` order).  Attention models declare no side state; xLSTM's
    is all its state."""
    state["pos"].copy_(torch.where(alive, st_new["pos"], state["pos"]))
    for path, bdim in side_state:
        for dst, new, old in zip(tensors_at(state, path), tensors_at(st_new, path), saved[path]):
            dst.copy_(_mask_leaf(alive, new, old, bdim))


class DraftPass(CapturedPass):
    """The draft pass over the engine's ``state``: fill :attr:`tok0` (int32
    ``[B]``, the token each row feeds this cycle), :meth:`replay`, read
    :attr:`drafts` (int32 ``[B, spec_k - 1]``).

    Its state (:attr:`dstate`) shares the engine's pools (or the shim's
    dense packed blocks), ``pack_blocks`` and page table (read only) and
    owns residuals widened by ``spec_k - 1`` tokens, rounded up to the
    decode kernel's residual unit (``RES_TOKENS``), plus ``res_len``,
    ``pos`` and a copy of every ``side_state`` path (the hybrid's Mamba2
    states, xLSTM's states, which a decode step advances in place); each
    run starts by copying the engine's into them, so the engine's state is
    never written.  Rows that are not decoding draft garbage the engine
    ignores."""

    what = "the draft pass"

    def __init__(self, model, params, state, spec, *, spec_k: int, spec_bits: int,
                 impl: str = "auto", quant_impl: str = "auto", splitkv=None):
        super().__init__(state, splitkv)
        self.steps = spec_k - 1
        if self.steps < 1:
            raise ValueError(f"spec_k={spec_k} needs no draft pass (k >= 2)")
        self.model, self.params = model, params
        self.spec_bits = int(spec_bits)
        self.impl, self.quant_impl = impl, quant_impl
        pos = state["pos"]
        b = pos.shape[0]
        self.tok0 = torch.zeros((b,), dtype=torch.int32, device=pos.device)
        self.drafts = torch.zeros((b, self.steps), dtype=torch.int32, device=pos.device)
        self.dstate = {"pos": pos.clone()}
        if "caches" in state:  # xLSTM has none
            self.dstate["caches"] = [
                dataclasses.replace(qcache.widen_residual(c, self.steps, multiple=RES_TOKENS),
                                    res_len=c.res_len.clone())
                for c in state["caches"]]
        self.side = tuple(path for path, _ in spec.side_state)
        for path in self.side:  # HybridLM's "ssm_main", XLSTMLM's "blocks/mlstm", ...
            node = get_path(state, path)
            set_path(self.dstate, path, {k: v.clone() for k, v in node.items()}
                     if isinstance(node, dict) else node.clone())
        self.capture()

    def _buffers(self) -> list[torch.Tensor]:
        own = [self.tok0, self.drafts, self.dstate["pos"]]
        for c in self.dstate.get("caches", ()):
            own += [t for t in (c.k_res, c.v_res, c.res_len) if t is not None]
        for path in self.side:
            own += tensors_at(self.dstate, path)
        return own

    def _body(self) -> None:
        for dc, c in zip(self.dstate.get("caches", ()), self.state.get("caches", ())):
            n = c.k_res.shape[-2]
            dc.k_res[..., :n, :].copy_(c.k_res)
            if c.v_res is not None:  # shared_kv: K's residual alone
                dc.v_res[..., :n, :].copy_(c.v_res)
            dc.res_len.copy_(c.res_len)
        self.dstate["pos"].copy_(self.state["pos"])
        for path in self.side:
            for dst, src in zip(tensors_at(self.dstate, path), tensors_at(self.state, path)):
                dst.copy_(src)
        tok = self.tok0[:, None]
        for i in range(self.steps):
            logits, st = self.model.decode_step(
                self.params, self.dstate, tok, impl=self.impl, quant_impl=self.quant_impl,
                draft_bits=self.spec_bits)
            self.dstate["pos"].copy_(st["pos"])
            self.drafts[:, i].copy_(logits[:, 0].argmax(-1))
            tok = self.drafts[:, i:i + 1]


class VerifyPass(CapturedPass):
    """The verify pass over the engine's ``state``, written in place: fill
    :attr:`feeds` (int32 ``[B, K]``: column 0 the committed feed, columns
    ``1..`` draft candidates or, on replay rows, the recorded stream),
    :attr:`limit` (int32 ``[B]``: feeds available, 0 for an idle slot) and
    :attr:`forced` (bool ``[B]``: replay rows accept unconditionally),
    :meth:`replay`, then read :attr:`v` (the argmax after each feed),
    :attr:`applied` (whether the feed ran: the row was alive) and
    :attr:`finite` (whether its logits row was finite), each ``[B, K]``.

    A row dies at step ``i + 1`` unless ``i + 1 < limit`` and it is forced
    or ``v[:, i] == feeds[:, i + 1]``.  A dead row's caches are untouched
    (the append's mask) and its ``pos`` and recurrent side state
    (``spec.side_state``, none for attention) are frozen."""

    what = "the verify pass"

    def __init__(self, model, params, state, spec, *, spec_k: int, impl: str = "auto",
                 quant_impl: str = "auto", splitkv=None):
        super().__init__(state, splitkv)
        self.k = int(spec_k)
        self.model, self.params = model, params
        self.impl, self.quant_impl = impl, quant_impl
        self.side = tuple(spec.side_state) if spec is not None else ()
        pos = state["pos"]
        b, dev = pos.shape[0], pos.device
        self.feeds = torch.zeros((b, self.k), dtype=torch.int32, device=dev)
        self.limit = torch.zeros((b,), dtype=torch.int32, device=dev)
        self.forced = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.v = torch.zeros((b, self.k), dtype=torch.int32, device=dev)
        self.applied = torch.zeros((b, self.k), dtype=torch.bool, device=dev)
        self.finite = torch.ones((b, self.k), dtype=torch.bool, device=dev)
        self.capture()

    def _buffers(self) -> list[torch.Tensor]:
        return [self.feeds, self.limit, self.forced, self.v, self.applied, self.finite]

    def _body(self) -> None:
        alive = self.limit > 0
        for i in range(self.k):
            saved = {path: [t.clone() for t in tensors_at(self.state, path)]
                     for path, _ in self.side}
            logits, st = self.model.decode_step(
                self.params, self.state, self.feeds[:, i:i + 1], impl=self.impl,
                quant_impl=self.quant_impl, mask=alive)
            row = logits[:, 0].float()
            v = row.argmax(-1)
            freeze_dead_lanes(self.state, st, saved, alive, self.side)
            self.v[:, i].copy_(v)
            self.applied[:, i].copy_(alive)
            self.finite[:, i].copy_(torch.isfinite(row).all(-1))
            if i + 1 < self.k:
                alive = alive & (self.limit > i + 1) & (self.forced | (v == self.feeds[:, i + 1]))
