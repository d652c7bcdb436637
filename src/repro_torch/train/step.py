"""The train step: the JAX package's ``train/step.py`` on one device.

Microbatched gradient accumulation, bf16 parameters and activations with an
f32 loss and f32 optimizer math, and gradient clipping by the global norm.
Gradients come from ``torch.autograd`` on the parameter leaves (made to
require grad for the duration of the call).  With ``microbatches > 1`` the
batch splits into contiguous row blocks (microbatch i is rows ``[i * B/n,
(i + 1) * B/n)``, JAX's ``_split_microbatches``), each one's gradients are
added in f32 as ``g / n`` in microbatch order, and so is its loss.  The
norm sums the leaves' f32 squares in JAX's leaf order; the clip scale is
cast to the gradients' dtype; each parameter takes ``p + u`` in its own
dtype, in place.

``train_state_shapes`` (the abstract state of the JAX package's dry run)
has no counterpart here: ROADMAP queue A, item 12.4.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train import tree as tr


@dataclasses.dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int


def init_train_state(model, optimizer, gen: torch.Generator, device=None) -> TrainState:
    """Parameters drawn from ``gen`` on ``device`` (the card unless given),
    the optimizer's zero state, step 0."""
    params = model.init(gen, device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def value_and_grad(loss_fn, params, batch):
    """``(loss_fn(params, batch), the gradient of every parameter leaf)``,
    the gradients a list in JAX's leaf order (``tree.leaves``) in the
    parameters' dtypes; a leaf the loss does not read gets zeros, as in
    JAX."""
    flat = tr.leaves(params)
    for t in flat:
        t.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for t in flat:
            t.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(t) if g is None else g for t, g in zip(flat, grads)]


def make_train_step(model, optimizer, *, microbatches: int = 1, clip_norm: float = 1.0):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})`` (0-d
    f32 tensors on the parameters' device).  The parameters and the
    optimizer state are updated in place; the returned state holds them
    with ``step + 1``."""

    def train_step(state: TrainState, batch: dict):
        params = state.params
        paths = [path for path, _ in tr.leaves_with_paths(params)]
        if microbatches > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % microbatches:
                raise ValueError(f"batch of {rows} rows does not split into {microbatches} "
                                 "microbatches")
            m = rows // microbatches
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in tr.leaves(params)]
            loss = None
            for i in range(microbatches):
                mb = {k: v[i * m:(i + 1) * m] for k, v in batch.items()}
                mb_loss, mb_grads = value_and_grad(model.loss, params, mb)
                for acc, g in zip(grads, mb_grads):
                    acc.add_(g.float() / microbatches)
                del mb_grads
                term = mb_loss / microbatches
                loss = term if loss is None else loss + term
        else:
            loss, grads = value_and_grad(model.loss, params, batch)

        gnorm = None
        for g in grads:
            sq = torch.sum(torch.square(g.float()))
            gnorm = sq if gnorm is None else gnorm + sq
        gnorm = torch.sqrt(gnorm)
        if clip_norm:
            limit = torch.full((), float(clip_norm), dtype=torch.float32, device=gnorm.device)
            scale = torch.clamp_max(limit / torch.clamp_min(gnorm, 1e-9), 1.0)
            for g in grads:
                g.mul_(scale.to(g.dtype))

        grad_tree: dict = {}
        for path, g in zip(paths, grads):
            tr.put(grad_tree, path, g)
        del grads
        updates, opt_state = optimizer.update(grad_tree, state.opt_state, params, state.step)
        with torch.no_grad():
            for path, p in tr.leaves_with_paths(params):
                p.add_(tr.get(updates, path))
        metrics = {"loss": loss.float(), "grad_norm": gnorm}
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return train_step
