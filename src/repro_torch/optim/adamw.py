"""AdamW with f32 moments: the JAX package's ``optim/adamw.py``.

A linear warmup and a cosine decay of the learning rate, bias-corrected
moments, decoupled weight decay on the leaves of two or more dimensions
(not on norms or biases), and the update cast to the parameter's dtype.
The scalars of a step (the learning rate, the bias corrections) are f32, as
JAX computes them, taken on the host; each division by one divides by a 0-d
f32 tensor on the data's device (PyTorch's CUDA ``div`` by a Python number
multiplies by its reciprocal, which rounds otherwise).  Each elementwise
product and sum rounds where JAX's does, in its order.

``update`` advances the moments in place: the state it returns holds the
tensors it was given (no second copy of the moments at full width).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.train import tree as tr


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # params -> state
    update: Callable  # (grads, state, params, step) -> (updates, state)


def f32(x) -> np.float32:
    return np.float32(x)


def scalar(value, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a 0-d f32 tensor on ``like``'s device, filled there
    (no copy from the host)."""
    return torch.full((), float(value), dtype=torch.float32, device=like.device)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, warmup=100,
          schedule: str = "cosine", total_steps: int = 10000):
    def lr_at(step) -> np.float32:
        s = f32(step)
        warm = min(f32(1.0), s / f32(max(1, warmup)))
        if schedule == "cosine":
            t = np.clip((s - f32(warmup)) / f32(max(1, total_steps - warmup)), f32(0), f32(1))
            base = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * t))
        else:
            base = f32(1.0)
        return f32(lr) * warm * base

    def init(params):
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        return {"m": tr.map_leaves(zeros, params), "v": tr.map_leaves(zeros, params)}

    def update(grads, state, params, step):
        stepf = f32(step + 1)
        lr_t = float(lr_at(step))
        bc1 = f32(1) - f32(b1) ** stepf
        bc2 = f32(1) - f32(b2) ** stepf
        updates = {}
        for path, p in tr.leaves_with_paths(params):
            g = tr.get(grads, path).float()
            m, v = tr.get(state["m"], path), tr.get(state["v"], path)
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            u = m / scalar(bc1, m)
            u.div_(torch.sqrt(v / scalar(bc2, v)).add_(eps))
            if p.dim() >= 2:  # no decay on norms and biases
                u.add_(p.float() * weight_decay)
            tr.put(updates, path, u.mul_(-lr_t).to(p.dtype))
        return updates, state

    return Optimizer(init=init, update=update)
