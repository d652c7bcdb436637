"""Adafactor (factored second moments, no momentum): the JAX package's
``optim/adafactor.py``, the memory-frugal optimizer of the 671B-class
configs.

A leaf of two or more dimensions keeps a row and a column moment (means of
``g^2 + eps`` over its last and its second-to-last axis); a vector keeps a
full one.  ``beta = 1 - (step + 1)^-decay``, a linear warmup of the
learning rate, the update clipped to an RMS of ``clip_rms``.  The step's
scalars are f32 as JAX computes them; divisions divide by tensors on the
data's device (see ``optim/adamw.py``).  ``update`` advances the moments in
place.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import Optimizer, f32, scalar
from repro_torch.train import tree as tr


def adafactor(lr=1e-3, decay=0.8, eps=1e-30, clip_rms=1.0, weight_decay=0.0,
              warmup=100, **_):
    def lr_at(step):
        return f32(lr) * min(f32(1.0), f32(step) / f32(max(1, warmup)))

    def init(params):
        def leaf(p):
            if p.dim() >= 2:
                return {"row": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "col": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32,
                                           device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return tr.map_leaves(leaf, params)

    def update(grads, state, params, step):
        beta = f32(1) - f32(step + 1) ** f32(-decay)
        keep, new = float(beta), float(f32(1) - beta)
        lr_t = float(lr_at(step))
        updates = {}
        for path, p in tr.leaves_with_paths(params):
            g = tr.get(grads, path).float()
            s = tr.get(state, path)
            g2 = (g * g).add_(eps)
            if p.dim() >= 2:
                row, col = s["row"], s["col"]
                row.mul_(keep).add_(g2.mean(dim=-1) * new)
                col.mul_(keep).add_(g2.mean(dim=-2) * new)
                rfac = row / row.mean(dim=-1, keepdim=True)
                u = g / (torch.sqrt(rfac)[..., None] * torch.sqrt(col)[..., None, :]).add_(1e-12)
            else:
                v = s["v"]
                v.mul_(keep).add_(g2 * new)
                u = g / torch.sqrt(v).add_(1e-12)
            rms = torch.sqrt((u * u).mean() + 1e-12)
            u.div_(torch.clamp_min(rms / scalar(clip_rms, rms), 1.0))
            if weight_decay and p.dim() >= 2:
                u.add_(p.float() * weight_decay)
            tr.put(updates, path, u.mul_(-lr_t).to(p.dtype))
        return updates, state

    return Optimizer(init=init, update=update)
