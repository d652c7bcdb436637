"""Map JAX-package parameters onto the port's parameter tree.

This is the one place that knows the JAX layout.  The trees and leaf shapes
are the same (``DecoderLM.param_defs``); bf16 arrives as an
``ml_dtypes.bfloat16`` numpy array and is carried across as its 16 raw bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import leaves
from repro_torch.models.zoo import build_model


def to_torch(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor; bf16 (``ml_dtypes.bfloat16``) keeps
    its raw bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def params_from_jax(tree_of_numpy, cfg):
    """Nested dict of numpy arrays (``jax.tree.map(np.asarray, params)``) ->
    the port's parameter dict for ``cfg`` (CPU tensors), checked leaf by
    leaf against the port's definitions."""
    out: dict = {}
    for path, p in leaves(build_model(cfg).param_defs()):
        node = tree_of_numpy
        for key in path:
            node = node[key]
        t = to_torch(np.asarray(node))
        if tuple(t.shape) != p.shape or t.dtype != p.dtype:
            raise ValueError(
                f"{'/'.join(path)}: JAX leaf {tuple(t.shape)} {t.dtype}, "
                f"port expects {p.shape} {p.dtype}"
            )
        dst = out
        for key in path[:-1]:
            dst = dst.setdefault(key, {})
        dst[path[-1]] = t
    return out
