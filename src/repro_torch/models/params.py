"""Parameter-definition trees, materialized from a ``torch.Generator``.

Models describe their parameters as a nested dict of :class:`P` leaves
(shape, init, dtype, fan-in); :func:`init_tree` draws them.  The tree and its
leaf shapes are the JAX package's, so converted JAX parameters drop in
(``repro_torch.convert``).  The random numbers differ from ``jax.random``.

Scales differ for the 3-D attention projections: the JAX package divides by
the square root of ``shape[-2]`` (the heads axis), while a leaf here may name
its true fan-in.  At full llama3-8b width the JAX scales alone make q and k
elements of standard deviation sqrt(4096/32) and sqrt(4096/8), so scores
of standard deviation in the hundreds: a one-hot softmax that amplifies
rounding-level differences between two correct attention implementations
from layer to layer.  ``chip_smoke.py --jax-init`` shows it: at those
scales the plain decode path summed in three splits departs from itself as
far as the CUDA kernels depart from it.  With the true fan-in, scores are
O(1).

The ``(1 + w)`` RMSNorm weights (gemma) start from zeros here, the
effective scale of 1 that every other norm starts from, where the JAX
package draws them as ones (scale 2).  Like the fan-in above, this changes
only the random init: converted JAX parameters are taken as they are.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.device import resolve_device


@dataclasses.dataclass(frozen=True)
class P:
    shape: tuple[int, ...]
    init: str = "normal"  # normal | zeros | ones | embed
    dtype: torch.dtype = torch.bfloat16
    fan_in: int | None = None  # default: the second-to-last dim, as in JAX
    scale: float | None = None  # the standard deviation itself, as JAX's ``scale``

    @property
    def std(self) -> float:
        if self.scale is not None:
            return self.scale
        if self.init == "embed":
            return 0.02
        fan_in = self.fan_in or (self.shape[-2] if len(self.shape) >= 2 else self.shape[-1])
        return 1.0 / math.sqrt(max(1, fan_in))


def stack(defs, n: int):
    """Prepend a layer dimension to every leaf."""
    if isinstance(defs, P):
        return dataclasses.replace(defs, shape=(n, *defs.shape))
    return {k: stack(v, n) for k, v in defs.items()}


def leaves(defs, prefix=()):
    """(path, P) pairs of a definition tree, in insertion order."""
    if isinstance(defs, P):
        yield prefix, defs
        return
    for k, v in defs.items():
        yield from leaves(v, (*prefix, k))


# elements of one float32 draw at most: a larger slice (deepseek-v3's 256
# experts of one layer, 7.5 G elements) is drawn one sub-slice at a time
_MAX_DRAW = 1 << 31


def _draw(sl: torch.Tensor, std: float, gen: torch.Generator) -> None:
    if sl.numel() > _MAX_DRAW and sl.dim() > 1:
        for part in sl:
            _draw(part, std, gen)
        return
    noise = torch.randn(sl.shape, generator=gen, dtype=torch.float32, device=gen.device)
    sl.copy_(noise.mul_(std))


def _init_leaf(p: P, gen: torch.Generator, device) -> torch.Tensor:
    out = torch.empty(p.shape, dtype=p.dtype, device=device)
    if p.init in ("zeros", "ones"):
        return out.fill_(float(p.init == "ones"))
    # drawn one leading slice (layer) at a time, on the generator's device, so
    # a stacked leaf never needs a full float32 copy of itself
    for sl in out if out.dim() >= 3 else [out]:
        _draw(sl, p.std, gen)
    return out


def init_tree(defs, gen: torch.Generator, device=None):
    """Materialize a definition tree on ``device`` (the card unless given),
    drawing from ``gen`` on the generator's own device."""
    device = resolve_device(device)
    if isinstance(defs, P):
        return _init_leaf(defs, gen, device)
    return {k: init_tree(v, gen, device) for k, v in defs.items()}
