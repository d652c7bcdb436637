"""Optimizers of the train step: AdamW and Adafactor, the JAX package's
``optim/`` (``Optimizer(init, update)`` and ``get_optimizer``).  The
cross-pod gradient compression (``optim/grad_compress.py``) exists only
across ranks: ROADMAP queue A, item 12.5."""
from repro_torch.optim.adafactor import adafactor  # noqa: F401
from repro_torch.optim.adamw import Optimizer, adamw  # noqa: F401


def get_optimizer(name: str, **kw) -> Optimizer:
    if name == "adamw":
        return adamw(**kw)
    if name == "adafactor":
        return adafactor(**kw)
    raise ValueError(f"unknown optimizer {name!r}")
