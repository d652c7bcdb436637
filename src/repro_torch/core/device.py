"""The device an entry point allocates on when its caller names none."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card: entry points run on the CUDA device
    unless asked for the CPU, and raise rather than fall back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")
