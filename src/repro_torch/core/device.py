"""The device an entry point allocates on when its caller names none, and
host-to-device uploads that do not wait on the card."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card: entry points run on the CUDA device
    unless asked for the CPU, and raise rather than fall back to it."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def upload(values, device, dtype=None) -> torch.Tensor:
    """Host values (a numpy array, a list or a scalar) as a tensor on
    ``device``.  For the card the values are staged in a fresh pinned
    buffer of PyTorch's caching host allocator and copied with
    ``non_blocking=True``: the copy is queued on the current stream behind
    the work already there, and the host does not wait for it.  The
    allocator records the copy's use of the buffer, so the buffer is not
    handed out again before the copy has run.  A copy from pageable memory
    would instead synchronise the stream.  On the CPU: a copy."""
    arr = np.ascontiguousarray(values)
    host = torch.from_numpy(arr.copy())
    if dtype is not None:
        host = host.to(dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return host
    return host.pin_memory().to(device, non_blocking=True)
