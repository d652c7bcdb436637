"""Checkpoints in the JAX package's directory format
(``checkpoint/manager.py``)."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
