"""Training on one device: the microbatched, clipped train step
(``train/step.py``) and the parameter-tree walk it shares with the
checkpoint manager (``train/tree.py``)."""
from repro_torch.train.step import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
    value_and_grad,
)
