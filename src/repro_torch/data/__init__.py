"""The synthetic training data pipeline (``data/pipeline.py``)."""
from repro_torch.data.pipeline import (  # noqa: F401
    Prefetcher,
    batch_dims,
    make_batch,
    shard_key,
)
