"""Synthetic deterministic data: the JAX package's ``data/pipeline.py`` on
one device.

A batch is a pure function of (name, seed, step, shard index): each field's
numbers come from ``np.random.default_rng(shard_key(...))``, token ids in
``[0, 1024)`` taken modulo the vocab, the loss mask all ones, frame and
patch embeddings standard normal (bf16).  The JAX package keys the
generator with Python's ``hash()`` of that tuple, which is salted per
process for its string parts (``PYTHONHASHSEED``), so its batches change
from one process to the next (ROADMAP C).  :func:`shard_key` is a stable
digest instead (CRC-32 of the tuple's ``repr``): a resumed run in a new
process trains on the same data.  :func:`make_batch` takes the key function
as an argument, so a test can feed JAX's key and get JAX's arrays.

:class:`Prefetcher` makes the batches of consecutive steps on a background
thread from ``start_step``.  ``batch_specs`` (shardings for a mesh) has no
counterpart off a mesh: ROADMAP queue A, item 12.5.
"""
from __future__ import annotations

import queue
import threading
import zlib

import numpy as np
import torch

from repro_torch.core.device import resolve_device, upload


def batch_dims(cfg, shape) -> dict:
    """Each field's (shape, dtype) for one batch of ``shape`` (a
    ``ShapeSpec``): the decoder's tokens, labels and loss mask, behind the
    encoder's frames (half the length, at most ``enc_len``) or the vision
    stub's patches."""
    b, s = shape.global_batch, shape.seq_len
    dims = {}
    if cfg.encdec:
        dims["frames"] = ((b, min(cfg.enc_len, s // 2), cfg.d_model), torch.bfloat16)
        s = s // 2 if shape.kind == "train" else s
    elif cfg.vision_stub:
        dims["patches"] = ((b, cfg.n_patches, cfg.d_model), torch.bfloat16)
        s = max(8, s - cfg.n_patches)
    dims["tokens"] = ((b, s), torch.int32)
    dims["labels"] = ((b, s), torch.int32)
    dims["loss_mask"] = ((b, s), torch.float32)
    return dims


def shard_key(name: str, seed: int, step: int, index) -> int:
    """The generator key of one field's shard: a stable digest of (name,
    seed, step, shard index), the same in every process."""
    return zlib.crc32(repr((name, seed, step, str(index))).encode()) % (2**31)


def gen_shard(shp, dtype, key: int) -> np.ndarray:
    """One shard's numbers from ``np.random.default_rng(key)``: int32 ids
    in [0, 1024), f32 ones (the loss mask), else f32 standard normal."""
    rng = np.random.default_rng(key)
    if dtype == torch.int32:
        return rng.integers(0, 1024, shp, dtype=np.int32)
    if dtype == torch.float32:
        return np.ones(shp, np.float32)
    return rng.standard_normal(shp).astype(np.float32)


def host_batch(cfg, shape, *, step: int = 0, seed: int = 0, key=shard_key) -> dict:
    """One batch as numpy arrays (token ids already modulo the vocab; the
    bf16 fields still f32)."""
    out = {}
    for k, (shp, dtype) in batch_dims(cfg, shape).items():
        arr = gen_shard(shp, dtype, key(k, seed, step, ()))
        out[k] = arr % cfg.vocab if k in ("tokens", "labels") else arr
    return out


def to_device(arrays: dict, cfg, shape, device) -> dict:
    """A :func:`host_batch` as tensors of its fields' dtypes on ``device``."""
    dims = batch_dims(cfg, shape)
    return {k: upload(a, device).to(dims[k][1]) for k, a in arrays.items()}


def make_batch(cfg, shape, *, step: int = 0, seed: int = 0, device=None, key=shard_key) -> dict:
    """One batch of ``shape`` for ``step`` on ``device`` (the card unless
    given).  ``key(name, seed, step, index)`` keys each field's generator."""
    return to_device(host_batch(cfg, shape, step=step, seed=seed, key=key), cfg, shape,
                     resolve_device(device))


class Prefetcher:
    """The batches of steps ``start_step``, ``start_step + 1``, ... made on
    a background thread, at most ``depth`` ahead; :meth:`next` returns
    ``(step, batch)`` with the batch on ``device``."""

    def __init__(self, cfg, shape, *, device=None, seed: int = 0, depth: int = 2,
                 start_step: int = 0):
        self._cfg, self._shape = cfg, shape
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def worker():
            step = start_step
            while not self._stop.is_set():
                arrays = host_batch(cfg, shape, step=step, seed=seed)
                while not self._stop.is_set():
                    try:
                        self._q.put((step, arrays), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                step += 1

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def next(self):
        step, arrays = self._q.get()
        return step, to_device(arrays, self._cfg, self._shape, self._device)

    def close(self) -> None:
        """Stop the thread and wait for it."""
        self._stop.set()
        self._t.join()
