"""Checkpointing: the JAX package's ``checkpoint/manager.py`` on one device,
in its directory format.

* ``step_K/manifest.json`` holds the step and, per leaf (named by its path
  joined with dots, ``train.tree`` order), its global shape and dtype; each
  leaf's data is ``{key}__{slice tag}.npy`` per saved shard (one device
  saves one shard, the whole array: tag ``0-n_0-m``, or ``scalar``).
* bf16 is written as JAX writes it: 2-byte words under the ``.npy``
  descriptor ``'<V2'`` (what ``np.save`` gives an ``ml_dtypes.bfloat16``
  array) with ``"dtype": "bfloat16"`` in the manifest, read and written
  through 16-bit integer views, so no bf16 numpy type is needed.
* A commit is atomic: the files go to ``step_K.tmp`` and one ``rename``
  publishes them; a crash mid-save leaves the last checkpoint intact.
* ``save_async`` copies to the host at once (an owned copy, so the tree
  may change in place meanwhile) and writes on a thread; ``wait`` joins it.  The oldest checkpoints past ``keep`` are removed.
* :meth:`CheckpointManager.restore` assembles each leaf from whatever shard
  files cover it, as the JAX package's ``load_region`` does: a checkpoint
  JAX saved from several devices restores here whole.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

from repro_torch.train import tree as tr

_BF16_DESCR = "<V2"


def _key(path) -> str:
    return ".".join(str(k) for k in path)


def _slice_tag(shape) -> str:
    return "_".join(f"0-{d}" for d in shape) if shape else "scalar"


def _host(leaf):
    """(numpy array, manifest dtype name) of a leaf: a tensor (bf16 as its
    16-bit words) or a Python int (int32, as JAX's step)."""
    if not isinstance(leaf, torch.Tensor):
        arr = np.asarray(leaf, np.int32)
        return arr, str(arr.dtype)
    # an owned copy: a CPU tensor's .cpu() is the tensor itself, which the
    # next train step updates in place while the write thread reads it
    host = leaf.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = host.numpy()
    return arr, str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ save

    def save(self, step: int, tree) -> None:
        """Save a tree of tensors and Python ints as ``step_K``."""
        self._save(step, tree, background=False)

    def save_async(self, step: int, tree) -> None:
        """:meth:`save` with the files written on a thread: the copy to the
        host is taken before it returns, so the caller may go on updating
        the tree in place."""
        self._save(step, tree, background=True)

    def _save(self, step: int, tree, *, background: bool) -> None:
        self.wait()
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest: dict = {"step": step, "leaves": {}}
        host = []
        for path, leaf in tr.leaves_with_paths(tree):
            key = _key(path)
            arr, dtype = _host(leaf)
            manifest["leaves"][key] = {"shape": list(arr.shape), "dtype": dtype}
            host.append((tmp / f"{key}__{_slice_tag(arr.shape)}.npy", arr, dtype))

        def commit():
            for f, arr, dtype in host:
                _save_npy(f, arr, dtype)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()

        if background:
            self._thread = threading.Thread(target=commit, daemon=True)
            self._thread.start()
        else:
            commit()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------ restore

    def all_steps(self) -> list[int]:
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self):
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, step, target):
        """``(tree, step)``: checkpoint ``step`` (the latest if None) in the
        structure of ``target``, each tensor leaf on its target's device in
        the saved dtype, a Python int leaf as a Python int."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        step_dir = self.dir / f"step_{step}"
        manifest = json.loads((step_dir / "manifest.json").read_text())
        files: dict[str, list] = {}
        for f in step_dir.glob("*.npy"):
            key, tag = f.stem.rsplit("__", 1)
            files.setdefault(key, []).append((tag, f))

        def leaf(path, target_leaf):
            key = _key(path)
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"leaf {key} missing from checkpoint")
            arr = _load_region(files.get(key, []), key, tuple(meta["shape"]), meta["dtype"])
            if not isinstance(target_leaf, torch.Tensor):
                return arr.item()
            t = torch.from_numpy(arr)
            if meta["dtype"] == "bfloat16":
                t = t.view(torch.bfloat16)
            return t.to(target_leaf.device)

        return tr.map_leaves(leaf, target, ()), step


def _load_region(files, key: str, shape: tuple, dtype: str) -> np.ndarray:
    """The whole array of leaf ``key`` assembled from the shard files that
    cover it (tags ``a-b_c-d``: the global slice each holds)."""
    word = np.int16 if dtype == "bfloat16" else np.dtype(dtype)
    out = None
    for tag, f in files:
        if tag == "scalar":
            return _words(np.load(f), word).copy()
        have = [tuple(map(int, part.split("-"))) for part in tag.split("_")]
        if out is None:
            out = np.empty(shape, word)
        data = _words(np.load(f, mmap_mode="r"), word)
        out[tuple(slice(a, b) for a, b in have)] = data
    if out is None:
        raise ValueError(f"no saved shard covers {key}")
    return out


def _words(arr: np.ndarray, word) -> np.ndarray:
    """A loaded array as ``word``: bf16 files (``'<V2'``) as 16-bit
    integers."""
    return arr.view(word) if arr.dtype.kind == "V" else arr
