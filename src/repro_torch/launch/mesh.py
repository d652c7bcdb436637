"""Mesh construction, the port of the JAX package's ``launch/mesh.py``, on
``torch.distributed.device_mesh.init_device_mesh``.

Functions, not module constants, so importing this module touches no
process group.  Each expects ``torch.distributed`` initialised with the
world it names (``init_process_group`` with a ``tcp://`` address, the world
size and the rank: nothing tells a program of its cluster).  Single pod:
16 x 16 = 256 devices (data, model); multi-pod: 2 x 16 x 16 = 512 (pod,
data, model).
"""
from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def elastic_shape(n: int, model_parallel: int = 16) -> tuple[int, int]:
    """The largest valid (data, model) split of ``n`` devices: the model axis
    the largest divisor of ``n`` up to ``model_parallel``."""
    model = min(model_parallel, n)
    while n % model:
        model -= 1
    return n // model, model


def make_elastic_mesh(*, model_parallel: int = 16, device_type: str = "cuda"):
    """The largest valid (data, model) mesh over the process group's world:
    after a restart with fewer healthy hosts the same program runs on a
    smaller data axis."""
    return init_device_mesh(device_type, elastic_shape(dist.get_world_size(), model_parallel),
                            mesh_dim_names=("data", "model"))


def pick_batch_axes(mesh, global_batch: int) -> tuple:
    """Largest batch-sharding axis group that divides the global batch (the
    mesh: a ``DeviceMesh`` or any object with ``mesh_dim_names`` and
    ``shape``)."""
    names = tuple(mesh.mesh_dim_names)
    for axes in (("pod", "data"), ("data",), ()):
        if all(a in names for a in axes):
            size = 1
            for a in axes:
                size *= int(mesh.shape[names.index(a)])
            if size and global_batch % size == 0:
                return axes
    return ()
