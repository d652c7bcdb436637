"""Placements for decode state: the port of the JAX package's
``dist/state_specs.py``, with ``torch.distributed.tensor`` placements in
place of ``PartitionSpec``s.

The roles are JAX's, field for field:

  * batch dims shard over the largest ("pod", "data") group that divides
    the global batch (``launch.mesh.pick_batch_axes``);
  * the KV-head dim of caches shards over "model";
  * with ``seq_ax`` (long-context small-batch shapes), the packed-block axis
    of a dense cache and the page table's columns shard along it: the
    layout of a split-KV walk (``dist.splitkv``);
  * ``page_affine`` (paged only) shards the pools' page dim along ``seq_ax``
    too: the page-affine allocator's contract (``serve/pages.py`` with
    ``shards`` the axis size).

A field's placement is a tuple with one entry per mesh dim: ``Shard(d)``
where that mesh dim splits the field's dim ``d``, ``Replicate()`` else.
Stacked layer dims stay replicated; an axis that does not divide a dim is
dropped (the field stays replicated there), as in JAX.  Leaves that are not
cache fields shard their batch dim, the first dim equal to the global batch.

What the port puts at rest along an axis: the serving engine keeps its
state replicated on every rank and splits only the block walk, and under
``page_affine`` the pools' pages (:func:`local_pools` cuts a rank's range).

The mesh may be a ``DeviceMesh`` or any object with ``mesh_dim_names`` and
``shape`` (planning needs no process group).
"""
from __future__ import annotations

import dataclasses
import math

from torch.distributed.tensor import Replicate, Shard

from repro_torch.core.qcache import _PAGED_POOL_FIELDS, PagedQuantKVCache, QuantKVCache

# field -> (base rank without stacking dims, {base-dim index: role})
_CACHE_FIELD_ROLES = {
    "kw": (5, {0: "batch", 1: "heads", 2: "blocks"}),
    "k_scale": (4, {0: "batch", 1: "heads", 2: "blocks"}),
    "k_zero": (4, {0: "batch", 1: "heads", 2: "blocks"}),
    "vw": (5, {0: "batch", 1: "heads", 2: "blocks"}),
    "v_scale": (4, {0: "batch", 1: "heads", 2: "blocks"}),
    "v_zero": (4, {0: "batch", 1: "heads", 2: "blocks"}),
    "k_res": (4, {0: "batch", 1: "heads"}),
    "v_res": (4, {0: "batch", 1: "heads"}),
    "pack_blocks": (1, {0: "batch"}),
    "res_len": (1, {0: "batch"}),
    "arrive": (1, {0: "batch"}),
}

# paged: the pools replicate their page dim and shard KV heads; the table's
# columns carry the "blocks" role
_PAGED_FIELD_ROLES = {
    "kw": (4, {1: "heads"}),
    "k_scale": (3, {1: "heads"}),
    "k_zero": (3, {1: "heads"}),
    "vw": (4, {1: "heads"}),
    "v_scale": (3, {1: "heads"}),
    "v_zero": (3, {1: "heads"}),
    "k_res": (4, {0: "batch", 1: "heads"}),
    "v_res": (4, {0: "batch", 1: "heads"}),
    "page_table": (2, {0: "batch", 1: "blocks"}),
    "pack_blocks": (1, {0: "batch"}),
    "res_len": (1, {0: "batch"}),
    "arrive": (1, {0: "batch"}),
}

# page-affine: the pools' page dim shards along seq_ax as well
_PAGED_AFFINE_FIELD_ROLES = {
    **_PAGED_FIELD_ROLES,
    **{f: (r, {0: "pages", 1: "heads"}) for f, (r, _) in _PAGED_FIELD_ROLES.items()
       if f in _PAGED_POOL_FIELDS},
}


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[tuple(mesh.mesh_dim_names).index(name)])


def _batch_axes(mesh, global_batch: int) -> tuple:
    """Largest batch-sharding axis group that divides the global batch."""
    names = tuple(mesh.mesh_dim_names)
    for axes in (("pod", "data"), ("data",), ()):
        if all(a in names for a in axes):
            size = math.prod(_axis_size(mesh, a) for a in axes)
            if size and global_batch % size == 0:
                return axes
    return ()


def _entry(names, mesh, dim: int):
    """The axes of ``names`` that shard a dim of size ``dim``: None, one name
    or a tuple (JAX's PartitionSpec entry)."""
    names = tuple(n for n in names if n in mesh.mesh_dim_names and _axis_size(mesh, n) > 1)
    if not names or dim % math.prod(_axis_size(mesh, n) for n in names):
        return None
    return names if len(names) > 1 else names[0]


def to_placements(spec: tuple, mesh) -> tuple:
    """A PartitionSpec-like tuple (one entry a tensor dim: None, an axis name
    or a tuple of them) as placements, one a mesh dim."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def _cache_specs(c, mesh, batch_axes, seq_ax, page_affine=False):
    role_axes = {
        "batch": batch_axes,
        "heads": ("model",),
        "blocks": (seq_ax,) if seq_ax else (),
        "pages": (seq_ax,) if seq_ax else (),
    }
    if isinstance(c, PagedQuantKVCache):
        roles_table = _PAGED_AFFINE_FIELD_ROLES if page_affine else _PAGED_FIELD_ROLES
    else:
        roles_table = _CACHE_FIELD_ROLES

    def field_spec(name: str, arr):
        if arr is None:
            return None
        base_rank, roles = roles_table[name]
        lead = arr.dim() - base_rank  # stacked layer dims stay replicated
        parts = [None] * arr.dim()
        used: set = set()  # a mesh axis splits one dim of a tensor at most
        for i, role in sorted(roles.items()):
            e = _entry(role_axes[role], mesh, arr.shape[lead + i])
            names = e if isinstance(e, tuple) else (e,) if e else ()
            if any(n in used for n in names):
                continue  # an earlier dim claimed the axis: replicated here
            used.update(names)
            parts[lead + i] = e
        return to_placements(tuple(parts), mesh)

    return dataclasses.replace(c, **{name: field_spec(name, getattr(c, name))
                                     for name in roles_table})


def decode_state_specs(model, mesh, *, global_batch: int, seq_ax: str | None = None,
                       paged: bool = False, n_pages: int | None = None,
                       nb_max: int | None = None, page_affine: bool = False):
    """Placements matching ``model.init_decode_state``'s structure (or
    ``model.init_paged_decode_state``'s when ``paged``): each cache a copy
    of its dataclass whose tensor fields hold placement tuples, every other
    tensor a placement tuple.  The state is probed on the meta device at
    ``nb_max`` blocks (default 4) and ``n_pages`` pages (default
    ``global_batch * (nb_max + 1)``): placement drops an axis that does not
    divide the probed dim, so callers whose real state differs must pass
    them, as in JAX."""
    cfg = model.cfg
    batch_axes = _batch_axes(mesh, global_batch)
    nb_max = 4 if nb_max is None else nb_max
    if paged:
        np_ = n_pages if n_pages is not None else global_batch * (nb_max + 1)
        state = model.init_paged_decode_state(global_batch, n_pages=np_, nb_max=nb_max,
                                              device="meta")
    else:
        state = model.init_decode_state(global_batch, nb_max * getattr(cfg, "kv_block", 128),
                                        device="meta")

    def generic(arr):
        parts = [None] * arr.dim()
        if batch_axes:
            for i, d in enumerate(arr.shape):
                if d == global_batch:
                    parts[i] = _entry(batch_axes, mesh, d)
                    break
        return to_placements(tuple(parts), mesh)

    def node(x):
        if isinstance(x, (QuantKVCache, PagedQuantKVCache)):
            return _cache_specs(x, mesh, batch_axes, seq_ax, page_affine)
        if isinstance(x, dict):
            return {k: node(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(node(v) for v in x)
        return generic(x)

    return node(state)


def local_pools(state: dict, specs: dict, mesh, axis: str, rank: int | None = None) -> dict:
    """This rank's state under page-affine placements: every pool field whose
    placement shards it along mesh axis ``axis`` cut to the rank's range
    (a contiguous copy), and the cache told which pages it holds
    (``PagedQuantKVCache.page_lo`` / ``pages_total``).  Every other tensor
    is the same object.  ``rank``: this rank's coordinate on ``axis``
    (default: the mesh's)."""
    names = tuple(mesh.mesh_dim_names)
    ax = names.index(axis)
    n = _axis_size(mesh, axis)
    r = mesh.get_local_rank(axis) if rank is None else rank
    caches = []
    for cache, spec in zip(state["caches"], specs["caches"]):
        cut = {}
        for f in _PAGED_POOL_FIELDS:
            t, place = getattr(cache, f, None), getattr(spec, f, None)
            if t is None or place is None or not isinstance(place[ax], Shard):
                continue
            cut[f] = t.chunk(n, place[ax].dim)[r].contiguous()
        if cut:
            per = cache.n_pages // n
            cache = dataclasses.replace(cache, **cut, page_lo=r * per,
                                        pages_total=cache.n_pages)
        caches.append(cache)
    return {**state, "caches": caches}
