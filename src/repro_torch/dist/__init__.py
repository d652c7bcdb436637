"""Distributed layer of the port: the cross-device split-KV decode path and
decode-state placement on ``torch.distributed``.

Modules, each against its JAX counterpart:
  * :mod:`repro_torch.dist.splitkv` (``repro/dist/splitkv.py``): each rank
    walks its window of the dense cache's blocks or of the page table's
    columns (and, page-affine, only its own pages) through the decode
    kernels, and the ranks' partials merge across the mesh axis: one
    ``all_gather_into_tensor`` and the port's split merge;
  * :mod:`repro_torch.dist.state_specs` (``repro/dist/state_specs.py``):
    the per-field roles of the decode state as ``Shard`` / ``Replicate``
    placements on the named mesh dims, and the cut of a rank's page-affine
    pools;
  * ``repro_torch.launch.mesh`` (``repro/launch/mesh.py``): the meshes, on
    ``init_device_mesh``.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``: its
``mesh_dim_names`` are JAX's ``axis_names``, and ``mesh.get_group(axis)``
carries the collective.  Not ported here: ``repro/dist/sharding.py`` (the
logical-axis rules and ``constrain``), which only the training step, the
dry run and the models' model-axis constraints use (ROADMAP queue A, item
12, with training).
"""
