"""The learner's device mesh over ``torch.distributed``.

Port of ``r2d2_tpu/parallel/mesh.py``.  The JAX package runs one GSPMD
program over a 3-axis mesh of devices; PyTorch runs one process (a rank)
per device, so the port's mesh is a ``DeviceMesh`` over the ranks of the
default process group, with the same three axes in the same order:

- ``dp``   — data parallelism (batch rows, replay ring slabs, gradient
  reductions),
- ``fsdp`` — parameter and optimizer-moment sharding for memory,
- ``tp``   — tensor parallelism for the LSTM 4H kernels and dense output
  dims.

Which tensor goes where is decided by the sharding table
(:mod:`r2d2_tpu_torch.parallel.sharding`), not here.  An empty
``cfg.mesh_shape`` puts the whole world on ``dp``; omitted axes have size
1, and the mesh always carries all three axes so table entries resolve the
same way at every size.  Every rank must hold a mesh position: a shape
that needs more ranks than the world has raises, and so does one that
leaves ranks out (JAX can leave devices idle; a rank outside the mesh
would issue no collective its peers wait on).
"""
from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from r2d2_tpu_torch.config import MESH_AXES, Config, validate_mesh_shape

# the canonical learner mesh axes, in layout order (config.py holds them so
# Config validation needs no distributed import)
AXES = MESH_AXES


def mesh_sizes(cfg: Config, world_size: int) -> dict:
    """``{axis: size}`` of the mesh ``cfg.mesh_shape`` asks for over
    ``world_size`` ranks — the arithmetic of :func:`make_mesh`, with no
    process group.  Raises when the shape does not cover the world
    exactly."""
    sizes = validate_mesh_shape(cfg.mesh_shape)
    if not cfg.mesh_shape:
        sizes["dp"] = world_size
    resolved = {name: sizes[name] or 1 for name in AXES}
    need = math.prod(resolved.values())
    if need > world_size:
        raise ValueError(f"mesh_shape {cfg.mesh_shape} needs {need} ranks, "
                         f"the world has {world_size}")
    if need < world_size:
        raise ValueError(
            f"mesh_shape {cfg.mesh_shape} covers {need} of the world's "
            f"{world_size} ranks; every rank must hold a mesh position")
    return resolved


def make_mesh(cfg: Config, device_type: str = "cuda") -> DeviceMesh:
    """The 3-axis learner mesh over the default process group's ranks
    (``init_distributed`` or ``torch.distributed.init_process_group`` ran
    first), on ``device_type`` ("cuda" with NCCL, "cpu" with gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: call parallel.distributed."
            "init_distributed() (or torch.distributed.init_process_group) "
            "first")
    sizes = mesh_sizes(cfg, dist.get_world_size())
    return init_device_mesh(device_type, tuple(sizes[a] for a in AXES),
                            mesh_dim_names=AXES)


def trivial_mesh(device_type: str = "cuda") -> DeviceMesh:
    """A 1×1×1 mesh of this rank alone.  In a world of one rank it is
    :func:`make_mesh`'s mesh; in a larger world it has no process groups
    of its own (a group would need every rank's call), which a mesh of
    size 1 never uses: no placement on it moves data."""
    if not dist.is_initialized():
        raise RuntimeError("trivial_mesh needs a process group")
    if dist.get_world_size() == 1:
        return init_device_mesh(device_type, (1, 1, 1), mesh_dim_names=AXES)
    import torch

    rank = dist.get_rank()
    return DeviceMesh(device_type, torch.tensor([[[rank]]]),
                      mesh_dim_names=AXES, _init_backend=False)


def axis_sizes(mesh: DeviceMesh) -> dict:
    """``{axis: size}`` of a learner mesh."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
