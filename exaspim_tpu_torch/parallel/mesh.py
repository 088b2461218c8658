"""Device meshes over the process group.

Counterpart of ``exaspim_tpu/parallel/mesh.py``. A JAX mesh arranges the
devices one controller sees; here each process drives one device, and
:func:`make_mesh` returns the 1-D
:class:`torch.distributed.device_mesh.DeviceMesh` over the group's ranks,
the substrate of data-parallel training (the batch axis) and of
z-sharded inference and BM4D (the volume's z axis).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from exaspim_tpu_torch.parallel.multihost import default_backend

__all__ = ["make_mesh", "replicated", "sharded_along"]


def make_mesh(n_devices=None, axis="data", device="cuda"):
    """1-D mesh named ``axis`` over the first ``n_devices`` ranks of the
    process group (default: all of them), one device per rank, of
    ``device``'s type. A run with no process group is a world of one: a
    single-process group (``default_backend(device)``) is created for it.
    Asking for more devices than the world has raises ``ValueError``."""
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device),
                                store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n > world:
        raise ValueError(f"requested {n} devices, have {world}")
    return DeviceMesh(torch.device(device).type, torch.arange(n),
                      mesh_dim_names=(axis,))


def _placement(mesh, axis_name, placement):
    if axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh has axes {mesh.mesh_dim_names}, "
                         f"not {axis_name!r}")
    return tuple(placement if name == axis_name else _replicate()
                 for name in mesh.mesh_dim_names)


def _replicate():
    from torch.distributed.tensor import Replicate

    return Replicate()


def replicated(mesh):
    """Placements that replicate a tensor on every device of ``mesh``."""
    return tuple(_replicate() for _ in range(mesh.ndim))


def sharded_along(mesh, axis_name, dim=0, ndim=1):
    """Placements that split tensor dim ``dim`` (of ``ndim``) across the
    mesh axis ``axis_name``."""
    from torch.distributed.tensor import Shard

    if not 0 <= dim < ndim:
        raise ValueError(f"dim {dim} out of range for {ndim} dimensions")
    return _placement(mesh, axis_name, Shard(dim))
