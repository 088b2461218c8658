"""BM4D on z-sharded volumes with a halo exchange.

Counterpart of ``exaspim_tpu/parallel/bm4d_sharded.py``: the volume's z
axis is split into one slab per rank of a mesh axis; each rank receives
``halo`` planes from each neighbour, denoises its haloed slab with
:func:`exaspim_tpu_torch.ops.bm4d.bm4d` (on the card, the fused matcher
kernel) and crops its core; the cores are gathered, so every rank
returns the whole volume.

Exactness: a two-stage BM4D output voxel depends on guide data at most
``2 · 2 · (search//2 + block − 1)`` planes away (stage 2's matching and
group members reach ``search//2 + block − 1``, doubled for the stage-1
estimate it reads, doubled again for stage 1's own matching). With a
halo at least that wide, rounded up to the reference-grid ``step`` so
every slab's grid is the global one, each core voxel gets exactly the
single-volume contributions. The end ranks fill their outer halo by
reflecting their own slab, so the result is :func:`bm4d` of the
z-reflect-extended volume (numpy's ``"reflect"``), cropped back; it equals
plain BM4D of the volume except within one stage-reach of its z ends.
"""

from __future__ import annotations

import numpy as np
import torch

from exaspim_tpu_torch.ops.bm4d import bm4d
from exaspim_tpu_torch.parallel._comm import (
    exchange_halos,
    gather_z,
    mesh_group,
)

__all__ = ["bm4d_sharded", "bm4d_halo"]


def bm4d_halo(block=4, search=9, step=3, two_stage=True):
    """Minimum exact halo (z planes), rounded up to the grid step."""
    reach = 2 * (search // 2 + block - 1)
    h = 2 * reach if two_stage else reach
    return -(-h // step) * step


def bm4d_sharded(vol, sigma, mesh, axis_name="z", block=4, group=16,
                 step=3, search=9, two_stage=True, halo=None,
                 matcher="kernel"):
    """Denoise ``vol`` (Z, Y, X) with BM4D, z-sharded over the mesh axis
    ``axis_name``; returns the whole f32 volume on every rank, on the
    rank's device.

    Z must split into one core per rank that is a multiple of ``step`` and
    taller than ``halo``. ``vol`` is the whole volume (numpy or a tensor)
    on every rank; each rank uploads only its slab. ``matcher`` is
    :func:`bm4d`'s (``"kernel"``: on the card the fused matcher kernel).
    """
    pg, n, rank, device = mesh_group(mesh, axis_name)
    Z = vol.shape[0]
    if halo is None:
        halo = bm4d_halo(block, search, step, two_stage)
    if Z % n:
        raise ValueError(f"Z={Z} not divisible by {n} shards")
    core = Z // n
    if core % step:
        raise ValueError(
            f"per-chip core {core} must be a multiple of step {step} "
            "so shard grids align with the global reference grid")
    if core <= halo:
        # The end ranks reflect-fill from slab[1 : halo + 1].
        raise ValueError(f"per-chip core {core} <= halo {halo}")
    lo = rank * core
    part = vol[lo:lo + core]
    slab = (part.to(device, torch.float32) if isinstance(part, torch.Tensor)
            else torch.from_numpy(np.asarray(part, np.float32)).to(device))
    above, below = exchange_halos(slab, halo, pg)
    if rank == 0:
        above = slab[1:halo + 1].flip(0)
    if rank == n - 1:
        below = slab[-halo - 1:-1].flip(0)
    den = bm4d(torch.cat([above, slab, below]), sigma, block=block,
               group=group, step=step, search=search, two_stage=two_stage,
               matcher=matcher, device=device)
    return gather_z(den[halo:halo + core].contiguous(), pg)
