"""Spatially-sharded whole-volume inference with a z-halo exchange.

Counterpart of ``exaspim_tpu/parallel/spatial.py``. The volume's z axis
is split into one slab per rank of a 1-D mesh; each rank receives the
``patch`` planes next to its slab from each neighbour (zeros at the ends
of the volume, as ``ppermute`` gives and as the single-device path pads),
runs the tiled engine over its haloed slab with trim masks taken in
global coordinates, and crops its core. The cores are then gathered and
mapped back to counts, so every rank returns the whole volume, as the
JAX package's multi-controller path does.

Exactness: each rank evaluates every patch of the global grid that
touches its core, and no other, with the full patch context, and each
core voxel adds its (prediction, weight) terms in the single-device
order: the parity canvas over the shard's grid rows adds its groups in
the global grid's parity order (``patch ≤ 2·stride``), and
:func:`~exaspim_tpu_torch.inference.tiled_accumulate` adds patches one by
one in global start order otherwise. Ranks may evaluate different
numbers of patches (no SPMD program to keep equal), so the JAX package's
virtual rows and repeated patches are not needed. Where the model's output for a patch does not depend on the
rest of its batch (the card's conv kernel, PR 5), the sharded output is
bit-equal to one :func:`~exaspim_tpu_torch.inference.predict`.

Under NCCL the halo planes move device to device; under gloo they are
staged through the host (:mod:`~exaspim_tpu_torch.parallel._comm`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from exaspim_tpu_torch.inference import (
    _parity_canvas,
    _patch_batches,
    generate_patch_starts,
    plan_tiling,
    tiled_accumulate,
)
from exaspim_tpu_torch.parallel._comm import (
    exchange_halos,
    gather_z,
    mesh_group,
)

__all__ = ["predict_sharded", "plan_shards"]


def _core(z_dim, n_shards, patch_size):
    if z_dim % n_shards:
        raise ValueError(f"z={z_dim} not divisible by {n_shards} shards")
    core = z_dim // n_shards
    if core < patch_size:
        raise ValueError(
            f"per-chip slab {core} smaller than patch {patch_size}")
    return core


def _shard_starts(z_dim, n_shards, patch_size, overlap, global_shape):
    """Per shard, the global grid's patch starts that touch its core, in
    global start order, as ``(local, global)`` arrays; local z is relative
    to the haloed slab ``[core_lo − halo, core_hi + halo)``."""
    halo = patch_size
    core = _core(z_dim, n_shards, patch_size)
    starts = generate_patch_starts(global_shape, patch_size, overlap)
    shards = []
    for s in range(n_shards):
        lo, hi = s * core, (s + 1) * core
        g = starts[(starts[:, 0] + patch_size > lo) & (starts[:, 0] < hi)]
        loc = g.copy()
        loc[:, 0] -= lo - halo
        shards.append((loc, g))
    return shards


def plan_shards(z_dim, n_shards, patch_size, overlap, global_shape):
    """Host-side plan: per-shard local / global patch starts, padded to
    equal counts by repeating each shard's last start (the JAX package's
    SPMD layout). Returns ``(local_starts, global_starts, n_max)``, both
    ``(n_shards, n_max, 3)`` int32; local z is relative to the haloed slab.
    :func:`predict_sharded` itself runs each shard's unpadded list."""
    shards = _shard_starts(z_dim, n_shards, patch_size, overlap,
                           global_shape)
    n_max = max(len(g) for _, g in shards)
    out_l = np.zeros((n_shards, n_max, 3), np.int32)
    out_g = np.zeros((n_shards, n_max, 3), np.int32)
    for s, (loc, g) in enumerate(shards):
        out_l[s, :len(g)], out_g[s, :len(g)] = loc, g
        out_l[s, len(g):], out_g[s, len(g):] = loc[-1], g[-1]
    return out_l, out_g, n_max


def _canvas_rows(z_dim, n_shards, patch_size, overlap):
    """Per shard, the first and last z row ``(k0, k1)`` of the global
    patch grid (``start = k · stride``) that touch its core: the rows its
    parity canvas evaluates. Unlike the JAX package's SPMD plan
    (``exaspim_tpu/parallel/spatial.py:200``), shards need not share one
    grid size, so no shard evaluates rows outside the global grid."""
    stride = patch_size - overlap
    core = _core(z_dim, n_shards, patch_size)
    last = (max(z_dim - patch_size + stride, 1) - 1) // stride
    rows = []
    for s in range(n_shards):
        lo, hi = s * core, (s + 1) * core
        k0 = max(0, -((lo - patch_size + 1) // -stride))  # k·s > lo − P
        rows.append((k0, min((hi - 1) // stride, last)))  # k·s < hi
    return rows


def _haloed(slab, halo, group):
    """The slab with its neighbours' ``halo`` planes on both z sides (zeros
    at the volume's ends)."""
    above, below = exchange_halos(slab, halo, group)
    return torch.cat([above, slab, below])


def predict_sharded(img, model, transform, mesh, patch_size=64, overlap=12,
                    trim=5, batch_size=8, return_float=False):
    """Denoise a volume sharded along z over ``mesh``'s one axis; every
    rank returns the whole result (numpy uint16 counts, or float32 with
    ``return_float``).

    ``img`` is the whole 3-D raw-count volume on every rank (each rank
    uploads only its slab); its z extent must divide into one core per
    rank of at least ``patch_size`` planes. ``model`` lives on the rank's
    device (the mesh's: the current CUDA device, or the CPU).
    ``patch_size="auto"`` plans on the per-rank slab.
    """
    img = np.asarray(img)
    if img.ndim != 3:
        raise ValueError(f"expected 3D volume, got {img.shape}")
    group, n, rank, device = mesh_group(mesh)
    Z, Y, X = img.shape
    if patch_size == "auto":
        patch_size, batch_size = plan_tiling((max(Z // n, 1), Y, X),
                                             overlap)
    if overlap < 2 * trim:
        raise ValueError(
            f"overlap {overlap} must be >= 2*trim ({2 * trim}) for "
            "gap-free stitching")
    P, halo, stride = patch_size, patch_size, patch_size - overlap
    core = _core(Z, n, P)
    lo = rank * core
    raw = torch.from_numpy(
        np.asarray(img[lo:lo + core], dtype=np.float32)).to(device)
    with torch.inference_mode():
        slab = transform.forward(raw)
        if P <= 2 * stride:
            # This shard's rows of the global grid over the haloed slab
            # (which starts at global z lo − halo), full y/x rows; the
            # canvas starts at global z k0 · stride.
            k0, k1 = _canvas_rows(Z, n, P, overlap)[rank]
            y_grid = np.arange(0, max(Y - P + stride, 1), stride)
            x_grid = np.arange(0, max(X - P + stride, 1), stride)
            grid_dims = (k1 - k0 + 1, len(y_grid), len(x_grid))
            canvas = ((k1 - k0) * stride + P, int(y_grid[-1]) + P,
                      int(x_grid[-1]) + P)
            slab = F.pad(slab, [0, canvas[2] - X, 0, canvas[1] - Y])
            glob = np.stack(np.meshgrid(np.arange(k0, k1 + 1) * stride,
                                        y_grid, x_grid, indexing="ij"),
                            axis=-1).reshape(-1, 3).astype(np.int32)
            local = glob - np.int32([lo - halo, 0, 0])
            preds, masks = [], []
            for _, pred, mask in _patch_batches(
                    model, _haloed(slab, halo, group), local, glob,
                    img.shape, P, batch_size, trim):
                preds.append(pred)
                masks.append(mask)
            ccs = lo - k0 * stride
            accum = _parity_canvas(torch.cat(preds), grid_dims, stride, P,
                                   canvas, k0 % 2)[ccs:ccs + core]
            wgt = _parity_canvas(torch.cat(masks), grid_dims, stride, P,
                                 canvas, k0 % 2)[ccs:ccs + core]
        else:
            shards = _shard_starts(Z, n, P, overlap, img.shape)
            top = np.concatenate([g for _, g in shards]).max(axis=0)
            slab = F.pad(slab, [0, max(int(top[2]) + P - X, 0),
                                0, max(int(top[1]) + P - Y, 0)])
            local, glob = shards[rank]
            accum, wgt = tiled_accumulate(
                model, _haloed(slab, halo, group), local, glob, img.shape,
                P, batch_size, trim)
            accum, wgt = accum[halo:halo + core], wgt[halo:halo + core]
        # The cores are gathered in the model's domain and every rank maps
        # the whole volume back to counts, as the JAX package does after
        # its all-gather: the inverse then runs on the tensor one predict
        # maps (on the CPU torch's vectorized sinh and its scalar tail
        # differ by an ulp, so cores mapped apart would not be bit-equal).
        out = gather_z((accum / (wgt + 1e-8))[:, :Y, :X], group)
        out = (transform.inverse_float(out) if return_float
               else transform.inverse_counts(out)).cpu().numpy()
    return out if return_float else out.astype(np.uint16)
