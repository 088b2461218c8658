"""Tiled whole-volume inference: batched forward + overlap-average stitch.

Counterpart of ``exaspim_tpu/inference.py:54-484``. A volume is covered by
overlapping cubic patches (stride ``patch − overlap``); each batch of
patches goes through the model; ``trim`` voxels are dropped from patch
faces that do not touch the volume edge; the overlapping predictions are
weight-averaged with the reference's parity-canvas stitch; the frozen
transform maps back to counts.

The whole datapath runs on ``device`` (the card unless the caller passes
``device="cpu"``): the raw block is uploaded once, and only the final
counts come back to the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "predict",
    "predict_patch",
    "generate_patch_starts",
    "count_patches",
    "plan_tiling",
    "plan_stream_cores",
    "trim_weight_mask",
    "build_tiled_program",
]


def generate_patch_starts(shape, patch_size, overlap):
    """(N, 3) int32 patch starts: ``range(0, dim − patch + stride, stride)``
    per axis; trailing patches may extend past the volume (padded data)."""
    stride = patch_size - overlap
    if stride <= 0:
        raise ValueError(
            f"overlap {overlap} must be smaller than patch {patch_size}"
        )
    axes = [
        np.arange(0, max(d - patch_size + stride, 1), stride)
        for d in shape
    ]
    grid = np.meshgrid(*axes, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1).astype(np.int32)


def count_patches(shape, patch_size, overlap):
    """Number of patches in the tiling grid."""
    return len(generate_patch_starts(shape, patch_size, overlap))


def plan_tiling(shape, overlap=12, candidates=(64, 96, 128),
                target_batch_voxels=32 * 64 ** 3):
    """Pick ``(patch_size, batch_size)`` minimizing total forward voxels
    (patch sizes divisible by 16), with a batch near
    ``target_batch_voxels`` and the fewest padded tail slots."""
    best = None
    for P in candidates:
        if any(d < P for d in shape) or P <= overlap:
            continue
        stride = P - overlap
        n = int(np.prod([
            len(range(0, max(d - P + stride, 1), stride)) for d in shape
        ]))
        total = n * P ** 3
        if best is None or total < best[0]:
            best = (total, P, n)
    if best is None:  # volume smaller than every candidate
        P = min(shape) // 16 * 16
        if P < 16 or P <= overlap:
            raise ValueError(
                f"volume {tuple(shape)} too small for auto tiling "
                f"(needs every dim ≥ 16 and a 16-multiple patch "
                f"> overlap {overlap})"
            )
        return P, 1
    _, P, n = best
    target_b = max(1, min(n, round(target_batch_voxels / P ** 3)))
    batch = min(
        range(max(1, target_b // 2), target_b + 1),
        key=lambda b: ((-n) % b, -b),
    )
    return P, batch


def trim_weight_mask(global_start, patch, trim, global_shape, device="cuda"):
    """(P, P, P) f32 stitch weight: 0 on trimmed faces, 1 elsewhere. Faces
    touching the volume boundary are not trimmed."""
    P = patch
    idx = torch.arange(P, device=device)
    w = torch.ones((P, P, P), dtype=torch.float32, device=device)
    for d in range(3):
        lo_ok = (idx >= trim) | (int(global_start[d]) == 0)
        hi_ok = (idx < P - trim) | (
            int(global_start[d]) + P >= global_shape[d])
        keep = (lo_ok & hi_ok).float()
        shape = [1, 1, 1]
        shape[d] = P
        w = w * keep.reshape(shape)
    return w


def _parity_canvas(blocks, grid_dims, stride, patch, vol_shape):
    """Dense overlap-add of a uniform patch grid (``start = index·stride``).

    Patches at equal grid parities are disjoint when ``patch ≤ 2·stride``,
    so the sum splits into 8 parity groups, each laid out by pad /
    permute / reshape and added at a static shift — the reference's
    algorithm and summation order (``inference.py:194``).
    """
    nz, ny, nx = grid_dims
    P, s = patch, stride
    if P > 2 * s:
        raise ValueError(
            f"patch {P} > 2×stride {s}: parity decomposition needs "
            "overlap ≤ stride"
        )
    blocks = blocks.reshape(nz, ny, nx, P, P, P)
    out = torch.zeros(vol_shape, dtype=blocks.dtype, device=blocks.device)
    for a in range(min(2, nz)):
        for b in range(min(2, ny)):
            for c in range(min(2, nx)):
                sub = blocks[a::2, b::2, c::2]
                mz, my, mx = sub.shape[:3]
                sub = F.pad(sub, [0, 2 * s - P] * 3)
                canvas = sub.permute(0, 3, 1, 4, 2, 5).reshape(
                    mz * 2 * s, my * 2 * s, mx * 2 * s
                )
                off = (a * s, b * s, c * s)
                lim = [min(o + e, v) for o, e, v in
                       zip(off, canvas.shape, vol_shape)]
                region = tuple(slice(o, m) for o, m in zip(off, lim))
                crop = tuple(slice(0, m - o) for o, m in zip(off, lim))
                out[region] += canvas[crop]
    return out


def build_tiled_program(model, transform, shape, patch_size=64, overlap=12,
                        trim=5, batch_size=32, return_float=False):
    """The tiled engine for a block of ``shape``.

    Returns ``(program, starts)``: ``program(raw, starts)`` denoises one
    block ``raw`` (a float32 tensor of raw counts on the model's device) and
    ``starts`` is the tail-padded ``(n, 3)`` patch-origin array (the tail
    repeats the last start so every batch is full).
    """
    shape = tuple(int(d) for d in shape)
    starts = generate_patch_starts(shape, patch_size, overlap)
    stride = patch_size - overlap
    grid_dims = tuple(
        len(range(0, max(d - patch_size + stride, 1), stride)) for d in shape
    )
    n_grid = len(starts)
    padded = tuple(
        max(int(starts[:, d].max()) + patch_size, shape[d]) for d in range(3)
    )
    n_pad = (-len(starts)) % batch_size
    if n_pad:
        starts = np.concatenate([starts, np.repeat(starts[-1:], n_pad, 0)])
    P = patch_size

    def program(raw, starts):
        x = transform.forward(raw)
        x = F.pad(x, [0, padded[2] - shape[2], 0, padded[1] - shape[1],
                      0, padded[0] - shape[0]])
        preds, masks = [], []
        for i in range(0, len(starts), batch_size):
            sb = starts[i:i + batch_size]
            patches = torch.stack([
                x[z:z + P, y:y + P, w:w + P] for z, y, w in sb.tolist()
            ])
            pred = model(patches[..., None])[..., 0].float()
            mask = torch.stack([
                trim_weight_mask(st, P, trim, shape, x.device) for st in sb
            ])
            preds.append(pred * mask)
            masks.append(mask)
        preds = torch.cat(preds)[:n_grid]
        masks = torch.cat(masks)[:n_grid]
        accum = _parity_canvas(preds, grid_dims, stride, P, padded)
        wgt = _parity_canvas(masks, grid_dims, stride, P, padded)
        out = (accum / (wgt + 1e-8))[:shape[0], :shape[1], :shape[2]]
        if return_float:
            return transform.inverse_float(out)
        return transform.inverse(out)

    return program, starts


def _check(img, patch_size, overlap, trim):
    if any(d < patch_size for d in img.shape):
        raise ValueError(
            f"volume {img.shape} smaller than patch {patch_size}; "
            "use predict_patch or a smaller patch_size"
        )
    if overlap < 2 * trim:
        raise ValueError(
            f"overlap {overlap} must be >= 2*trim ({2 * trim}) for "
            "gap-free stitching"
        )


def predict(img, model, transform, patch_size=64, overlap=12, trim=5,
            batch_size=32, max_device_voxels=640 ** 3, return_float=False,
            device="cuda"):
    """Denoise a whole volume; returns numpy uint16 counts (or float32
    counts with ``return_float``).

    ``img`` is a 3-D (or squeezable 5-D) uint16/float volume of raw counts.
    ``patch_size="auto"`` lets :func:`plan_tiling` choose patch and batch.
    ``model`` must already live on ``device``. Volumes above
    ``max_device_voxels`` stream through halo'd super-tiles.
    """
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    if img.ndim != 3:
        raise ValueError(f"expected 3D volume, got {img.shape}")
    if patch_size == "auto":
        patch_size, batch_size = plan_tiling(img.shape, overlap)
    _check(img, patch_size, overlap, trim)
    if int(np.prod(img.shape)) > max_device_voxels:
        return _predict_streaming(
            img, model, transform, patch_size, overlap, trim, batch_size,
            max_device_voxels, return_float, device,
        )
    program, starts = build_tiled_program(
        model, transform, img.shape, patch_size, overlap, trim, batch_size,
        return_float=return_float,
    )
    raw = torch.from_numpy(np.asarray(img, dtype=np.float32)).to(device)
    with torch.inference_mode():
        out = program(raw, starts)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


def plan_stream_cores(shape, patch_size, overlap, max_device_voxels):
    """Per-axis core sizes for halo'd super-tile streaming: full axes
    first; when too big, shrink z, then y, then x in stride decrements."""
    halo = patch_size
    stride = patch_size - overlap

    def ext(core, dim):
        return dim if core >= dim else min(dim, core + 2 * halo + stride)

    cores = list(shape)
    for ax in range(3):
        while (
            ext(cores[0], shape[0]) * ext(cores[1], shape[1])
            * ext(cores[2], shape[2]) > max_device_voxels
            and cores[ax] > patch_size
        ):
            cores[ax] = max(patch_size, cores[ax] - stride)
    return tuple(cores)


def _predict_streaming(img, model, transform, patch_size, overlap, trim,
                       batch_size, max_device_voxels, return_float, device):
    """Denoise super-tiles with a ``patch_size`` halo, each aligned to the
    global stride grid, so every core voxel sees the single-pass context."""
    halo = patch_size
    stride = patch_size - overlap
    zyx = img.shape
    cores = plan_stream_cores(zyx, patch_size, overlap, max_device_voxels)
    out = np.empty(zyx, dtype=np.float32 if return_float else np.uint16)
    for z0 in range(0, zyx[0], cores[0]):
        for y0 in range(0, zyx[1], cores[1]):
            for x0 in range(0, zyx[2], cores[2]):
                core_sl, res_sl, blk_sl = [], [], []
                for d0, core, dim in zip((z0, y0, x0), cores, zyx):
                    d1 = min(d0 + core, dim)
                    lo = max(d0 - halo, 0)
                    lo -= lo % stride
                    hi = min(d1 + halo, dim)
                    core_sl.append(slice(d0, d1))
                    res_sl.append(slice(d0 - lo, d0 - lo + (d1 - d0)))
                    blk_sl.append(slice(lo, hi))
                res = predict(
                    img[tuple(blk_sl)], model, transform, patch_size,
                    overlap, trim, batch_size, max_device_voxels=2 ** 63,
                    return_float=return_float, device=device,
                )
                out[tuple(core_sl)] = res[tuple(res_sl)]
    return out


def predict_patch(patch, model, transform, device="cuda"):
    """Denoise a single patch; returns numpy uint16 counts."""
    x = transform.forward(
        torch.from_numpy(np.asarray(patch, dtype=np.float32)).to(device))
    with torch.inference_mode():
        pred = model(x[None, ..., None])[0, ..., 0].float()
    return transform.inverse(pred)
