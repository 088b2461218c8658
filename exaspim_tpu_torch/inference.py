"""Tiled whole-volume inference: batched forward + overlap-average stitch.

Counterpart of ``exaspim_tpu/inference.py:54-484``. A volume is covered by
overlapping cubic patches (stride ``patch − overlap``); each batch of
patches goes through the model; ``trim`` voxels are dropped from patch
faces that do not touch the volume edge; the overlapping predictions are
weight-averaged with the reference's parity-canvas stitch; the frozen
transform maps back to counts. Where ``patch > 2·stride`` the parity
decomposition does not hold, and the patches are added one by one in
start order instead (:func:`tiled_accumulate`, the stitch of the JAX
package's sharded path; its single-device ``predict`` refuses such
geometries).

The whole datapath runs on ``device`` (the card unless the caller passes
``device="cpu"``). A uint16 block crosses the bus in its own dtype: it is
staged in page-locked host memory, uploaded as its int16 bits and widened
to float32 on the device; the counts are quantised there, cropped to the
core the caller keeps and come back as 16 bits into page-locked memory.
A block of any other dtype is cast to float32 on the host, and float
output (``return_float``) comes back as float32. The counters
``predict.staged_u16`` / ``predict.staged_host`` (blocks uploaded as uint16
/ cast on the host) and ``predict.bus_bytes`` (bytes copied to and from the
device) count every block.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from exaspim_tpu_torch.data.loader import counts_f32, to_tensor
from exaspim_tpu_torch.utils.profiling import span

__all__ = [
    "predict",
    "predict_patch",
    "generate_patch_starts",
    "count_patches",
    "plan_tiling",
    "plan_stream_cores",
    "trim_weight_mask",
    "tiled_accumulate",
    "build_tiled_program",
    "build_volume_transform",
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


def _pad_starts(starts, batch):
    """``starts`` tail-padded to whole batches by repeating its last row."""
    n_pad = (-len(starts)) % batch
    if n_pad:
        starts = np.concatenate([starts, np.repeat(starts[-1:], n_pad, 0)])
    return starts


def _patch_batches(model, x, starts, global_starts, global_shape, patch,
                   batch, trim, clip=None):
    """Forward the patches of ``x`` at ``starts`` in batches of ``batch``
    (the last one filled by repeating the final start; the repeats are
    dropped). Yields, per batch, ``(starts, pred · mask, mask)`` in f32,
    with the trim masks taken at ``global_starts`` in the whole volume of
    ``global_shape`` and each prediction clamped to ``clip`` (``(lo,
    hi)``) when given."""
    P = patch
    n = len(starts)
    starts = _pad_starts(np.asarray(starts), batch)
    global_starts = _pad_starts(np.asarray(global_starts), batch)
    for i in range(0, len(starts), batch):
        sb = starts[i:i + batch]
        with span("inference.forward"):
            patches = torch.stack([
                x[z:z + P, y:y + P, w:w + P] for z, y, w in sb.tolist()
            ])
            pred = model(patches[..., None])[..., 0].float()
            if clip is not None:
                pred = torch.clamp(pred, *clip)
            mask = torch.stack([
                trim_weight_mask(g, P, trim, global_shape, x.device)
                for g in global_starts[i:i + batch]
            ])
        keep = min(batch, n - i)
        yield sb[:keep], (pred * mask)[:keep], mask[:keep]


def tiled_accumulate(model, vol, starts, global_starts, global_shape, patch,
                     batch, trim, clip=None):
    """Masked overlap-add of the patches at ``starts``: f32 ``(accum, wgt)``
    shaped like ``vol``.

    Counterpart of ``exaspim_tpu/inference.py:144``, for any geometry
    (``patch > 2·stride`` included). ``starts`` index ``vol`` (local
    coordinates); ``global_starts`` are the same patches in the whole
    volume of ``global_shape``, for the boundary-aware trim. The patches
    are added one by one in the order of ``starts``, so each voxel sums its
    contributions in a fixed order: a shard that walks the patches over
    its core in global start order reproduces the single-device sums bit
    for bit (no float atomics).
    """
    accum = torch.zeros(vol.shape, dtype=torch.float32, device=vol.device)
    wgt = torch.zeros_like(accum)
    P = patch
    for sb, pred, mask in _patch_batches(model, vol, starts, global_starts,
                                         global_shape, patch, batch, trim,
                                         clip):
        with span("inference.stitch"):
            for (z, y, x), p, m in zip(sb.tolist(), pred, mask):
                accum[z:z + P, y:y + P, x:x + P] += p
                wgt[z:z + P, y:y + P, x:x + P] += m
    return accum, wgt


def _parity_canvas(blocks, grid_dims, stride, patch, vol_shape, z_parity=0):
    """Dense overlap-add of a uniform patch grid (``start = index·stride``).

    Patches at equal grid parities are disjoint when ``patch ≤ 2·stride``,
    so the sum splits into 8 parity groups, each laid out by pad /
    permute / reshape and added at a static shift — the reference's
    algorithm and summation order (``inference.py:194``). ``z_parity`` is
    the parity of row 0 in a larger grid (a shard's slice of the global
    grid): the groups are added in the global grid's parity order, so a
    voxel sums its terms in the single-device order.
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
    for a in sorted(range(min(2, nz)), key=lambda a: (a + z_parity) % 2):
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


def _clip_spec(output_clip):
    if output_clip is None or output_clip == "input":
        return output_clip
    lo, hi = output_clip
    return float(lo), float(hi)


def build_tiled_program(model, transform, shape, patch_size=64, overlap=12,
                        trim=5, batch_size=32, return_float=False,
                        output_clip=None):
    """The tiled engine for a block of ``shape``.

    Returns ``(program, starts)``: ``program(raw, starts)`` denoises one
    block ``raw`` (a float32 tensor of raw counts on the model's device) and
    ``starts`` is the tail-padded ``(n, 3)`` patch-origin array (the tail
    repeats the last start so every batch is full). ``program(raw, starts,
    crop)`` returns only the part of the block that ``crop`` (a tuple of
    slices) selects, and maps only that back to counts.

    ``output_clip`` clamps every prediction in the transform domain before
    the stitch: ``"input"`` to the transformed block's own range, or an
    explicit ``(lo, hi)``. A self-supervised model can overshoot at rare
    bright voxels, and an asinh-type inverse turns a small overshoot into a
    65535 clamp; denoising never needs to exceed the observed range.
    """
    shape = tuple(int(d) for d in shape)
    output_clip = _clip_spec(output_clip)
    starts = generate_patch_starts(shape, patch_size, overlap)
    stride = patch_size - overlap
    grid_dims = tuple(
        len(range(0, max(d - patch_size + stride, 1), stride)) for d in shape
    )
    n_grid = len(starts)
    padded = tuple(
        max(int(starts[:, d].max()) + patch_size, shape[d]) for d in range(3)
    )
    starts = _pad_starts(starts, batch_size)
    P = patch_size
    whole = tuple(slice(0, d) for d in shape)

    def program(raw, starts, crop=None):
        x = transform.forward(raw)
        clip = output_clip
        if output_clip == "input":
            clip = (x.min(), x.max())
        x = F.pad(x, [0, padded[2] - shape[2], 0, padded[1] - shape[1],
                      0, padded[0] - shape[0]])
        starts = starts[:n_grid]
        if P > 2 * stride:
            accum, wgt = tiled_accumulate(model, x, starts, starts, shape, P,
                                          batch_size, trim, clip)
        else:
            preds, masks = [], []
            for _, pred, mask in _patch_batches(model, x, starts, starts,
                                                shape, P, batch_size, trim,
                                                clip):
                preds.append(pred)
                masks.append(mask)
        with span("inference.stitch"):
            if P <= 2 * stride:
                accum = _parity_canvas(torch.cat(preds), grid_dims, stride,
                                       P, padded)
                wgt = _parity_canvas(torch.cat(masks), grid_dims, stride, P,
                                     padded)
            # Every step from here is elementwise: cropping first gives the
            # same voxels.
            accum, wgt = accum[whole], wgt[whole]
            if crop is not None:
                accum, wgt = accum[crop], wgt[crop]
            out = accum / (wgt + 1e-8)
            if return_float:
                return transform.inverse_float(out)
        with span("inference.download"):  # the counts' 16-bit DtoH
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


# Blocks above this many voxels stream through super-tiles.
_MAX_DEVICE_VOXELS = 640 ** 3


def predict(img, model, transform, patch_size=64, overlap=12, trim=5,
            batch_size=32, max_device_voxels=_MAX_DEVICE_VOXELS,
            return_float=False, output_clip=None, device="cuda"):
    """Denoise a whole volume; returns numpy uint16 counts (or float32
    counts with ``return_float``).

    ``img`` is a 3-D (or squeezable 5-D) uint16/float volume of raw counts.
    ``patch_size="auto"`` lets :func:`plan_tiling` choose patch and batch.
    ``model`` must already live on ``device``. Volumes above
    ``max_device_voxels`` stream through halo'd super-tiles.
    ``output_clip`` (``None``, ``"input"`` or ``(lo, hi)``; see
    :func:`build_tiled_program`) is taken per super-tile when streaming.
    """
    out = _predict(img, model, transform, patch_size=patch_size,
                   overlap=overlap, trim=trim, batch_size=batch_size,
                   max_device_voxels=max_device_voxels,
                   return_float=return_float, output_clip=output_clip,
                   device=device)
    # A block's uint16 counts come back in page-locked memory, which the
    # host allocator reuses once dropped: the caller gets its own copy.
    return out if return_float or out.flags.owndata else out.copy()


predict.staged_u16 = 0
predict.staged_host = 0
predict.bus_bytes = 0


def _predict(img, model, transform, *, patch_size, overlap, trim,
             batch_size, max_device_voxels=_MAX_DEVICE_VOXELS,
             return_float=False, output_clip=None, device="cuda", crop=None,
             staged=None):
    """:func:`predict`'s body, returning only the part of the result that
    ``crop`` (a tuple of slices; the whole by default) selects. A uint16
    block's counts are a view of page-locked memory on the card.

    A uint16 block goes up as its int16 bits from page-locked memory and is
    widened to float32 on the device; ``staged``, where given, is a host
    int16 tensor whose first voxels hold ``img`` already (page-locked on
    the card). Any other dtype is cast on the host. Every step is exact,
    so the result is bit for bit the host-staged one."""
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    if img.ndim != 3:
        raise ValueError(f"expected 3D volume, got {img.shape}")
    if patch_size == "auto":
        patch_size, batch_size = plan_tiling(img.shape, overlap)
    _check(img, patch_size, overlap, trim)
    if int(np.prod(img.shape)) > max_device_voxels:
        out = _predict_streaming(
            img, model, transform, patch_size, overlap, trim, batch_size,
            max_device_voxels, return_float, output_clip, device,
        )
        return out if crop is None else out[crop]
    program, starts = build_tiled_program(
        model, transform, img.shape, patch_size, overlap, trim, batch_size,
        return_float=return_float, output_clip=output_clip,
    )
    if img.dtype == np.uint16:
        predict.staged_u16 += 1
        with span("inference.upload"):
            if staged is None:
                raw = to_tensor(img, device)
            else:
                raw = staged[:img.size].view(img.shape).to(
                    device, non_blocking=True)
        with span("inference.cast"):
            raw = counts_f32(raw)
        predict.bus_bytes += img.nbytes
    else:
        predict.staged_host += 1
        with span("inference.cast"):
            raw = np.asarray(img, dtype=np.float32)
        predict.bus_bytes += raw.nbytes
        with span("inference.upload"):
            raw = torch.from_numpy(raw).to(device)
    with torch.inference_mode():
        out = program(raw, starts, crop)
    if isinstance(out, torch.Tensor):
        with span("inference.download"):
            out = out.cpu().numpy()
    predict.bus_bytes += out.nbytes
    return out


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
                       batch_size, max_device_voxels, return_float,
                       output_clip, device):
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
                out[tuple(core_sl)] = _predict(
                    img[tuple(blk_sl)], model, transform,
                    patch_size=patch_size, overlap=overlap, trim=trim,
                    batch_size=batch_size, max_device_voxels=2 ** 63,
                    return_float=return_float, output_clip=output_clip,
                    device=device, crop=tuple(res_sl),
                )
    return out


def predict_patch(patch, model, transform, device="cuda"):
    """Denoise a single patch; returns numpy uint16 counts."""
    x = transform.forward(
        torch.from_numpy(np.asarray(patch, dtype=np.float32)).to(device))
    with torch.inference_mode():
        pred = model(x[None, ..., None])[0, ..., 0].float()
    return transform.inverse(pred)


def build_volume_transform(transform, img=None, offset=None, percentile=1.0):
    """Per-volume transform with a background pedestal folded in.

    Prefers a precomputed ``offset`` (the production path); falls back to
    estimating it from the volume's low percentile, which is for debugging
    only: an estimate from a crop is biased.
    """
    from exaspim_tpu_torch.transforms import estimate_offset, with_offset

    if offset is None:
        if img is None:
            raise ValueError("need either a precomputed offset or an img")
        offset = estimate_offset(np.asarray(img), percentile=percentile)
    return with_offset(transform, float(offset))
