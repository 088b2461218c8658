"""Count-space validation metrics, host side (numpy), the masks, the
coherence artifact gate and the checkpoint score.

Copies of ``exaspim_tpu/ops/metrics.py``: the robust brightness threshold,
the foreground mask, the live sampler's masks and gate (lag
autocorrelation, high-frequency energy fraction, segmentation and
skeleton masks, the incoherent-segment test; numpy and
``scipy.ndimage``, as there), foreground/background MAE, MIP max error,
false-bright rate, the per-example metric dict and the weighted checkpoint
score. The Trainer scores checkpoints with :func:`checkpoint_score`;
:func:`evaluate_example` is the oracle that the device metrics
(:mod:`exaspim_tpu_torch.ops.metrics_device`) are held to.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import ndimage

__all__ = [
    "DEFAULT_CHECKPOINT_WEIGHTS",
    "robust_brightness_threshold",
    "tensor_brightness_threshold",
    "make_foreground_mask",
    "local_autocorr",
    "highfreq_energy_fraction",
    "make_segmentation_mask",
    "patch_has_incoherent_segment",
    "make_skeleton_mask",
    "foreground_background_mae",
    "mip_max_error",
    "false_bright_rate",
    "evaluate_example",
    "checkpoint_score",
]

# Weights for the checkpoint-selection score; cratio 0.0 keeps selection
# fidelity-driven.
DEFAULT_CHECKPOINT_WEIGHTS = {
    "fg_mae": 1.0,
    "bg_mae": 0.2,
    "top_pct_error": 0.5,
    "cratio": 0.0,
}


def robust_brightness_threshold(img, k=6.0):
    """Median + ``k`` robust standard deviations (1.4826 * MAD)."""
    flat = np.asarray(img, dtype=np.float64).ravel()
    center = np.median(flat)
    scale = 1.4826 * np.median(np.abs(flat - center)) + 1e-6
    return float(center + k * scale)


def _median(flat):
    """numpy's median of a 1-D f64 tensor: the middle value, or the mean
    of the two middle values (their f64 sum halved)."""
    n = flat.numel()
    hi = flat.kthvalue(n // 2 + 1).values
    if n % 2:
        return hi
    return (flat.kthvalue(n // 2).values + hi) / 2


def tensor_brightness_threshold(img, k=6.0):
    """:func:`robust_brightness_threshold` of a tensor, taken on its device
    in f64 with the same operations (equal to numpy's)."""
    flat = img.reshape(-1).to(torch.float64)
    center = _median(flat).item()
    scale = 1.4826 * _median((flat - center).abs()).item() + 1e-6
    return float(center + k * scale)


def make_foreground_mask(raw, k=6.0, dilate=1):
    """Robust intensity foreground mask (above the median + ``k`` · 1.4826 ·
    MAD threshold), dilated ``dilate`` times with the face-connected cross.

    An ndarray gives an ndarray and a tensor a tensor on its device. On the
    host the threshold is numpy's, as the JAX package computes it; on the
    card it is taken there in f64 with numpy's median (the same
    operations), so the mask is the same bit for bit."""
    from exaspim_tpu_torch.ops.filters import binary_dilation

    if isinstance(raw, torch.Tensor) and raw.device.type != "cpu":
        mask = raw.to(torch.float64) > tensor_brightness_threshold(raw, k)
    else:
        host = raw.numpy() if isinstance(raw, torch.Tensor) else raw
        mask = torch.from_numpy(
            np.asarray(host) > robust_brightness_threshold(host, k=k))
    if dilate:
        mask = binary_dilation(mask, iterations=dilate)
    if isinstance(raw, torch.Tensor):
        return mask
    return mask.numpy()


def _pearson(x, y):
    """Pearson r of two 1-D samples; NaN when undefined (n<2 or flat)."""
    if x.size < 2:
        return np.nan
    xc = x - x.mean()
    yc = y - y.mean()
    denom = np.sqrt((xc @ xc) * (yc @ yc))
    if denom < 1e-6 * x.size:
        return np.nan
    return float((xc @ yc) / denom)


def local_autocorr(raw, mask, lag=2):
    """Mean lag-``lag`` Pearson autocorrelation of masked voxels, per axis.

    PSF-blurred neurites stay correlated over 2-3 voxels; blocky artifacts
    decorrelate by lag 2. Returns 1.0 (maximally coherent) when no axis
    yields a defined correlation, so no segment is rejected on an
    undefined score.
    """
    vol = np.asarray(raw, dtype=np.float64)
    keep = np.asarray(mask, dtype=bool)
    per_axis = []
    for ax in range(vol.ndim):
        v = np.moveaxis(vol, ax, 0)
        k = np.moveaxis(keep, ax, 0)
        both = k[:-lag] & k[lag:]
        per_axis.append(_pearson(v[:-lag][both], v[lag:][both]))
    if not per_axis or np.all(np.isnan(per_axis)):
        return 1.0
    return float(np.nanmean(per_axis))


def highfreq_energy_fraction(raw, mask, smooth=None, smooth_sigma=1.0):
    """Fraction of masked variance above a Gaussian low-pass (``smooth``,
    or the raw volume filtered at ``smooth_sigma``). Salt-and-pepper
    artifacts read ~0.6-0.8, smooth neurites ~0.0-0.25; 0.0 when the
    masked variance is degenerate."""
    vol = np.asarray(raw, dtype=np.float64)
    sel = np.asarray(mask, dtype=bool)
    low = ndimage.gaussian_filter(vol, sigma=smooth_sigma) \
        if smooth is None else smooth
    total = np.var(vol[sel])
    if not np.isfinite(total) or total < 1e-12:
        return 0.0
    return float(np.var(vol[sel] - np.asarray(low)[sel]) / total)


def make_segmentation_mask(labels, dilate=0):
    """Foreground = labeled neurites only (labels > 0); dilation is
    opt-in."""
    mask = np.asarray(labels) > 0
    if dilate > 0:
        mask = ndimage.binary_dilation(mask, iterations=dilate)
    return mask


def patch_has_incoherent_segment(
    labels,
    raw,
    min_autocorr=0.4,
    max_highfreq_frac=0.35,
    min_segment_voxels=50,
    smooth_sigma=1.0,
    coherence_lag=2,
):
    """True if any scorable segment is a spatially incoherent artifact.

    A segment is rejected only when it fails both tests — autocorrelation
    at ``coherence_lag`` below ``min_autocorr`` and high-frequency energy
    fraction above ``max_highfreq_frac`` — so a thin but smooth neurite is
    kept. Segments under ``min_segment_voxels`` are ignored. The artifact
    corrupts the raw input itself, so callers resample the whole patch.
    """
    labels = np.asarray(labels)
    fg = labels > 0
    if not fg.any():
        return False
    raw = np.asarray(raw, dtype=np.float64)
    smooth = ndimage.gaussian_filter(raw, sigma=smooth_sigma)
    for lid in np.unique(labels[fg]):
        if lid == 0:
            continue
        seg = labels == lid
        if seg.sum() < min_segment_voxels:
            continue
        if local_autocorr(raw, seg, lag=coherence_lag) >= min_autocorr:
            continue
        if highfreq_energy_fraction(raw, seg, smooth=smooth) \
                > max_highfreq_frac:
            return True
    return False


def make_skeleton_mask(points, start, patch_shape, dilate=2):
    """Traced skeleton nodes rasterized in a patch, dilated to neurite
    radius. ``points`` are (N, 3) voxel coordinates in the brain volume,
    ``start`` the patch's lower corner; raw intensity is never read."""
    start = np.asarray(start)
    stop = start + np.asarray(patch_shape)
    pts = np.asarray(points).reshape(-1, 3)
    inside = np.all((pts >= start) & (pts < stop), axis=1)
    mask = np.zeros(tuple(patch_shape), dtype=bool)
    local = (pts[inside] - start).astype(int)
    if local.size:
        mask[local[:, 0], local[:, 1], local[:, 2]] = True
    if dilate > 0:
        mask = ndimage.binary_dilation(mask, iterations=dilate)
    return mask


def foreground_background_mae(pred, ref, fg_mask):
    """Mean absolute error split by a foreground mask; empty side reports 0."""
    pred = np.asarray(pred, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    fg = np.asarray(fg_mask, dtype=bool)
    err = np.abs(pred - ref)
    fg_mae = float(err[fg].mean()) if fg.any() else 0.0
    bg_mae = float(err[~fg].mean()) if (~fg).any() else 0.0
    return fg_mae, bg_mae


def mip_max_error(pred, raw):
    """Absolute error between the global maxima of two images."""
    return float(abs(
        np.max(pred).astype(np.int64) - np.max(raw).astype(np.int64)
    ))


def false_bright_rate(pred, raw, fg_mask, k=6.0):
    """Fraction of background voxels above the raw image's robust
    brightness threshold."""
    pred = np.asarray(pred, dtype=np.float64)
    bg = ~np.asarray(fg_mask, dtype=bool)
    if not bg.any():
        return 0.0
    return float(np.mean(pred[bg] > robust_brightness_threshold(raw, k=k)))


def evaluate_example(pred, raw, target, fg_mask, pct=0.1):
    """Full per-example metric dict in counts: foreground fidelity vs raw,
    background cleanup vs teacher, top-``pct`` % brightness preservation,
    MIP max error, false-bright rate."""
    fg_mae, _ = foreground_background_mae(pred, raw, fg_mask)
    _, bg_mae = foreground_background_mae(pred, target, fg_mask)

    q = 100.0 - pct
    raw_top = float(np.percentile(np.asarray(raw, dtype=np.float64), q))
    pred_top = float(np.percentile(np.asarray(pred, dtype=np.float64), q))
    return {
        "fg_mae": fg_mae,
        "bg_mae": bg_mae,
        "top_pct_error": abs(pred_top - raw_top),
        "top_pct_preservation": pred_top / (raw_top + 1e-8),
        "mip_max_error": mip_max_error(pred, raw),
        "false_bright_rate": false_bright_rate(pred, raw, fg_mask),
    }


def checkpoint_score(metrics, cratio, weights=None):
    """Checkpoint-selection score, lower is better: weighted fidelity
    terms minus ``weights['cratio'] * cratio``."""
    w = DEFAULT_CHECKPOINT_WEIGHTS if weights is None else weights
    return (
        w.get("fg_mae", 0.0) * metrics["fg_mae"]
        + w.get("bg_mae", 0.0) * metrics["bg_mae"]
        + w.get("top_pct_error", 0.0) * metrics["top_pct_error"]
        - w.get("cratio", 0.0) * cratio
    )
