"""Count-space validation metrics, host side (numpy), the foreground mask
and the checkpoint score.

Copies of the validation part of ``exaspim_tpu/ops/metrics.py``
(``:23-239``): the robust brightness threshold, the foreground mask,
foreground/background MAE, MIP max error, false-bright rate, the
per-example metric dict and the weighted checkpoint score. The Trainer
scores checkpoints with :func:`checkpoint_score`; :func:`evaluate_example`
is the oracle that the device metrics
(:mod:`exaspim_tpu_torch.ops.metrics_device`) are held to.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "DEFAULT_CHECKPOINT_WEIGHTS",
    "robust_brightness_threshold",
    "tensor_brightness_threshold",
    "make_foreground_mask",
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
