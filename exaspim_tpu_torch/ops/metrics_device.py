"""Batched validation metrics on the device.

Counterpart of ``exaspim_tpu/ops/metrics_device.py``: the per-example
metrics of a whole batch in one pass of tensor ops, only the ``(B,)``
results cross to the host. Everything is f32 (counts ≤ 65535 are exact).
Medians and percentiles interpolate linearly between the two order
statistics around ``q·(n−1)``, as ``jnp.median`` / ``jnp.percentile`` do
(``torch.median`` would return the lower one).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["evaluate_batch", "quantile", "percentile"]


def quantile(x, q):
    """Linear-interpolation quantile of each row of ``(B, N)`` at the
    fraction ``q`` → ``(B,)``, in f32 as ``jnp.quantile`` computes it:
    position ``q·(n−1)``, weights ``1 − w`` and ``w`` on its two
    neighbours."""
    v = torch.sort(x, dim=1).values
    n = x.shape[1]
    pos = np.float32(q) * np.float32(n - 1)
    lo = min(max(int(np.floor(pos)), 0), n - 1)
    hi = min(max(int(np.ceil(pos)), 0), n - 1)
    w_hi = np.float32(pos - np.floor(pos))
    return v[:, lo] * float(np.float32(1.0) - w_hi) + v[:, hi] * float(w_hi)


def percentile(x, p):
    """``quantile`` at ``p`` percent (``p / 100`` taken in f32)."""
    return quantile(x, np.float32(p) / np.float32(100.0))


def _robust_threshold(raw, k):
    med = quantile(raw, 0.5)
    mad = quantile((raw - med[:, None]).abs(), 0.5) + 1e-6
    return med + k * 1.4826 * mad


def _masked_mean(x, mask):
    denom = mask.sum(dim=1)
    return torch.where(denom > 0, (x * mask).sum(dim=1)
                       / torch.clamp(denom, min=1.0), torch.zeros_like(denom))


def evaluate_batch(pred, raw, target, fg_mask, pct=0.1, k=6.0):
    """Per-example metrics over a ``(B, ...)`` batch of counts.

    Returns a dict of ``(B,)`` f32 tensors: ``fg_mae`` (vs raw, over fg),
    ``bg_mae`` (vs teacher, over background), ``top_pct_error`` and
    ``top_pct_preservation`` (the ``100 − pct`` percentile), ``mip_max_error``
    and ``false_bright_rate`` (background above the raw image's robust
    threshold)."""
    b = pred.shape[0]
    pred, raw, target, fg = (t.reshape(b, -1).to(torch.float32)
                             for t in (pred, raw, target, fg_mask))
    bg = 1.0 - fg
    raw_top = percentile(raw, 100.0 - pct)
    pred_top = percentile(pred, 100.0 - pct)
    thr = _robust_threshold(raw, k)
    return {
        "fg_mae": _masked_mean((pred - raw).abs(), fg),
        "bg_mae": _masked_mean((pred - target).abs(), bg),
        "top_pct_error": (pred_top - raw_top).abs(),
        "top_pct_preservation": pred_top / (raw_top + 1e-8),
        "mip_max_error": (pred.amax(dim=1) - raw.amax(dim=1)).abs(),
        "false_bright_rate": _masked_mean(
            (pred > thr[:, None]).to(torch.float32), bg),
    }
