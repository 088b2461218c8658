"""Signal-preserving denoising losses.

Counterpart of ``exaspim_tpu/losses.py``: the foreground-weighted
Charbonnier mean, in the transform domain (a compressive transform shrinks
the bright tail, so a fixed error here is a relative error in counts).
"""

from __future__ import annotations

import dataclasses

import torch

__all__ = ["charbonnier", "signal_preserving_loss", "SignalPreservingLoss"]


def charbonnier(diff, eps=1e-3):
    """Smooth-L1 Charbonnier penalty ``sqrt(diff² + eps²)``, elementwise."""
    return torch.sqrt(diff * diff + eps * eps)


def signal_preserving_loss(pred, target, fg_mask, fg_weight=20.0, eps=1e-3):
    """Foreground-weighted Charbonnier mean.

    ``fg_weight=0`` reduces to a plain Charbonnier mean. ``fg_mask`` is a
    0/1 tensor (or a number) broadcastable to ``pred``.
    """
    weight = 1.0 + fg_weight * fg_mask
    return torch.mean(weight * charbonnier(pred - target, eps))


@dataclasses.dataclass(frozen=True)
class SignalPreservingLoss:
    """Callable config object mirroring the reference's loss module API."""

    fg_weight: float = 20.0
    eps: float = 1e-3

    def __call__(self, pred, target, fg_mask):
        return signal_preserving_loss(
            pred, target, fg_mask, fg_weight=self.fg_weight, eps=self.eps
        )
