"""Small-stencil 3-D filters as separable passes, in plain PyTorch.

Counterpart of ``exaspim_tpu/ops/filters.py``. Semantics match
scipy.ndimage defaults:

* ``gaussian_filter``: truncated Gaussian (radius =
  ``int(truncate * sigma + 0.5)``), 'reflect' boundary;
* ``uniform_filter``: size-``w`` mean over the window
  ``[i - w//2, i + (w-1)//2]``, 'reflect' boundary;
* ``binary_dilation``: 6-connected (faces only) structuring element,
  iterated, as ``scipy.ndimage.generate_binary_structure(3, 1)``.

Tensors in, tensors out, on the input's device (numpy arrays land on the
CPU). No pass goes through a library convolution, so no TF32 rounding can
enter on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "separable_filter",
    "gaussian_kernel1d",
    "gaussian_filter",
    "uniform_filter",
    "binary_dilation",
]


def _symmetric_pad(x, lo, hi, axis):
    """scipy 'reflect' (numpy 'symmetric'): (d c b a | a b c d | d c b a)."""
    n = x.shape[axis]
    if max(lo, hi) > n:  # a pad wider than the axis reflects repeatedly
        j = torch.arange(-lo, n + hi, device=x.device) % (2 * n)
        return x.index_select(axis, torch.where(j < n, j, 2 * n - 1 - j))
    head = x.narrow(axis, 0, lo).flip(axis)
    tail = x.narrow(axis, n - hi, hi).flip(axis)
    return torch.cat([head, x, tail], dim=axis)


def _conv1d_along(x, kernel, axis):
    """Correlate ``x`` with a centered 1-D kernel along ``axis``: a sum of
    shifted, weighted views (exact f32 products, tap order as written)."""
    k = len(kernel)
    lo = k // 2
    n = x.shape[axis]
    xp = _symmetric_pad(x, lo, k - 1 - lo, axis)
    out = xp.narrow(axis, 0, n) * float(kernel[0])
    for j in range(1, k):
        out = out + xp.narrow(axis, j, n) * float(kernel[j])
    return out


def separable_filter(x, kernels):
    """Apply one 1-D kernel per axis (``None`` skips an axis)."""
    x = torch.as_tensor(x)
    for axis, kernel in enumerate(kernels):
        if kernel is not None:
            x = _conv1d_along(x, np.asarray(kernel), axis)
    return x


def gaussian_kernel1d(sigma, truncate=4.0):
    """scipy-compatible truncated Gaussian kernel (a host-side constant)."""
    radius = int(truncate * float(sigma) + 0.5)
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (xs / float(sigma)) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_filter(x, sigma, truncate=4.0):
    """Separable Gaussian smoothing, like scipy.ndimage.gaussian_filter."""
    x = torch.as_tensor(x)
    k = gaussian_kernel1d(sigma, truncate)
    return separable_filter(x, [k] * x.dim())


def uniform_filter(x, size):
    """Separable size-``size`` mean filter, like scipy.ndimage.uniform_filter."""
    x = torch.as_tensor(x)
    for axis in range(x.dim()):
        xp = _symmetric_pad(x, size // 2, size - 1 - size // 2, axis)
        xp = xp.movedim(axis, -1)
        lead = xp.shape[:-1]
        # avg_pool1d sums in the input dtype without TF32 (a conv would not).
        y = F.avg_pool1d(xp.reshape(-1, 1, xp.shape[-1]), size, stride=1)
        x = y.reshape(*lead, y.shape[-1]).movedim(-1, axis)
    return x


def binary_dilation(mask, iterations=1):
    """Iterated 6-connected binary dilation (scipy's default structure):
    per iteration, the OR of the mask with its two shifts along each axis
    (zeros shifted in at the faces)."""
    m = torch.as_tensor(mask).to(torch.bool)
    for _ in range(int(iterations)):
        out = m.clone()
        for axis in range(m.dim()):
            n = m.shape[axis]
            if n > 1:
                out.narrow(axis, 1, n - 1).logical_or_(m.narrow(axis, 0, n - 1))
                out.narrow(axis, 0, n - 1).logical_or_(m.narrow(axis, 1, n - 1))
        m = out
    return m
