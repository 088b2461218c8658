"""3-D SSIM and PSNR in PyTorch.

Counterpart of ``exaspim_tpu/ops/ssim.py`` and the window-16 uniform
filter of ``exaspim_tpu/ops/filters.py``: a scipy-compatible mean filter
('reflect' boundary, window ``[i − w//2, i + (w−1)//2]``), C1=(0.01·L)²,
C2=(0.03·L)², and the reference's shared-mean shift, which keeps
``E[x²] − µ²`` benign in float32 for bright uint16 data.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["uniform_filter", "ssim3d", "psnr"]


def _symmetric_pad(x, lo, hi, axis):
    """scipy 'reflect' (numpy 'symmetric'): (d c b a | a b c d | d c b a)."""
    n = x.shape[axis]
    head = x.narrow(axis, 0, lo).flip(axis)
    tail = x.narrow(axis, n - hi, hi).flip(axis)
    return torch.cat([head, x, tail], dim=axis)


def uniform_filter(x, size):
    """Separable size-``size`` mean filter, like scipy.ndimage.uniform_filter."""
    for axis in range(x.dim()):
        xp = _symmetric_pad(x, size // 2, size - 1 - size // 2, axis)
        xp = xp.movedim(axis, -1)
        lead = xp.shape[:-1]
        # avg_pool1d sums in the input dtype without TF32 (a conv would not).
        y = F.avg_pool1d(xp.reshape(-1, 1, xp.shape[-1]), size, stride=1)
        x = y.reshape(*lead, y.shape[-1]).movedim(-1, axis)
    return x


def ssim3d(img1, img2, data_range=None, window_size=16):
    """Mean SSIM between two 3-D images (a 0-d f32 tensor)."""
    a = torch.as_tensor(img1).float()
    b = torch.as_tensor(img2).float().to(a.device)
    if data_range is None:
        data_range = torch.maximum(a.max() - a.min(), b.max() - b.min())
    shift = 0.5 * (a.mean() + b.mean())
    a = a - shift
    b = b - shift
    mu1s = uniform_filter(a, window_size)
    mu2s = uniform_filter(b, window_size)
    sigma1_sq = uniform_filter(a * a, window_size) - mu1s * mu1s
    sigma2_sq = uniform_filter(b * b, window_size) - mu2s * mu2s
    sigma12 = uniform_filter(a * b, window_size) - mu1s * mu2s
    mu1 = mu1s + shift
    mu2 = mu2s + shift
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    num = (2 * mu1 * mu2 + c1) * (2 * sigma12 + c2)
    den = (mu1 * mu1 + mu2 * mu2 + c1) * (sigma1_sq + sigma2_sq + c2)
    return (num / (torch.clamp(den, min=1e-8) + 1e-6)).mean()


def psnr(img1, img2, data_range=65535.0):
    """Peak signal-to-noise ratio in dB (a 0-d f32 tensor)."""
    a = torch.as_tensor(img1).float()
    b = torch.as_tensor(img2).float().to(a.device)
    mse = ((a - b) ** 2).mean()
    return 10.0 * torch.log10(data_range ** 2 / torch.clamp(mse, min=1e-12))
