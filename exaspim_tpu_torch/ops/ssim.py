"""3-D SSIM and PSNR in PyTorch.

Counterpart of ``exaspim_tpu/ops/ssim.py``: window-16 mean filters
(:func:`exaspim_tpu_torch.ops.filters.uniform_filter`), C1=(0.01·L)²,
C2=(0.03·L)², and the reference's shared-mean shift, which keeps
``E[x²] − µ²`` benign in float32 for bright uint16 data.
"""

from __future__ import annotations

import torch

from exaspim_tpu_torch.ops.filters import uniform_filter

__all__ = ["uniform_filter", "ssim3d", "psnr", "compute_mae", "compute_lmax"]


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


def compute_mae(img1, img2):
    """Mean absolute error (a 0-d f32 tensor)."""
    a = torch.as_tensor(img1).float()
    b = torch.as_tensor(img2).float().to(a.device)
    return (a - b).abs().mean()


def compute_lmax(img1, img2):
    """Max absolute error (a 0-d f32 tensor)."""
    a = torch.as_tensor(img1).float()
    b = torch.as_tensor(img2).float().to(a.device)
    return (a - b).abs().max()
