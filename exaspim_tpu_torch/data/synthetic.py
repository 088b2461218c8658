"""Synthetic ExaSPIM-like phantom volumes (numpy + scipy, host side).

Copies of ``exaspim_tpu/data/synthetic.py``'s ``neurite_phantom`` and
``noisy_observation``: randomly oriented PSF-blurred neurite tubes over a
pedestal background, observed with Poisson shot noise and Gaussian read
noise. Same seeds, same volumes as the reference.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["neurite_phantom", "noisy_observation"]


def neurite_phantom(shape=(128, 128, 128), n_tubes=12, radius_range=(1.0, 3.0),
                    intensity_range=(500.0, 6000.0), background=110.0,
                    psf_sigma=1.1, seed=0):
    """Clean (noise-free) phantom: random neurite tubes + background.

    Returns float32 "true" photon rates and the boolean foreground mask of
    tube voxels (pre-PSF), analogous to the annotation masks the
    reference derives from segmentations/SWC skeletons.
    """
    rng = np.random.default_rng(seed)
    clean = np.zeros(shape, dtype=np.float32)
    fg = np.zeros(shape, dtype=bool)
    # Broadcastable 1D axes — no materialized (Z, Y, X, 3) point grid,
    # which dominates runtime/memory for whole-volume phantoms.
    zc = np.arange(shape[0], dtype=np.float32)[:, None, None]
    yc = np.arange(shape[1], dtype=np.float32)[None, :, None]
    xc = np.arange(shape[2], dtype=np.float32)[None, None, :]
    r2_grid = zc**2 + yc**2 + xc**2
    for _ in range(n_tubes):
        p0 = rng.uniform(0, shape, size=3).astype(np.float32)
        direction = rng.normal(size=3).astype(np.float32)
        direction /= np.linalg.norm(direction) + 1e-9
        radius = rng.uniform(*radius_range)
        value = rng.uniform(*intensity_range)
        # Distance from each voxel to the infinite line through p0:
        # |rel|² − (rel·d)², expanded so every term broadcasts from 1D.
        dz, dy, dx = direction
        along = (
            (zc - p0[0]) * dz + (yc - p0[1]) * dy + (xc - p0[2]) * dx
        )
        rel2 = (
            r2_grid
            - 2.0 * (zc * p0[0] + yc * p0[1] + xc * p0[2])
            + float(p0 @ p0)
        )
        tube = rel2 - along**2 <= radius**2
        clean[tube] += value
        fg |= tube
    clean = ndimage.gaussian_filter(clean, sigma=psf_sigma)
    clean += background
    return clean.astype(np.float32), fg


def noisy_observation(clean, gain=1.0, read_noise=3.0, seed=0):
    """Poisson shot noise + Gaussian read noise, clipped to uint16."""
    rng = np.random.default_rng(seed)
    counts = rng.poisson(np.maximum(clean, 0) / gain) * gain
    counts = counts + rng.normal(0.0, read_noise, clean.shape)
    return np.clip(np.round(counts), 0, 65535).astype(np.uint16)
