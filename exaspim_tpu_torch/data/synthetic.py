"""Synthetic ExaSPIM-like phantom volumes and patch datasets (numpy +
scipy, host side).

Copies of ``exaspim_tpu/data/synthetic.py``: randomly oriented PSF-blurred
neurite tubes over a pedestal background, observed with Poisson shot noise
and Gaussian read noise; the per-index patch dataset with its Gaussian
teacher, and the cache writer. Same seeds, same volumes as the reference.
The BM4D teacher (``use_bm4d_teacher=True``) is the port's own
:func:`exaspim_tpu_torch.ops.bm4d.bm4d`, run on the dataset's ``device``.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = [
    "neurite_phantom",
    "neurite_phantom_b",
    "noisy_observation",
    "SyntheticPatchDataset",
    "make_synthetic_cache",
]


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


def neurite_phantom_b(shape=(128, 128, 128), seed=0):
    """Second phantom family ("family B"): ~4× denser, thinner and dimmer
    tubes, a wider PSF (σ = 1.8) and a 40-count pedestal."""
    n_tubes = max(4, round(48 * float(np.prod(shape)) / 128 ** 3))
    return neurite_phantom(
        shape, n_tubes=n_tubes, radius_range=(0.8, 2.2),
        intensity_range=(250.0, 2500.0), background=40.0,
        psf_sigma=1.8, seed=seed,
    )


def _teacher(raw, sigma_bm4d=16.0, device="cuda"):
    """Classical denoised teacher: BM4D of the raw counts, rounded and
    clipped to uint16."""
    from exaspim_tpu_torch.ops.bm4d import bm4d

    den = bm4d(raw.astype(np.float32), sigma_bm4d, device=device)
    return np.clip(np.round(den.cpu().numpy()), 0, 65535).astype(np.uint16)


class SyntheticPatchDataset:
    """Map-style dataset of (raw, teacher, fg) synthetic count patches.

    Deterministic per index: item ``i`` is generated from
    ``SeedSequence([seed, i])``, so any worker layout produces identical
    data. The teacher is the Gaussian surrogate (σ = 1, rounded to
    counts) or, with ``use_bm4d_teacher``, BM4D at ``sigma_bm4d`` computed
    on ``device``.
    """

    fields = ("raw", "teacher", "fg")

    def __init__(self, n=64, patch_shape=(64, 64, 64), seed=42,
                 sigma_bm4d=16.0, use_bm4d_teacher=False, family="a",
                 device="cuda"):
        if family not in ("a", "b", "mix"):
            raise ValueError(f"unknown phantom family {family!r}")
        self.n = int(n)
        self.patch_shape = tuple(patch_shape)
        self.seed = seed
        self.sigma_bm4d = sigma_bm4d
        self.use_bm4d_teacher = use_bm4d_teacher
        self.family = family
        self.device = device

    def __len__(self):
        return self.n

    @property
    def items_run_torch(self):
        """Whether an item runs torch ops (the BM4D teacher): such a
        dataset is fetched in the loader's own process."""
        return bool(self.use_bm4d_teacher)

    def raw_and_fg(self, index):
        """Raw counts + foreground mask only (no teacher)."""
        ss = np.random.SeedSequence([self.seed, index])
        s1, s2 = ss.spawn(2)
        fam = self.family
        if fam == "mix":
            fam = "a" if index % 2 == 0 else "b"
        if fam == "b":
            clean, fg = neurite_phantom_b(
                self.patch_shape, seed=int(s1.generate_state(1)[0])
            )
        else:
            clean, fg = neurite_phantom(
                self.patch_shape, n_tubes=4,
                seed=int(s1.generate_state(1)[0]),
            )
        raw = noisy_observation(
            clean, seed=int(s2.generate_state(1)[0])
        )
        return raw, fg

    def __getitem__(self, index):
        if not -self.n <= index < self.n:
            raise IndexError(index)
        raw, fg = self.raw_and_fg(index % self.n)
        if self.use_bm4d_teacher:
            return raw, _teacher(raw, self.sigma_bm4d, self.device), fg
        teacher = np.clip(
            np.round(ndimage.gaussian_filter(raw.astype(np.float32), 1.0)),
            0, 65535,
        ).astype(np.uint16)
        return raw, teacher, fg


def make_synthetic_cache(cache_dir, n, patch_shape, transform_cfg, seed=42,
                         **dataset_kwargs):
    """Materialize a synthetic dataset into an on-disk cache directory."""
    from exaspim_tpu_torch.data.cache import allocate_cache

    ds = SyntheticPatchDataset(
        n=n, patch_shape=patch_shape, seed=seed, **dataset_kwargs
    )
    raw, teacher, fg = allocate_cache(
        cache_dir, n, patch_shape, transform_cfg,
        config={"source": "synthetic", "n": n, "patch_shape": patch_shape,
                "seed": seed, **dataset_kwargs},
    )
    for i in range(n):
        raw[i], teacher[i], fg[i] = ds[i]
    raw.flush(), teacher.flush(), fg.flush()
    return cache_dir
