"""Visualization: MIPs, histograms, slice panels, segmentation overlays.

Counterpart of ``exaspim_tpu/utils/plots.py``: max-intensity projections
along the three axes, intensity histograms, slice grids, and a qualitative
segmentation colormap. All figures save to explicit paths, never the
working directory. matplotlib and PIL are imported inside the functions
that draw, so importing this module needs neither.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "plot_mips",
    "plot_histogram",
    "plot_slices",
    "make_segmentation_colormap",
    "plot_segmentation_mips",
    "save_mip_png",
]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _as_3d(img):
    img = np.asarray(img)
    if img.ndim == 5:
        img = img[0, 0]
    return img


def _finish(plt, fig, output_path):
    fig.tight_layout()
    if output_path:
        fig.savefig(output_path, dpi=120)
        plt.close(fig)
        return output_path
    return fig


def plot_mips(img, output_path=None, clip_bound=99.9, title=None):
    """XY / XZ / YZ max-intensity projections."""
    plt = _mpl()
    img = _as_3d(img)
    vmax = np.percentile(img, clip_bound)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, axis, name in zip(axes, (0, 1, 2), ("XY", "XZ", "YZ")):
        ax.imshow(img.max(axis=axis), vmax=max(vmax, 1), cmap="gray")
        ax.set_title(name)
        ax.axis("off")
    if title:
        fig.suptitle(title)
    return _finish(plt, fig, output_path)


def plot_histogram(img, output_path=None, bins=256, log=True):
    """Voxel-intensity histogram."""
    plt = _mpl()
    img = _as_3d(img)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(img.ravel(), bins=bins, log=log)
    ax.set_xlabel("intensity (counts)")
    ax.set_ylabel("voxels")
    return _finish(plt, fig, output_path)


def plot_slices(img, output_path=None, n=6, axis=0):
    """Evenly spaced slice panel."""
    plt = _mpl()
    img = _as_3d(img)
    idxs = np.linspace(0, img.shape[axis] - 1, n).astype(int)
    fig, axes = plt.subplots(1, n, figsize=(3 * n, 3))
    vmax = max(float(np.percentile(img, 99.9)), 1.0)
    for ax, i in zip(np.atleast_1d(axes), idxs):
        ax.imshow(np.take(img, i, axis=axis), vmax=vmax, cmap="gray")
        ax.set_title(f"{'zyx'[axis]}={i}")
        ax.axis("off")
    return _finish(plt, fig, output_path)


def make_segmentation_colormap(n=256, seed=0):
    """Random label colormap with a black background."""
    from matplotlib.colors import ListedColormap

    rng = np.random.default_rng(seed)
    colors = rng.random((n, 3))
    colors[0] = 0.0
    return ListedColormap(colors)


def save_mip_png(img, output_path, axis=0):
    """Single-axis MIP as an 8-bit PNG (quick visual observability)."""
    from PIL import Image

    img = _as_3d(img)
    mip = img.max(axis=axis).astype(np.float32)
    hi = max(float(mip.max()), 1.0)
    Image.fromarray(
        (255 * mip / hi).astype(np.uint8)
    ).save(output_path)
    return output_path


def plot_segmentation_mips(labels, output_path=None, seed=0):
    """Max-projected segmentation label views with a random colormap."""
    plt = _mpl()
    labels = _as_3d(labels)
    cmap = make_segmentation_colormap(seed=seed)
    fig, axes = plt.subplots(1, 3, figsize=(12, 4))
    for ax, axis, name in zip(axes, (0, 1, 2), ("XY", "XZ", "YZ")):
        ax.imshow(
            labels.max(axis=axis), cmap=cmap, interpolation="nearest"
        )
        ax.set_title(name)
        ax.axis("off")
    return _finish(plt, fig, output_path)
