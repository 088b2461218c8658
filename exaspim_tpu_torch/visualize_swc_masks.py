"""Render SWC skeleton-mask overlays for QA.

Counterpart of ``scripts/visualize_swc_masks.py`` (reference
scripts/visualize_swc_masks.py): pick traced nodes whose centred patch
lies inside the volume, rasterize the skeleton mask there
(:func:`~exaspim_tpu_torch.ops.metrics.make_skeleton_mask`) and render
raw beside the mask tinted over it.

Usage:
    python -m exaspim_tpu_torch.visualize_swc_masks --img vol.zarr \\
        --swc traces/ --out masks.png [--n 6] [--patch 64 64 64]

matplotlib is imported by :func:`render` alone: the module imports where
matplotlib is missing, and rendering there raises ``ImportError``.
"""

from __future__ import annotations

import argparse

import numpy as np

from exaspim_tpu_torch.ops.metrics import make_skeleton_mask
from exaspim_tpu_torch.utils import img_io
from exaspim_tpu_torch.utils.swc import Reader, to_voxels

__all__ = ["pick_examples", "render", "main"]


def pick_examples(points, shape, patch, n, seed=0):
    """``n`` nodes drawn without replacement among those whose centred
    patch is fully in bounds (reference visualize_swc_masks.py:93-120)."""
    pts = np.asarray(points)
    half = np.asarray(patch) // 2
    hi = np.asarray(shape) - (np.asarray(patch) - half)
    candidates = pts[np.all((pts >= half) & (pts < hi), axis=1)]
    if not len(candidates):
        raise ValueError("no in-bounds SWC nodes for this patch size")
    rng = np.random.default_rng(seed)
    sel = rng.choice(len(candidates), size=min(n, len(candidates)),
                     replace=False)
    return candidates[sel]


def render(img, points, centers, patch, out_path, dilate=2):
    """One row per centre: the raw z max projection and the skeleton mask
    tinted over it; writes ``out_path`` and returns it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            f"rendering the mask panels needs matplotlib: {exc}") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(centers), 2, figsize=(6, 3 * len(centers)),
                             squeeze=False)
    for row, center in enumerate(centers):
        center = tuple(int(c) for c in center)
        raw = img_io.get_patch(img, center, patch)
        start = [c - p // 2 for c, p in zip(center, patch)]
        mask = make_skeleton_mask(points, start, patch, dilate=dilate)
        rp = raw.max(axis=0).astype(float)
        rp = rp / max(rp.max(), 1)
        rgb = np.stack([rp] * 3, axis=-1)
        rgb[..., 0] = np.clip(rgb[..., 0] + 0.6 * mask.max(axis=0), 0, 1)
        axes[row][0].imshow(rp, cmap="gray")
        axes[row][0].set_title(f"raw @ {center}")
        axes[row][1].imshow(rgb)
        axes[row][1].set_title("skeleton overlay")
        for ax in axes[row]:
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--img", required=True)
    p.add_argument("--swc", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=6)
    p.add_argument("--patch", type=int, nargs=3, default=(64, 64, 64))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    img = img_io.read(args.img)
    traces = Reader().read(args.swc)
    points = np.concatenate(
        [to_voxels(d["xyz"]) for d in traces.values()], axis=0)
    centers = pick_examples(points, img.shape[-3:], tuple(args.patch),
                            args.n, seed=args.seed)
    render(img, points, centers, tuple(args.patch), args.out)
    print(f"wrote {args.out}")
    return centers


if __name__ == "__main__":
    main()
