"""Render a QA grid of cached patches (raw / teacher / foreground overlay).

Counterpart of ``scripts/visualize_patches.py`` (reference
scripts/visualize_patches.py): rank the patches by foreground occupancy,
draw a bounded pool of the fullest, and render each as max projections of
raw and teacher beside the foreground mask tinted over the raw.

Usage:
    python -m exaspim_tpu_torch.visualize_patches --cache /c/train \\
        --out grid.png [--n 8] [--seed 0]

matplotlib is imported by :func:`render` alone: the module imports where
matplotlib is missing, and rendering there raises ``ImportError``.
"""

from __future__ import annotations

import argparse

import numpy as np

from exaspim_tpu_torch.data.cache import CachedPatchDataset

__all__ = ["pick_indices", "stretch", "overlay", "render", "main"]


def pick_indices(ds, n, seed=0, pool_factor=4):
    """``n`` sorted indices drawn without replacement from the
    ``n · pool_factor`` patches of highest foreground occupancy
    (reference visualize_patches.py:78-118)."""
    occ = [ds[i][2].mean() for i in range(len(ds))]
    pool = np.argsort(occ)[::-1][:max(n * pool_factor, n)]
    rng = np.random.default_rng(seed)
    return sorted(rng.choice(pool, size=min(n, len(pool)),
                             replace=False).tolist())


def stretch(img, lo_pct=1.0, hi_pct=99.5):
    """Map the ``[lo_pct, hi_pct]`` percentile range to [0, 1], clipped."""
    lo, hi = np.percentile(img, [lo_pct, hi_pct])
    return np.clip((img - lo) / max(hi - lo, 1e-6), 0, 1)


def overlay(raw_proj, fg_proj):
    """Tint the foreground red over a grayscale projection."""
    rgb = np.stack([raw_proj] * 3, axis=-1)
    rgb[..., 0] = np.clip(rgb[..., 0] + 0.5 * fg_proj, 0, 1)
    return rgb


def render(ds, indices, out_path):
    """One row per index: raw, teacher, foreground overlay (z max
    projections); writes ``out_path`` and returns it."""
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError(
            f"rendering the patch grid needs matplotlib: {exc}") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(len(indices), 3, figsize=(9, 3 * len(indices)),
                             squeeze=False)
    for row, i in enumerate(indices):
        raw, teacher, fg = ds[i]
        rp = stretch(raw.max(axis=0).astype(float))
        tp = stretch(teacher.max(axis=0).astype(float))
        panels = ((rp, "gray", f"#{i} raw"), (tp, "gray", "teacher"),
                  (overlay(rp, fg.max(axis=0).astype(float)), None,
                   "fg overlay"))
        for ax, (im, cmap, title) in zip(axes[row], panels):
            ax.imshow(im, cmap=cmap)
            ax.set_title(title)
            ax.axis("off")
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--cache", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--n", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    ds = CachedPatchDataset(args.cache)
    idx = pick_indices(ds, args.n, seed=args.seed)
    print(f"rendering patches {idx}")
    render(ds, idx, args.out)
    print(f"wrote {args.out}")
    return idx


if __name__ == "__main__":
    main()
