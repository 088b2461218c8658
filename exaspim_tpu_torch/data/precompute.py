"""Build the precomputed patch cache with BM4D teachers.

Counterpart of ``scripts/precompute.py``: writes ``raw.npy`` /
``teacher.npy`` / ``fg.npy`` memmaps plus ``transform.json`` and a
full-provenance ``config.json``. Patches are seeded per index
(``SeedSequence([seed + stream, index])``), and the teachers are computed
deterministically, so the output does not depend on scheduling.

Usage:
    python -m exaspim_tpu_torch.data.precompute --split train \\
        --out /cache/train --n 30000
    python -m exaspim_tpu_torch.data.precompute --split val --n 500 …

``--source synthetic`` (the default) runs hermetically on procedural
phantoms; teachers are BM4D (``exaspim_tpu_torch.ops.bm4d``) at
``--sigma-bm4d``, computed on ``--device`` (the card by default). The live
cloud source is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from exaspim_tpu_torch.data.cache import allocate_cache
from exaspim_tpu_torch.transforms import build_transform

__all__ = ["precompute", "main", "SEED_STREAMS", "DEFAULT_TRANSFORM"]

#: per-split seed streams
SEED_STREAMS = {"train": 0, "val": 1}

DEFAULT_TRANSFORM = {
    "kind": "asinh", "params": {"offset": 0.0, "scale": 60.0},
}

#: patches denoised between two writes to the cache
TEACHER_BATCH = 8


def precompute(out_dir, split="train", source="synthetic", config=None,
               n=500, patch=(64, 64, 64), sigma_bm4d=24.0, seed=42,
               transform_cfg=None, check_incoherence=True, bm4d_step=3,
               family="a", device="cuda"):
    """Generate ``n`` patches into ``out_dir`` fulfilling the cache
    contract; returns ``out_dir``."""
    transform_cfg = transform_cfg or DEFAULT_TRANSFORM
    if "calibrate" in transform_cfg:
        # Calibration must be resolved before caching so every consumer
        # reconstructs the same mapping.
        raise ValueError(
            "transform cfg must be frozen (no 'calibrate') for precompute"
        )
    build_transform(transform_cfg)  # validate
    if source != "synthetic":
        raise NotImplementedError(
            f"source {source!r}: sampling live cloud volumes comes with a "
            "later slice of the port; use source='synthetic'")

    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset
    from exaspim_tpu_torch.ops.bm4d import bm4d_batch

    stream = SEED_STREAMS[split]
    run_config = {
        "split": split, "source": source, "n": int(n),
        "patch_shape": list(patch), "sigma_bm4d": sigma_bm4d,
        "bm4d_step": int(bm4d_step),
        "seed": seed, "seed_stream": stream,
        "family": family,
        "check_incoherence": check_incoherence,
        "transform": transform_cfg, "count_dtype": "uint16",
        "brains_config": config,
    }
    raw, teacher, fg = allocate_cache(
        out_dir, n, patch, transform_cfg, config=run_config
    )
    ds = SyntheticPatchDataset(
        n=n, patch_shape=patch, seed=seed + stream, sigma_bm4d=sigma_bm4d,
        family=family,
    )
    t0 = time.time()
    for lo in range(0, n, TEACHER_BATCH):
        hi = min(lo + TEACHER_BATCH, n)
        pairs = [ds.raw_and_fg(i) for i in range(lo, hi)]
        raws = np.stack([p[0] for p in pairs])
        dens = bm4d_batch(raws.astype(np.float32), sigma_bm4d,
                          step=bm4d_step, device=device).cpu().numpy()
        teachers = np.clip(np.round(dens), 0, 65535).astype(np.uint16)
        for j, i in enumerate(range(lo, hi)):
            raw[i] = pairs[j][0]
            teacher[i] = teachers[j]
            fg[i] = pairs[j][1]
        if hi % 48 < TEACHER_BATCH or hi == n:
            rate = hi / (time.time() - t0)
            print(f"[{split}] {hi}/{n} patches ({rate:.2f}/s)", flush=True)
    raw.flush(), teacher.flush(), fg.flush()
    print(f"cache complete: {out_dir}")
    return out_dir


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--split", choices=("train", "val"), default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--source", choices=("synthetic", "live"),
                   default="synthetic")
    p.add_argument("--config", help="brain-spec JSON for the live source")
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--patch", type=int, nargs=3, default=(64, 64, 64))
    p.add_argument("--sigma-bm4d", type=float, default=24.0)
    p.add_argument("--bm4d-step", type=int, default=3,
                   help="BM4D reference-grid stride (3 is the default the "
                        "shipped checkpoint's cache was built with; 4 "
                        "thins the grid 2.4x at some cost in quality)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--family", choices=("a", "b", "mix"), default="a",
                   help="synthetic phantom family: a = default, b = "
                        "denser/dimmer/wider-PSF/low-pedestal, mix = "
                        "alternate per index")
    p.add_argument("--transform-json",
                   help="path to a frozen transform cfg JSON")
    p.add_argument("--device", default="cuda",
                   help="where the teachers are computed")
    args = p.parse_args(argv)
    tcfg = None
    if args.transform_json:
        with open(args.transform_json) as f:
            tcfg = json.load(f)
    precompute(
        args.out, split=args.split, source=args.source,
        config=args.config, n=args.n, patch=tuple(args.patch),
        sigma_bm4d=args.sigma_bm4d, seed=args.seed, transform_cfg=tcfg,
        bm4d_step=args.bm4d_step, family=args.family, device=args.device,
    )


if __name__ == "__main__":
    main()
