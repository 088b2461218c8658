"""Estimate per-brain background pedestal offsets.

Counterpart of ``scripts/estimate_background_offsets.py``, with its flags:
read a coarse multiscale level of each brain of a brain-spec JSON (through
:mod:`exaspim_tpu_torch.utils.img_io`), take a low percentile of the
nonzero voxels, report the zero fraction and the spread of the offsets,
and write ``{brain_id: offset}`` JSON, which
``TrainDataset.ingest_brain(offset=)`` subtracts (the ``offset`` key of a
brain spec). Host work only (numpy).

Usage:
    python -m exaspim_tpu_torch.estimate_background_offsets \\
        --config brains.json --out offsets.json [--level 5] \\
        [--percentile 0.1]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from exaspim_tpu_torch.utils import img_io

__all__ = ["estimate_offset", "main"]


def estimate_offset(img_path, level=5, percentile=0.1):
    """Low percentile of nonzero voxels at a coarse level; returns
    (offset, zero_fraction)."""
    try:
        img = img_io.read(img_path, dataset=str(level))
    except Exception:
        img = img_io.read(img_path)
    arr = np.asarray(img)
    if arr.ndim == 5:
        arr = arr[0, 0]
    nz = arr[arr > 0]
    zero_frac = 1.0 - nz.size / max(arr.size, 1)
    if nz.size == 0:
        return 0.0, 1.0
    return float(np.percentile(nz, percentile)), float(zero_frac)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config", required=True,
                   help="brain-spec JSON: [{brain_id, img}, …]")
    p.add_argument("--out", required=True)
    p.add_argument("--level", type=int, default=5)
    p.add_argument("--percentile", type=float, default=0.1)
    args = p.parse_args(argv)

    with open(args.config) as f:
        brains = json.load(f)
    offsets = {}
    for spec in brains:
        brain_id = str(spec["brain_id"])
        try:
            offset, zero_frac = estimate_offset(
                spec["img"], level=args.level,
                percentile=args.percentile,
            )
            offsets[brain_id] = offset
            print(
                f"{brain_id}: offset={offset:.1f} "
                f"zero_frac={zero_frac:.3f}", flush=True,
            )
        except Exception as exc:  # keep going, brain by brain
            print(f"{brain_id}: FAILED ({exc})", flush=True)
    if offsets:
        vals = np.asarray(list(offsets.values()))
        print(
            f"spread: min={vals.min():.1f} max={vals.max():.1f} "
            f"median={np.median(vals):.1f} — "
            + ("one global offset is fine"
               if vals.max() - vals.min() < 0.2 * max(np.median(vals), 1)
               else "use per-brain offsets")
        )
    with open(args.out, "w") as f:
        json.dump(offsets, f, indent=2, sort_keys=True)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
