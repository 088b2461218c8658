"""Average the params of several scored checkpoints into one (SWA-style).

Counterpart of ``scripts/ckpt_average.py``: floating leaves are averaged
in float64 and cast back to their dtype, other leaves come from the first
checkpoint; the result takes the largest ``step``, the mean ``score`` and
``extra.averaged_from`` (the input file names). Checkpoints that disagree
on the model config or the transform raise. It works on the Flax tree of
numpy arrays that :func:`~exaspim_tpu_torch.train.checkpoint.load_checkpoint`
returns, so it needs no device.

    python -m exaspim_tpu_torch.ckpt_average out.ckpt in1.ckpt in2.ckpt [...]
"""

from __future__ import annotations

import argparse
import os
from collections.abc import Mapping

import numpy as np

__all__ = ["main", "average_trees"]


def average_trees(trees):
    """The leafwise mean of Flax trees of one structure (see the module
    docstring for which leaves are averaged)."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: average_trees([t[k] for t in trees]) for k in first}
    dtype = np.asarray(first).dtype
    if not np.issubdtype(dtype, np.floating):
        return first
    total = sum(np.asarray(v, np.float64) for v in trees)
    return (total / len(trees)).astype(dtype)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out")
    p.add_argument("ckpts", nargs="+")
    args = p.parse_args(argv)

    from exaspim_tpu_torch.train.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )

    loaded = [load_checkpoint(c) for c in args.ckpts]
    cfg0, t0 = loaded[0]["model_config"], loaded[0]["transform"]
    for c, d in zip(args.ckpts[1:], loaded[1:]):
        if d["model_config"] != cfg0 or d["transform"] != t0:
            raise ValueError(f"checkpoint {c} disagrees on config")
    n = len(loaded)
    save_checkpoint(
        args.out, average_trees([d["params"] for d in loaded]), cfg0, t0,
        step=max(int(d.get("step") or 0) for d in loaded),
        score=float(np.mean([float(d.get("score") or 0.0)
                             for d in loaded])),
        extra={"averaged_from": [os.path.basename(c) for c in args.ckpts]},
    )
    print(f"averaged {n} checkpoints -> {args.out}")


if __name__ == "__main__":
    main()
