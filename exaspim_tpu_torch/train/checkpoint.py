"""Read and write ``exaspim_tpu.ckpt.v1`` checkpoints; carry weights
between the Flax param tree and the port's state dict.

Counterpart of ``exaspim_tpu/train/checkpoint.py:38-116``. The file is
Flax msgpack, written and read by the package's own pure-Python codec
(:mod:`exaspim_tpu_torch._msgpack`), so neither ``flax`` nor ``msgpack``
is needed, and checkpoints swap both ways with the JAX package. Scored
checkpoints are named ``BM4DNet-<date>-<step>-<score>.ckpt`` (lower is
better). Full-state (optimizer) checkpoints for resume are later work.
"""

from __future__ import annotations

import json
import os
import re
from collections.abc import Mapping
from datetime import datetime

import numpy as np
import torch

from exaspim_tpu_torch._msgpack import packb, unpackb

__all__ = [
    "checkpoint_filename",
    "save_checkpoint",
    "load_checkpoint",
    "find_best_checkpoint",
    "params_from_flax",
    "params_to_flax",
    "restore_pipeline",
]

_SCORE_RE = re.compile(
    r"BM4DNet-\d{8}(?:_\d{4,6})?-(\d+)-(-?\d+(?:\.\d+)?)\.ckpt$"
)


def checkpoint_filename(step, score, date=None):
    """``BM4DNet-<date>-<step>-<score>.ckpt`` (lower score = better)."""
    date = date or datetime.now().strftime("%Y%m%d")
    return f"BM4DNet-{date}-{int(step)}-{float(score):.6f}.ckpt"


def save_checkpoint(path, params, model_config, transform_cfg, step=0,
                    score=None, extra=None):
    """Write a full pipeline checkpoint to one msgpack file, atomically.

    ``params`` is the port's state dict (tensors) or a Flax tree of numpy
    arrays; it is stored as the Flax tree, f32."""
    if not isinstance(next(iter(params.values())), Mapping):
        params = params_to_flax(params)
    payload = {
        "params": params,
        "meta": json.dumps({
            "model_config": model_config,
            "transform": transform_cfg,
            "step": int(step),
            "score": None if score is None else float(score),
            "extra": extra or {},
            "format": "exaspim_tpu.ckpt.v1",
        }),
    }
    blob = packb(payload)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)  # atomic publish
    return path


def load_checkpoint(path):
    """Load a checkpoint → ``{"params": <Flax tree of numpy arrays>,
    "model_config": ..., "transform": ..., "step": ..., ...}``."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    meta = json.loads(payload["meta"])
    return {"params": payload["params"], **meta}


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _flatten(v, key + ".")
        else:
            yield key, v


def params_from_flax(tree):
    """Map a Flax UNet param tree (numpy leaves) to the port's state dict.

    Names carry over as dotted paths (``DoubleConv_0/Conv_1/kernel`` →
    ``DoubleConv_0.Conv_1.kernel``); 3³ DHWIO kernels ``(3, 3, 3, Cin, Cout)``
    are packed to ``(27, Cin, Cout)`` and the 1×1×1 head kernel to
    ``(Cin, 1)``. Values stay f32, as the model's master params.
    """
    sd = {}
    for key, leaf in _flatten(tree):
        a = np.array(leaf, dtype=np.float32)  # a writable copy
        if key.endswith("kernel") and a.ndim == 5:
            kd = a.shape[:3]
            if kd == (3, 3, 3):
                a = a.reshape(27, a.shape[3], a.shape[4])
            elif kd == (1, 1, 1):
                a = a.reshape(a.shape[3], a.shape[4])
            else:
                raise ValueError(f"{key}: unsupported kernel shape {a.shape}")
        sd[key] = torch.from_numpy(a)
    return sd


def params_to_flax(state_dict):
    """Inverse of :func:`params_from_flax`: the port's state dict → the
    Flax param tree of f32 numpy arrays (``(27, Cin, Cout)`` taps back to
    DHWIO ``(3, 3, 3, Cin, Cout)``, the ``(Cin, 1)`` head to
    ``(1, 1, 1, Cin, 1)``)."""
    tree = {}
    for key, t in state_dict.items():
        a = t.detach().to("cpu", torch.float32).numpy().copy()
        if key.endswith("kernel"):
            a = a.reshape((3, 3, 3) + a.shape[1:] if a.ndim == 3
                          else (1, 1, 1) + a.shape)
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = a
    return tree


def find_best_checkpoint(directory):
    """Lowest-score checkpoint under ``directory`` (negative-aware)."""
    best_path, best_score = None, None
    for root, _, files in os.walk(directory):
        for name in files:
            m = _SCORE_RE.search(name)
            if not m:
                continue
            score = float(m.group(2))
            if best_score is None or score < best_score:
                best_path, best_score = os.path.join(root, name), score
    if best_path is None:
        raise FileNotFoundError(
            f"no scored checkpoints under {directory!r}"
        )
    return best_path


def restore_pipeline(path, dtype=torch.bfloat16, device="cuda"):
    """Rebuild ``(model, transform)`` from a checkpoint, ready for
    :func:`exaspim_tpu_torch.inference.predict`."""
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.transforms import build_transform

    ckpt = load_checkpoint(path)
    model = build_model(ckpt["model_config"], dtype=dtype, device=device)
    model.load_state_dict(params_from_flax(ckpt["params"]))
    return model, build_transform(ckpt["transform"])
