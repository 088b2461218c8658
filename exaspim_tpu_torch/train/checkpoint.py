"""Read ``exaspim_tpu.ckpt.v1`` checkpoints and carry the weights to torch.

Counterpart of ``exaspim_tpu/train/checkpoint.py:68 load_checkpoint``. The
file is Flax msgpack; it is decoded by the package's own pure-Python
reader (:mod:`exaspim_tpu_torch._msgpack`), so neither ``flax`` nor
``msgpack`` is needed. Saving checkpoints comes with the training slice.
"""

from __future__ import annotations

import json
from collections.abc import Mapping

import numpy as np
import torch

from exaspim_tpu_torch._msgpack import unpackb

__all__ = ["load_checkpoint", "params_from_flax", "restore_pipeline"]


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
    ``(Cin, 1)``. Values stay f32; ``load_state_dict`` casts the conv taps
    to the model's compute dtype, so the packing happens once, here.
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


def restore_pipeline(path, dtype=torch.bfloat16, device="cuda"):
    """Rebuild ``(model, transform)`` from a checkpoint, ready for
    :func:`exaspim_tpu_torch.inference.predict`."""
    from exaspim_tpu_torch.models import build_model
    from exaspim_tpu_torch.transforms import build_transform

    ckpt = load_checkpoint(path)
    model = build_model(ckpt["model_config"], dtype=dtype, device=device)
    model.load_state_dict(params_from_flax(ckpt["params"]))
    return model, build_transform(ckpt["transform"])
