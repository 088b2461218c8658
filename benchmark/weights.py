"""Weights made from the seed, for a configuration whose ``weights`` is
``{"init": "seed"}`` (an architecture with no shipped checkpoint).

The benchmark draws every parameter itself, on the device, from one
``torch.Generator`` in one call, in the shapes of the port's model: a
leaf of two or more dimensions (a kernel: ``(27, Cin, Cout)`` taps, a
``(Cin, Cout)`` matrix) is normal with variance 1 / fan-in, fan-in its
size over its last dimension; a one-dimensional leaf named ``scale`` is
1 + 0.1·N(0, 1); any other (a bias) 0.1·N(0, 1). The program is loaded
with these tensors and the reference is handed the same ones under its
flat names (dots of the port's names as slashes), so neither side takes
anything the other made.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import generate


def from_seed(config):
    """Whether the configuration's weights are drawn from the seed; a
    checkpoint's path is the other choice."""
    w = config["weights"]
    if isinstance(w, str):
        return False
    if w != {"init": "seed"}:
        raise ValueError(f"unknown weights {w!r}: a checkpoint's path or "
                         '{"init": "seed"}')
    return True


def seeded(model, seed, device):
    """``{port name: float32 tensor}`` for every parameter of ``model``,
    drawn from ``seed`` on ``device``."""
    shapes = [(name, tuple(p.shape)) for name, p in model.named_parameters()]
    total = sum(math.prod(s) for _, s in shapes)
    z = torch.randn(total, generator=generate.generator(
        generate.sub_seed(seed, 11), device), device=device)
    out, off = {}, 0
    for name, shape in shapes:
        k = math.prod(shape)
        v = z[off:off + k].view(shape)
        off += k
        if len(shape) >= 2:
            v = v / math.sqrt(k / shape[-1])
        elif name.endswith("scale"):
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        out[name] = v
    return out


def flat_names(params):
    """The reference's flat names of the port's parameters."""
    return {k.replace(".", "/"): v for k, v in params.items()}


def as_tree(params):
    """The nested ``{module: {leaf: numpy}}`` tree the program's trainer
    loads as pretrained parameters (shapes as they are)."""
    tree = {}
    for key, v in params.items():
        *path, leaf = key.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return tree
