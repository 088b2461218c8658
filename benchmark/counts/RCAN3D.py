"""The 3³ convs of 3D-RCAN (``reference/rcan3d.py``), all at the input's
resolution: the entry conv (1 → C), two a residual channel-attention block
and one closing each residual group (C → C), the trunk's conv (C → C) and
the exit conv (C → 1); ``fwd`` for each, ``dx`` for all but the entry conv.
At the published widths (C 32, 5 groups of 3 blocks): 38 convs, 36 of them
32 → 32, 1.99 MFLOP a voxel forward. The channel attention's 1×1 maps act
on one mean a channel and are not counted."""

from __future__ import annotations


def conv_shapes(n, model_config):
    c = int(model_config.get("num_channels", 32))
    groups = int(model_config.get("num_residual_groups", 5))
    blocks = int(model_config.get("num_residual_blocks", 3))
    fwd = ([(n, (1,), c)] + [(n, (c,), c)] * (groups * (2 * blocks + 1) + 1)
           + [(n, (c,), 1)])
    out = [("fwd", *f) for f in fwd]
    out += [("dx", m, (cout,), sum(segs)) for m, segs, cout in fwd[1:]]
    return out
