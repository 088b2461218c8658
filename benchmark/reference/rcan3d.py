"""The plain reference of 3D-RCAN: ``build_rcan`` of 3D-RCAN (Chen et al.,
*Nature Methods* 18:678–687, 2021; github.com/AiviaCommunity/3D-RCAN,
``rcan/model.py``) in float32 ``torch`` operations (NCDHW, ``F.conv3d``
with its bias), with no kernel, statistics or batching of the program.

The input is standardised to ``2u − 1`` and goes through a 3³ entry conv;
``num_residual_groups`` groups of ``num_residual_blocks`` residual
channel-attention blocks (conv, ReLU, conv; the channel attention of
Zhang et al., ECCV 2018: the mean over the voxels, a 1×1 map down by
``channel_reduction``, ReLU, a 1×1 map up, sigmoid; times
``residual_scaling``; plus the block's input), each group closed by a 3³
conv and its skip; the trunk's 3³ conv and the long skip; a 3³ exit conv
to one channel and ``(y + 1) / 2``. Every conv has a bias.

Departures from the source, each the product's and not the model's:

* the input ``u`` is the checkpoint's asinh transform domain of the raw
  counts (about −0.05 to 0.75 on the benchmark's volumes), where the
  source normalises each volume by its percentiles to about [0, 1];
* inference is tiled in 96³ isotropic patches (``reference/tiled.py``),
  where the source trains on 16 × 256 × 256 and predicts whole volumes:
  the attention's mean is then a patch's, not the volume's;
* the weights are a checkpoint trained on synthetic phantoms by this
  reference itself (``benchmark/train_rcan3d.py``; the configuration's ``assumed``
  gives the recipe), not a published model;
* the source's Keras layers run float32; the program computes in bf16.

Parameters are a flat dict of the Flax names (``ResidualGroup_0/RCAB_1/
ChannelAttention_0/Conv_0/kernel``) to tensors: 3³ taps DHWIO ``(3, 3, 3,
Cin, Cout)`` from a checkpoint or ``(27, Cin, Cout)`` from the seed (the
same numbers in the same order), 1×1 maps ``(1, 1, 1, Cin, Cout)`` or
``(Cin, Cout)``. ``quant`` is honoured as in ``reference/unet.py``:
:class:`~benchmark.reference.unet.Fp8` rounds every 3³ conv's input and
taps (the control's lower precision; biases, the attention and the adds
stay float32), :class:`~benchmark.reference.unet.Bf16` runs the whole
network in bfloat16 (a witness), the output in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import unet

# The models this reference computes (``references.py`` finds it by them).
MODELS = ("RCAN3D",)


def _conv(p, name, x, quant):
    w = p[f"{name}/kernel"]
    if w.dim() == 3:
        w = w.reshape(3, 3, 3, *w.shape[1:])
    w = w.permute(4, 3, 0, 1, 2)
    b = p[f"{name}/bias"]
    if quant is None or quant is unet.Bf16:
        return F.conv3d(x, w.to(x.dtype), b.to(x.dtype), padding=1)
    y = quant.output(F.conv3d(quant.input(x), quant.input(w), padding=1))
    return y + b.reshape(1, -1, 1, 1, 1)


def _map(p, name, m):
    """A 1×1 map of the ``(B, C)`` means."""
    w = p[f"{name}/kernel"]
    w = w.reshape(w.shape[-2], w.shape[-1])
    return m @ w.to(m.dtype) + p[f"{name}/bias"].to(m.dtype)


def forward(p, x, model_cfg, quant=None):
    """``x``: ``(B, 1, D, H, W)`` float32 in the transform domain; returns
    the same shape, float32."""
    groups = int(model_cfg.get("num_residual_groups", 5))
    blocks = int(model_cfg.get("num_residual_blocks", 3))
    scaling = float(model_cfg.get("residual_scaling", 1.0))
    h = 2.0 * x - 1.0
    if quant is unet.Bf16:
        h = h.to(torch.bfloat16)
    x0 = _conv(p, "Conv_0", h, quant)
    g = x0
    for i in range(groups):
        h = g
        for j in range(blocks):
            blk = f"ResidualGroup_{i}/RCAB_{j}"
            y = _conv(p, f"{blk}/Conv_1",
                      F.relu(_conv(p, f"{blk}/Conv_0", h, quant)), quant)
            att = f"{blk}/ChannelAttention_0"
            m = F.relu(_map(p, f"{att}/Conv_0", y.mean(dim=(2, 3, 4))))
            a = torch.sigmoid(_map(p, f"{att}/Conv_1", m))
            h = h + scaling * a[:, :, None, None, None] * y
        g = g + _conv(p, f"ResidualGroup_{i}/Conv_0", h, quant)
    t = x0 + _conv(p, "Conv_1", g, quant)
    return 0.5 * _conv(p, "Conv_2", t, quant).float() + 0.5
