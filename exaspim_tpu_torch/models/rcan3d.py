"""3D-RCAN, the residual channel-attention denoiser, in PyTorch.

Follows ``build_rcan`` of 3D-RCAN (Chen et al., *Nature Methods* 18:678–687,
2021; github.com/AiviaCommunity/3D-RCAN, ``rcan/model.py``), whose block is
the residual channel-attention block (RCAB) of Zhang et al., ECCV 2018::

    x0 = conv(2·u − 1; 1 → C)                       # _standardize
    g  = x0
    for each of G residual groups:                  # short skip s = g
        h = g
        for each of R RCABs:                        # skip k = h
            y = conv(relu(conv(h)))
            a = sigmoid(W_up · relu(W_dn · mean_zyx(y) + c_dn) + c_up)
            h = k + residual_scaling · a ⊙ y
        g = s + conv(h)
    t = x0 + conv(g)                                # the long skip
    out = (conv(t; C → 1) + 1) / 2                  # _destandardize

Every conv is 3³ SAME with a bias, at full resolution; ``W_dn`` maps C to
C / ``channel_reduction``.

The port's conventions, as in :mod:`exaspim_tpu_torch.models.unet3d`:
channels-last ``(B, D, H, W, C)``, compute in ``dtype`` (bf16 on the card)
with f32 master parameters, 3³ taps ``(27, Cin, Cout)`` through
:class:`~exaspim_tpu_torch.models.unet3d.Conv3` (the Hopper kernel on the
card), and the attention's 1×1 maps ``(Cin, Cout)`` matrices with biases (a
checkpoint stores them as ``(1, 1, 1, Cin, Cout)``). Submodules are named
like a Flax tree (``ResidualGroup_1.RCAB_2.ChannelAttention_0.Conv_0``;
the entry, trunk and exit convs ``Conv_0``, ``Conv_1``, ``Conv_2``).

The attention's pooled mean is the RCAB's second conv's Σ(y + β), from the
kernel's statistics epilogue, over the voxels: no pass re-reads the
activation. The standardisation, the attention's maps and the output are
f32; the scale and the residual add are one pass. ``counters["attention"]``
counts attentions.
Spans (:func:`~exaspim_tpu_torch.utils.profiling.span`): ``rcan.group``
around each residual group with its tail conv, ``rcan.attention`` around
each attention, from the pool to the residual add.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from exaspim_tpu_torch.models.unet3d import Conv3
from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
from exaspim_tpu_torch.utils.profiling import span

__all__ = ["RCAN3D", "ChannelAttention", "counters"]

counters = {"attention": 0}


def _glorot_uniform_(p, fan_in, fan_out, generator):
    """Keras's default kernel initialiser, in place."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    p.copy_(torch.empty(p.shape).uniform_(-limit, limit, generator=generator))


class Dense(nn.Module):
    """A 1×1 map: f32 ``kernel (Cin, Cout)`` and ``bias (Cout,)``."""

    def __init__(self, cin, cout):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, m):
        return torch.addmm(self.bias, m, self.kernel)


class ChannelAttention(nn.Module):
    """The per-(batch, channel) f32 scales ``sigmoid(W_up · relu(W_dn · m +
    c_dn) + c_up)`` of the ``(B, C)`` means ``m`` of an activation."""

    def __init__(self, channels, reduction):
        super().__init__()
        self.Conv_0 = Dense(channels, channels // reduction)
        self.Conv_1 = Dense(channels // reduction, channels)

    def forward(self, mean):
        counters["attention"] += 1
        return torch.sigmoid(self.Conv_1(torch.relu(self.Conv_0(mean))))


class RCAB(nn.Module):
    """conv → ReLU → conv, scaled per channel by its attention, plus the
    block's input."""

    def __init__(self, channels, reduction, residual_scaling, dtype):
        super().__init__()
        self.residual_scaling = float(residual_scaling)
        self.Conv_0 = Conv3(channels, channels, dtype, bias=True)
        self.Conv_1 = Conv3(channels, channels, dtype, bias=True)
        self.ChannelAttention_0 = ChannelAttention(channels, reduction)

    def forward(self, h):
        y = torch.relu_(self.Conv_0(h, stats=False))
        y, s1, _ = self.Conv_1(y)
        with span("rcan.attention"):
            a = self.ChannelAttention_0(s1 / (y.shape[1] * y.shape[2]
                                              * y.shape[3]))
            if self.residual_scaling != 1.0:
                a = a * self.residual_scaling
            return torch.addcmul(h, y, a[:, None, None, None, :].to(y.dtype))


class ResidualGroup(nn.Module):
    """``num_blocks`` RCABs and a 3³ conv, plus the group's input."""

    def __init__(self, channels, num_blocks, reduction, residual_scaling,
                 dtype):
        super().__init__()
        self.num_blocks = int(num_blocks)
        for j in range(self.num_blocks):
            setattr(self, f"RCAB_{j}",
                    RCAB(channels, reduction, residual_scaling, dtype))
        self.Conv_0 = Conv3(channels, channels, dtype, bias=True)

    def forward(self, g):
        with span("rcan.group"):
            h = g
            for j in range(self.num_blocks):
                h = getattr(self, f"RCAB_{j}")(h)
            return g + self.Conv_0(h, stats=False)


class RCAN3D(nn.Module):
    """3D-RCAN: ``(B, D, H, W, 1)`` f32 in the transform domain in, the
    same shape f32 out. The defaults are the source's published ones."""

    def __init__(self, num_channels=32, num_residual_groups=5,
                 num_residual_blocks=3, channel_reduction=8,
                 residual_scaling=1.0, dtype=torch.float32):
        super().__init__()
        c = int(num_channels)
        if c % int(channel_reduction):
            raise ValueError(f"channel_reduction {channel_reduction} does "
                             f"not divide num_channels {c}")
        self.config = {
            "model": type(self).__name__,
            "num_channels": c,
            "num_residual_groups": int(num_residual_groups),
            "num_residual_blocks": int(num_residual_blocks),
            "channel_reduction": int(channel_reduction),
            "residual_scaling": float(residual_scaling),
        }
        self.dtype = dtype
        self.num_groups = int(num_residual_groups)
        self.Conv_0 = Conv3(1, c, dtype, bias=True)
        for i in range(self.num_groups):
            setattr(self, f"ResidualGroup_{i}", ResidualGroup(
                c, num_residual_blocks, channel_reduction, residual_scaling,
                dtype))
        self.Conv_1 = Conv3(c, c, dtype, bias=True)
        self.Conv_2 = Conv3(c, 1, dtype, bias=True)

    def init_weights(self, seed=0):
        """Keras's defaults, as the source builds its layers: kernels
        Glorot-uniform (fan-in and fan-out 27·C of a 3³ conv, C of a 1×1
        map), biases 0; drawn from ``torch.Generator(seed)``."""
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith("kernel"):
                    taps = 27 if p.dim() == 3 else 1
                    _glorot_uniform_(p, taps * p.shape[-2],
                                     taps * p.shape[-1], gen)
                else:
                    p.zero_()
        return self

    def forward(self, x):
        x0 = self.Conv_0((2.0 * x - 1.0).to(self.dtype), stats=False)
        g = x0
        for i in range(self.num_groups):
            g = getattr(self, f"ResidualGroup_{i}")(g)
        t = x0 + self.Conv_1(g, stats=False)
        # The exit conv's bias and the destandardisation in f32.
        y = nb_conv3d(t, self.Conv_2.taps())
        return (0.5 * (y.float() + self.Conv_2.bias) + 0.5).to(x.dtype)

