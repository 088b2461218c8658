"""Residual 3D U-Net denoiser ("BM4DNet") in PyTorch, inference only.

Counterpart of ``exaspim_tpu/models/unet3d.py`` (``UNet:592``): a
4-down/4-up residual U-Net with GroupNorm(gcd(8, C)) + LeakyReLU(0.01)
double-conv blocks, trilinear ×2 upsampling, a 1×1×1 head with bias and
``output = input + logits``.

Activations are channels-last ``(B, D, H, W, C)``, as in the reference.
Every 3³ conv goes through :func:`exaspim_tpu_torch.ops.nb_conv.nb_conv3d_stats`
(the Hopper kernel on the card): the conv emits Σy/Σy² of its rounded
output and the following GroupNorm skips its own reduction. Submodule and
parameter names mirror the Flax tree (``DoubleConv_0.Conv_0.kernel``,
``Up_1.DoubleConv_0.GroupNorm_1.scale``, head ``Conv_0``), so
:func:`exaspim_tpu_torch.train.checkpoint.params_from_flax` is a rename.
3³ taps are stored pre-packed as ``(27, Cin, Cout)`` in the compute dtype,
so loading a state dict packs them once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_stats

__all__ = [
    "UNet",
    "build_model",
    "MODEL_REGISTRY",
    "group_norm",
    "max_pool3d",
    "resize_trilinear",
    "linear_resize_matrix",
]


def _norm_groups(channels):
    return math.gcd(8, channels)


def group_norm(x, scale, bias, num_groups, stats=None, eps=1e-5):
    """GroupNorm over the channel axis of ``(B, D, H, W, C)``.

    Statistics in f32 with the reference's formula: per-channel E[x] and
    E[x²], group means of both, var = max(E[x²] − E[x]², 0)
    (``unet3d.py:293-300``). ``stats = (Σx, Σx²)`` per ``(B, C)``, when the
    conv already produced them, replaces the reduction over the tensor.
    The affine runs in f32 and the result is cast to ``x.dtype``.
    """
    b, c = x.shape[0], x.shape[-1]
    n = x.shape[1] * x.shape[2] * x.shape[3]
    xf = x.float()
    if stats is None:
        s1, s2 = xf.sum(dim=(1, 2, 3)), (xf * xf).sum(dim=(1, 2, 3))
    else:
        s1, s2 = stats
    g = num_groups
    mean_g = (s1 / n).reshape(b, g, c // g).mean(dim=-1, keepdim=True)
    m2_g = (s2 / n).reshape(b, g, c // g).mean(dim=-1, keepdim=True)
    var_g = torch.clamp(m2_g - mean_g * mean_g, min=0.0)
    inv = torch.rsqrt(var_g + eps)
    sc = scale.float().reshape(1, g, c // g)
    a_c = (inv * sc).reshape(b, c)
    b_c = bias.float().reshape(1, c) - (mean_g * inv * sc).reshape(b, c)
    y = xf * a_c[:, None, None, None, :] + b_c[:, None, None, None, :]
    return y.to(x.dtype)


def max_pool3d(x):
    """2³ stride-2 VALID max pool over NDHWC; odd trailing slabs drop."""
    b, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    x = x[:, :2 * d2, :2 * h2, :2 * w2]
    x = x.reshape(b, d2, 2, h2, 2, w2, 2, c)
    return x.amax(dim=(2, 4, 6))


@functools.lru_cache(maxsize=128)
def linear_resize_matrix(n_in, n_out, align_corners=False):
    """(n_out, n_in) 1-D linear-interpolation matrix (numpy f32).

    ``align_corners=False``: half-pixel centers with edge clamp (the
    reference's production default, ``unet3d.py:425``).
    """
    if n_in == 0 or n_out == 0:
        return np.zeros((n_out, n_in), np.float32)
    if n_in == 1:
        return np.ones((n_out, 1), np.float32)
    if align_corners:
        src = np.arange(n_out) * (n_in - 1) / max(n_out - 1, 1)
    else:
        src = np.clip(
            (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0, n_in - 1
        )
    i0 = np.minimum(np.floor(src).astype(int), n_in - 2)
    w = (src - i0).astype(np.float32)
    mat = np.zeros((n_out, n_in), np.float32)
    mat[np.arange(n_out), i0] = 1.0 - w
    mat[np.arange(n_out), i0 + 1] = w
    return mat


def resize_trilinear(x, target, align_corners=False):
    """Trilinear resize of NDHWC ``x`` to spatial ``target``: three
    separable matmuls with the interpolation matrices in ``x.dtype``."""
    mats = [
        torch.from_numpy(
            linear_resize_matrix(x.shape[ax + 1], t, bool(align_corners))
        ).to(device=x.device, dtype=x.dtype)
        for ax, t in enumerate(target)
    ]
    x = torch.einsum("ij,bjhwc->bihwc", mats[0], x)
    x = torch.einsum("ij,bdjwc->bdiwc", mats[1], x)
    x = torch.einsum("ij,bdhjc->bdhic", mats[2], x)
    return x


class Conv3(nn.Module):
    """3³ SAME conv without bias; taps pre-packed ``(27, Cin, Cout)``.

    Takes one tensor or a ``(skip, up)`` pair of channel segments and
    returns ``(y, Σy, Σy²)``.
    """

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.kernel = nn.Parameter(
            torch.zeros(27, cin, cout, dtype=dtype), requires_grad=False
        )

    def forward(self, xs):
        return nb_conv3d_stats(xs, self.kernel)


class GroupNorm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.num_groups = _norm_groups(channels)
        self.scale = nn.Parameter(torch.ones(channels), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(channels), requires_grad=False)

    def forward(self, x, stats=None):
        return group_norm(x, self.scale, self.bias, self.num_groups, stats)


class DoubleConv(nn.Module):
    """(3³ conv → GroupNorm(gcd(8, C)) → LeakyReLU 0.01) × 2."""

    def __init__(self, cin, out_channels, mid_channels=None,
                 dtype=torch.float32):
        super().__init__()
        mid = mid_channels or out_channels
        self.Conv_0 = Conv3(cin, mid, dtype)
        self.GroupNorm_0 = GroupNorm(mid)
        self.Conv_1 = Conv3(mid, out_channels, dtype)
        self.GroupNorm_1 = GroupNorm(out_channels)

    def forward(self, xs):
        for conv, norm in ((self.Conv_0, self.GroupNorm_0),
                           (self.Conv_1, self.GroupNorm_1)):
            y, s1, s2 = conv(xs)
            xs = nn.functional.leaky_relu(norm(y, (s1, s2)), 0.01)
        return xs


class Up(nn.Module):
    """Trilinear ×2, centered pad to the skip's shape, DoubleConv over the
    segments ``[skip, up]`` (the concat is never built on the card)."""

    def __init__(self, c_skip, c_up, out_channels, align_corners=False,
                 dtype=torch.float32):
        super().__init__()
        cat = c_skip + c_up
        self.align_corners = align_corners
        self.DoubleConv_0 = DoubleConv(cat, out_channels, cat // 2, dtype)

    def forward(self, x, skip):
        x = resize_trilinear(x, tuple(2 * s for s in x.shape[1:4]),
                             self.align_corners)
        pads = []
        for axis in (3, 2, 1):  # F.pad lists the last axis first
            diff = skip.shape[axis] - x.shape[axis]
            pads += [diff // 2, diff - diff // 2]
        if any(pads):
            x = nn.functional.pad(x, [0, 0] + pads)
        return self.DoubleConv_0((skip, x.contiguous()))


class UNet(nn.Module):
    """Residual 3D U-Net: ``(B, D, H, W, 1)`` f32 in, ``x + logits`` out.

    ``dtype`` is the compute dtype (bf16 on the card); GroupNorm
    statistics and the residual stay f32.
    """

    def __init__(self, width_multiplier=1.0, trilinear=True,
                 base_channels=(32, 64, 128, 256, 512), head_init="zeros",
                 align_corners=False, residual=True, conv_bias=False,
                 dtype=torch.float32):
        super().__init__()
        if not trilinear or conv_bias or not residual:
            raise NotImplementedError(
                "the port runs trilinear, bias-free, residual UNets; the "
                "transposed-conv Up, conv_bias and residual=False wait for "
                "a later slice"
            )
        chans = [int(c * width_multiplier) for c in base_channels]
        if any(c <= 0 for c in chans):
            raise ValueError(
                f"width_multiplier={width_multiplier} collapses a stage")
        self.config = {
            "model": "UNet",
            "width_multiplier": width_multiplier,
            "trilinear": trilinear,
            "base_channels": list(base_channels),
            "head_init": head_init,
            "align_corners": align_corners,
            "residual": residual,
            "conv_bias": conv_bias,
        }
        self.dtype = dtype
        c1, c2, c3, c4, c5 = chans
        self.DoubleConv_0 = DoubleConv(1, c1, dtype=dtype)
        self.DoubleConv_1 = DoubleConv(c1, c2, dtype=dtype)
        self.DoubleConv_2 = DoubleConv(c2, c3, dtype=dtype)
        self.DoubleConv_3 = DoubleConv(c3, c4, dtype=dtype)
        self.DoubleConv_4 = DoubleConv(c4, c5 // 2, dtype=dtype)
        ac = align_corners
        self.Up_0 = Up(c4, c5 // 2, c4 // 2, ac, dtype)
        self.Up_1 = Up(c3, c4 // 2, c3 // 2, ac, dtype)
        self.Up_2 = Up(c2, c3 // 2, c2 // 2, ac, dtype)
        self.Up_3 = Up(c1, c2 // 2, c1, ac, dtype)
        self.Conv_0 = nn.Module()  # 1×1×1 head: kernel (c1, 1), bias (1,)
        self.Conv_0.kernel = nn.Parameter(torch.zeros(c1, 1),
                                          requires_grad=False)
        self.Conv_0.bias = nn.Parameter(torch.zeros(1), requires_grad=False)

    def forward(self, x):
        xin = x
        x = x.to(self.dtype)
        s1 = self.DoubleConv_0(x)
        s2 = self.DoubleConv_1(max_pool3d(s1))
        s3 = self.DoubleConv_2(max_pool3d(s2))
        s4 = self.DoubleConv_3(max_pool3d(s3))
        x = self.DoubleConv_4(max_pool3d(s4))
        x = self.Up_0(x, s4)
        x = self.Up_1(x, s3)
        x = self.Up_2(x, s2)
        x = self.Up_3(x, s1)
        dt = x.dtype
        logits = x @ self.Conv_0.kernel.to(dt) + self.Conv_0.bias.to(dt)
        return xin + logits.to(xin.dtype)


MODEL_REGISTRY = {"UNet": UNet}


def build_model(config, dtype=torch.float32, device="cuda"):
    """Rebuild a model from its checkpoint ``config`` dict on ``device``."""
    cfg = dict(config)
    name = cfg.pop("model", "UNet")
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; the port has {sorted(MODEL_REGISTRY)}"
        )
    if "base_channels" in cfg:
        cfg["base_channels"] = tuple(cfg["base_channels"])
    return MODEL_REGISTRY[name](dtype=dtype, **cfg).to(device).eval()
