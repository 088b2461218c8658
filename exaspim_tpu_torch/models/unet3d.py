"""Residual 3D U-Net denoiser ("BM4DNet") in PyTorch.

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

Parameters are f32 masters, trainable, as in the reference
(``unet3d.py:163-172``): 3³ taps stored pre-packed as ``(27, Cin, Cout)``
and cast to the compute dtype on each call (the cast is differentiable;
under ``torch.inference_mode()`` the cast is cached until the taps change).
:meth:`UNet.init_weights` draws Flax's initialisers from a seed.
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
    "lecun_normal_",
]

# Flax's lecun_normal: a normal truncated to ±2σ whose σ is corrected by
# this factor so the truncated draw keeps variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t, fan_in, generator):
    """In-place Flax ``lecun_normal`` (truncated normal, fan_in scaling)."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


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
    """2³ stride-2 VALID max pool over NDHWC; odd trailing slabs drop.

    ``F.max_pool3d`` on the channels-last view: its gradient goes to one
    element per window, as XLA's ``reduce_window`` max does (``amax``
    would split it among ties, which bf16 makes common)."""
    y = nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), 2, 2)
    return y.permute(0, 2, 3, 4, 1).contiguous()


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
    """3³ SAME conv without bias; f32 taps pre-packed ``(27, Cin, Cout)``,
    cast to the compute ``dtype`` on each call.

    Takes one tensor or a ``(skip, up)`` pair of channel segments and
    returns ``(y, Σy, Σy²)``.
    """

    def __init__(self, cin, cout, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))
        self._cast = None  # (key, taps) cached under inference mode

    def taps(self):
        k = self.kernel
        if k.dtype == self.dtype:
            return k
        if not torch.is_inference_mode_enabled():
            return k.to(self.dtype)
        key = (k.data_ptr(), k._version, k.device)
        if self._cast is None or self._cast[0] != key:
            self._cast = (key, k.to(self.dtype))
        return self._cast[1]

    def forward(self, xs):
        return nb_conv3d_stats(xs, self.taps())


class GroupNorm(nn.Module):
    def __init__(self, channels):
        super().__init__()
        self.num_groups = _norm_groups(channels)
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

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
        self.Conv_0.kernel = nn.Parameter(torch.zeros(c1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(1))

    def init_weights(self, seed=0):
        """Flax's initialisers, drawn from ``torch.Generator(seed)``: 3³
        taps lecun_normal (fan_in 27·Cin), GroupNorm scale 1 and bias 0,
        head kernel zeros or lecun_normal (``head_init``), head bias 0.
        Equal to ``UNet.init`` in distribution, not in bits."""
        if self.config["head_init"] not in ("zeros", "normal"):
            raise ValueError(f"unknown head_init {self.config['head_init']!r}")
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                head = name == "Conv_0.kernel"
                if name.endswith("kernel") and not (
                        head and self.config["head_init"] == "zeros"):
                    # fan_in: Cin of the head, 27·Cin of a 3³ conv.
                    fan_in = p.shape[0] if head else 27 * p.shape[1]
                    p.copy_(lecun_normal_(torch.empty(p.shape), fan_in, gen))
                elif name.endswith("scale"):
                    p.fill_(1.0)
                else:
                    p.zero_()
        return self

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
