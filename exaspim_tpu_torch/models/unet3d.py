"""3D U-Net denoisers ("BM4DNet") in PyTorch.

Counterpart of ``exaspim_tpu/models/unet3d.py`` (``UNet:592``,
``N2V2UNet:721``): a 4-down/4-up U-Net with GroupNorm(gcd(8, C)) +
LeakyReLU(0.01) double-conv blocks, trilinear or transposed-conv ×2
upsampling, a 1×1×1 head with bias and ``output = input + logits`` (or the
logits alone, ``residual=False``); and the Noise2Void2 variant, whose
encoder pools through MaxBlurPool and whose last ``Up`` has no skip.
Models imported from the reference's torch checkpoints carry a bias on
every 3³ conv (``conv_bias=True``).

Activations are channels-last ``(B, D, H, W, C)``, as in the reference.
Every 3³ conv goes through :func:`exaspim_tpu_torch.ops.nb_conv.nb_conv3d_stats`
(the Hopper kernel on the card): the conv emits Σy/Σy² of its rounded
output and the following GroupNorm skips its own reduction (a conv bias
is added after the kernel and shifts those sums algebraically). Submodule
and parameter names mirror the Flax tree (``DoubleConv_0.Conv_0.kernel``,
``Up_1.DoubleConv_0.GroupNorm_1.scale``, ``Up_0.ConvTranspose_0.kernel``,
head ``Conv_0``), so
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
    "N2V2UNet",
    "build_model",
    "MODEL_REGISTRY",
    "group_norm",
    "max_pool3d",
    "blur_pool3d",
    "max_blur_pool3d",
    "conv_transpose_2x",
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


def max_pool3d(x, window=2, stride=None):
    """``window``³ VALID max pool over NDHWC at ``stride`` (default the
    window); odd trailing slabs drop.

    ``F.max_pool3d`` on the channels-last view: its gradient goes to one
    element per window, as XLA's ``reduce_window`` max does (``amax``
    would split it among ties, which bf16 makes common)."""
    y = nn.functional.max_pool3d(x.permute(0, 4, 1, 2, 3), window,
                                 stride or window)
    return y.permute(0, 2, 3, 4, 1).contiguous()


def _binomial_kernel(n=3):
    """1-D binomial (Pascal-row) taps, normalised: ``[1, 2, 1] / 4``."""
    row = [math.comb(n - 1, k) for k in range(n)]
    return [r / sum(row) for r in row]


def blur_pool3d(x, stride=2):
    """Separable binomial 3³ blur at ``stride`` over NDHWC (anti-aliasing):
    replicate-pad once, then one 3-tap pass per spatial axis, each summed
    in f32 and rounded to ``x.dtype``, as the reference's three depthwise
    convs are (``unet3d.py:388``)."""
    taps = _binomial_kernel(3)
    x = nn.functional.pad(x.permute(0, 4, 1, 2, 3), [1] * 6,
                          mode="replicate").permute(0, 2, 3, 4, 1)
    for axis in (1, 2, 3):
        m = (x.shape[axis] - 3) // stride + 1
        span = stride * (m - 1) + 1
        xf = x.float()
        acc = sum(w * xf.narrow(axis, t, span)[
            (slice(None),) * axis + (slice(None, None, stride),)]
            for t, w in enumerate(taps))
        x = acc.to(x.dtype)
    return x.contiguous()


def max_blur_pool3d(x):
    """Anti-aliased downsampling (MaxBlurPool): a 2³ max at stride 1, then
    the binomial blur at stride 2 (``unet3d.py:418``)."""
    return blur_pool3d(max_pool3d(x, window=2, stride=1), stride=2)


def conv_transpose_2x(x, kernel, bias):
    """Flax's ``ConvTranspose(features, (2, 2, 2), strides=2)`` over NDHWC:
    ``out[2i+a, 2j+b, 2k+c] = x[i, j, k] @ kernel[1-a, 1-b, 1-c] + bias``
    (Flax correlates on the dilated input without flipping the kernel).
    ``kernel`` is ``(2, 2, 2, Cin, Cout)``; one ``(N, Cin) @ (Cin, 8·Cout)``
    product in ``x.dtype`` and a reshuffle."""
    b, d, h, w, cin = x.shape
    cout = kernel.shape[-1]
    wm = kernel.flip(0, 1, 2).permute(3, 0, 1, 2, 4).reshape(cin, 8 * cout)
    y = (x.reshape(-1, cin) @ wm.to(x.dtype)).reshape(b, d, h, w, 2, 2, 2,
                                                      cout)
    y = y.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, 2 * d, 2 * h, 2 * w,
                                                  cout)
    return y + bias.to(x.dtype)


def _pad_to(x, shape):
    """Zero-pad NDHWC ``x`` centred to the spatial ``shape`` (never crops:
    the encoder's sizes are at least the decoder's after rounding)."""
    pads = []
    for axis in (3, 2, 1):  # F.pad lists the last axis first
        diff = shape[axis - 1] - x.shape[axis]
        pads += [diff // 2, diff - diff // 2]
    if any(pads):
        x = nn.functional.pad(x, [0, 0] + pads)
    return x


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
    """3³ SAME conv; f32 taps pre-packed ``(27, Cin, Cout)``, cast to the
    compute ``dtype`` on each call, and an optional f32 ``bias``.

    Takes one tensor or a ``(skip, up)`` pair of channel segments and
    returns ``(y, Σy, Σy²)``. The kernel itself has no bias: ``y + β`` is
    added in the compute dtype after it, and its sums are shifted on the
    small ``(B, C)`` tensors, Σ(y+β) = Σy + nβ and
    Σ(y+β)² = Σy² + 2βΣy + nβ², as the JAX package's blocked path does
    (``unet3d.py:197-217``); no pass re-reads the activation.
    """

    def __init__(self, cin, cout, dtype=torch.float32, bias=False):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.zeros(27, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
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
        y, s1, s2 = nb_conv3d_stats(xs, self.taps())
        if self.bias is None:
            return y, s1, s2
        n = y.shape[1] * y.shape[2] * y.shape[3]
        beta = self.bias.float()
        s2 = s2 + 2.0 * beta * s1 + n * beta * beta
        s1 = s1 + n * beta
        return y + self.bias.to(y.dtype), s1, s2


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
                 dtype=torch.float32, bias=False):
        super().__init__()
        mid = mid_channels or out_channels
        self.Conv_0 = Conv3(cin, mid, dtype, bias)
        self.GroupNorm_0 = GroupNorm(mid)
        self.Conv_1 = Conv3(mid, out_channels, dtype, bias)
        self.GroupNorm_1 = GroupNorm(out_channels)

    def forward(self, xs):
        for conv, norm in ((self.Conv_0, self.GroupNorm_0),
                           (self.Conv_1, self.GroupNorm_1)):
            y, s1, s2 = conv(xs)
            xs = nn.functional.leaky_relu(norm(y, (s1, s2)), 0.01)
        return xs


class Up(nn.Module):
    """×2 upsample, centred pad to the skip's shape, DoubleConv over the
    segments ``[skip, up]`` (the concat is never built on the card).

    Trilinear (``trilinear=True``) keeps the channels and halves them in
    the mid conv (mid = cat // 2); the transposed conv (submodule
    ``ConvTranspose_0``, Flax's ``kernel (2, 2, 2, Cin, Cin // 2)`` and
    ``bias``) halves them itself and the DoubleConv's mid is its output.
    ``skip=False`` (N2V2's last ``Up``) upsamples and convolves one
    segment.
    """

    def __init__(self, c_skip, c_up, out_channels, align_corners=False,
                 dtype=torch.float32, trilinear=True, skip=True,
                 bias=False):
        super().__init__()
        self.align_corners = align_corners
        self.trilinear = trilinear
        self.skip = skip
        if not trilinear:
            self.ConvTranspose_0 = nn.Module()
            self.ConvTranspose_0.kernel = nn.Parameter(
                torch.zeros(2, 2, 2, c_up, c_up // 2))
            self.ConvTranspose_0.bias = nn.Parameter(torch.zeros(c_up // 2))
            c_up //= 2
        cat = (c_skip if skip else 0) + c_up
        mid = cat // 2 if trilinear else None
        self.DoubleConv_0 = DoubleConv(cat, out_channels, mid, dtype, bias)

    def forward(self, x, skip=None):
        if self.trilinear:
            x = resize_trilinear(x, tuple(2 * s for s in x.shape[1:4]),
                                 self.align_corners)
        else:
            ct = self.ConvTranspose_0
            x = conv_transpose_2x(x, ct.kernel, ct.bias)
        if not self.skip:
            return self.DoubleConv_0(x.contiguous())
        x = _pad_to(x, skip.shape[1:4])
        return self.DoubleConv_0((skip, x.contiguous()))


class UNet(nn.Module):
    """Residual 3D U-Net: ``(B, D, H, W, 1)`` f32 in, ``x + logits`` out
    (the logits alone with ``residual=False``, the value head that
    blind-spot training needs).

    ``dtype`` is the compute dtype (bf16 on the card); GroupNorm
    statistics and the residual stay f32. ``trilinear=False`` upsamples
    by transposed convs (the bottleneck is then c5 wide, not c5 / 2);
    ``conv_bias=True`` gives every 3³ conv a bias (checkpoints of the
    reference's torch format); ``align_corners=True`` is the reference's
    ``torch.nn.Upsample`` grid.
    """

    def __init__(self, width_multiplier=1.0, trilinear=True,
                 base_channels=(32, 64, 128, 256, 512), head_init="zeros",
                 align_corners=False, residual=True, conv_bias=False,
                 dtype=torch.float32):
        super().__init__()
        chans = [int(c * width_multiplier) for c in base_channels]
        if any(c <= 0 for c in chans):
            raise ValueError(
                f"width_multiplier={width_multiplier} collapses a stage")
        self.config = {
            "model": type(self).__name__,
            "width_multiplier": width_multiplier,
            "trilinear": trilinear,
            "base_channels": list(base_channels),
            "head_init": head_init,
            "align_corners": align_corners,
            "residual": residual,
            "conv_bias": conv_bias,
        }
        self.dtype = dtype
        self.residual = residual
        c1, c2, c3, c4, c5 = chans
        f = 2 if trilinear else 1
        cb = conv_bias
        self.DoubleConv_0 = DoubleConv(1, c1, dtype=dtype, bias=cb)
        self.DoubleConv_1 = DoubleConv(c1, c2, dtype=dtype, bias=cb)
        self.DoubleConv_2 = DoubleConv(c2, c3, dtype=dtype, bias=cb)
        self.DoubleConv_3 = DoubleConv(c3, c4, dtype=dtype, bias=cb)
        self.DoubleConv_4 = DoubleConv(c4, c5 // f, dtype=dtype, bias=cb)
        up = functools.partial(Up, align_corners=align_corners, dtype=dtype,
                               trilinear=trilinear, bias=cb)
        self.Up_0 = up(c4, c5 // f, c4 // f)
        self.Up_1 = up(c3, c4 // f, c3 // f)
        self.Up_2 = up(c2, c3 // f, c2 // f)
        self.Up_3 = self._last_up(up, c1, c2 // f)
        self.Conv_0 = nn.Module()  # 1×1×1 head: kernel (c1, 1), bias (1,)
        self.Conv_0.kernel = nn.Parameter(torch.zeros(c1, 1))
        self.Conv_0.bias = nn.Parameter(torch.zeros(1))

    @staticmethod
    def _last_up(up, c1, c_up):
        return up(c1, c_up, c1)

    def init_weights(self, seed=0):
        """Flax's initialisers, drawn from ``torch.Generator(seed)``: 3³
        taps lecun_normal (fan_in 27·Cin), transposed-conv kernels
        lecun_normal (fan_in 8·Cin), GroupNorm scale 1, head kernel zeros
        or lecun_normal (``head_init``), every bias 0. Equal to
        ``UNet.init`` in distribution, not in bits."""
        if self.config["head_init"] not in ("zeros", "normal"):
            raise ValueError(f"unknown head_init {self.config['head_init']!r}")
        gen = torch.Generator().manual_seed(int(seed))
        with torch.no_grad():
            for name, p in self.named_parameters():
                head = name == "Conv_0.kernel"
                if name.endswith("kernel") and not (
                        head and self.config["head_init"] == "zeros"):
                    # fan_in: Cin of the head, 8·Cin of a transposed
                    # conv (2, 2, 2, Cin, Cout), 27·Cin of a 3³ conv.
                    fan_in = (p.shape[0] if head else 8 * p.shape[3]
                              if p.dim() == 5 else 27 * p.shape[1])
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
        return self._head(x, xin)

    def _head(self, x, xin):
        dt = x.dtype
        logits = x @ self.Conv_0.kernel.to(dt) + self.Conv_0.bias.to(dt)
        if not self.residual:
            return logits.to(xin.dtype)
        return xin + logits.to(xin.dtype)


class N2V2UNet(UNet):
    """Noise2Void2 variant (``unet3d.py:721``): the encoder pools through
    :func:`max_blur_pool3d`, the last ``Up`` has no s1 skip, and the last
    activation is zero-padded back to the input's extent (centred) when the
    pools' rounding shrank it. The same parameters and names as
    :class:`UNet`; every 3³ conv, the encoder's too, runs the kernel."""

    @staticmethod
    def _last_up(up, c1, c_up):
        return up(0, c_up, c1, skip=False)

    def forward(self, x):
        xin = x
        x = x.to(self.dtype)
        s1 = self.DoubleConv_0(x)
        s2 = self.DoubleConv_1(max_blur_pool3d(s1))
        s3 = self.DoubleConv_2(max_blur_pool3d(s2))
        s4 = self.DoubleConv_3(max_blur_pool3d(s3))
        x = self.DoubleConv_4(max_blur_pool3d(s4))
        x = self.Up_0(x, s4)
        x = self.Up_1(x, s3)
        x = self.Up_2(x, s2)
        x = self.Up_3(x)
        return self._head(_pad_to(x, xin.shape[1:4]), xin)


MODEL_REGISTRY = {"UNet": UNet, "N2V2UNet": N2V2UNet}


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
