"""The plain reference of the models: the U-Net denoisers in float32
``torch`` operations (NCDHW, ``F.conv3d``), with no kernel, cache or
batching of the program, and the checkpoint's transform.

It follows the upstream ``unet3d.py`` ``UNet`` as the port's docs
describe it: four 2³ max-pool downs, four trilinear ×2 ups (half-pixel
centres, edges clamped) with the skip concatenated first, every block two
3³ SAME convs without bias each followed by GroupNorm(gcd(8, C), ε 1e-5)
and LeakyReLU(0.01), a 1×1×1 head with bias and ``x + logits`` (the
logits alone with ``residual=False``).

Parameters are a flat dict of the Flax names (``DoubleConv_0/Conv_0/
kernel``) to tensors; Flax's DHWIO taps are used as ``(Cout, Cin, 3, 3,
3)``, and taps given as ``(27, Cin, Cout)`` (weights made from the seed in
the port's layout) hold the same numbers in the same order. ``quant``, when given (:class:`Fp8`), rounds every 3³ conv's
input, taps and output gradient (the control's lower precision);
:class:`Bf16` runs the whole network in bfloat16 instead (a witness of
what the configuration's precision alone reads, not a control).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# The models this reference computes (``references.py`` finds it by them).
MODELS = ("UNet",)


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _conv(p, name, x, quant):
    w = p[f"{name}/kernel"]
    if w.dim() == 3:
        w = w.reshape(3, 3, 3, *w.shape[1:])
    w = w.permute(4, 3, 0, 1, 2)
    if quant is None or quant is Bf16:
        return F.conv3d(x, w, padding=1)
    return quant.output(F.conv3d(quant.input(x), quant.input(w), padding=1))


def _double(p, name, x, quant):
    for i in (0, 1):
        x = _conv(p, f"{name}/Conv_{i}", x, quant)
        c = x.shape[1]
        # Statistics and affine in float32 whatever the activations' type.
        x = F.group_norm(x.float(), math.gcd(8, c),
                         p[f"{name}/GroupNorm_{i}/scale"].float(),
                         p[f"{name}/GroupNorm_{i}/bias"].float(),
                         eps=1e-5).to(x.dtype)
        x = F.leaky_relu(x, 0.01)
    return x


def _pad_to(x, shape):
    pads = []
    for axis in (4, 3, 2):
        diff = shape[axis - 2] - x.shape[axis]
        pads += [diff // 2, diff - diff // 2]
    return F.pad(x, pads) if any(pads) else x


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="trilinear",
                         align_corners=False)


def forward(p, x, model_cfg, quant=None):
    """``x``: ``(B, 1, D, H, W)`` float32 in the transform domain;
    ``model_cfg["residual"]`` (default True) adds the input back."""
    residual = model_cfg.get("residual", True)
    def pool(t):
        return F.max_pool3d(t, 2)

    xin = x
    if quant is Bf16:
        p = {k: v.to(torch.bfloat16) for k, v in p.items()}
        x = x.to(torch.bfloat16)
    s1 = _double(p, "DoubleConv_0", x, quant)
    s2 = _double(p, "DoubleConv_1", pool(s1), quant)
    s3 = _double(p, "DoubleConv_2", pool(s2), quant)
    s4 = _double(p, "DoubleConv_3", pool(s3), quant)
    h = _double(p, "DoubleConv_4", pool(s4), quant)
    for i, skip in enumerate((s4, s3, s2, s1)):
        h = _pad_to(_up(h), skip.shape[2:])
        h = _double(p, f"Up_{i}/DoubleConv_0", torch.cat([skip, h], 1), quant)
    k = p["Conv_0/kernel"].reshape(-1, 1)
    logits = (torch.einsum("bcdhw,co->bodhw", h, k)
              + p["Conv_0/bias"].reshape(1, 1, 1, 1, 1)).float()
    return xin + logits if residual else logits


class Asinh:
    """``y = asinh((x − offset)/scale) / asinh((max − offset)/scale)``."""

    def __init__(self, offset, scale, max_count=65535.0):
        self.offset, self.scale, self.max = offset, scale, max_count
        self.norm = math.asinh((max_count - offset) / scale)

    def forward(self, counts):
        return torch.asinh((counts - self.offset) / self.scale) / self.norm

    def inverse(self, y):
        """Float counts, clamped to ``[0, max]`` (not rounded)."""
        return (self.offset + self.scale * torch.sinh(y * self.norm)).clamp(
            0.0, self.max)


def transform(cfg):
    if cfg["kind"] != "asinh":
        raise ValueError(f"the reference has no transform {cfg['kind']!r}")
    return Asinh(**cfg["params"])


def _fp8(x, dtype):
    """``x`` rounded to the float8 ``dtype`` with one scale per tensor
    (its largest magnitude at the format's largest value)."""
    amax = x.abs().amax().clamp(min=1e-30)
    s = amax / torch.finfo(dtype).max
    return (x / s).to(dtype).to(x.dtype) * s


class _E4m3(torch.autograd.Function):
    """e4m3 forward; the gradient passes through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _E5m2Grad(torch.autograd.Function):
    """Identity forward; the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class Fp8:
    """The step below bf16 that a later change could take, float8
    training's two formats: a conv's input and taps in e4m3, the gradient
    of its output in e5m2, each with one scale per tensor."""

    @staticmethod
    def input(x):
        return _E4m3.apply(x)

    @staticmethod
    def output(y):
        return _E5m2Grad.apply(y)


class Bf16:
    """A witness, not a control: the network in bfloat16 as plain torch
    runs it, the configuration's stated precision by a path of its own.
    The float32 parameters are cast to bf16 on each call (the cast is
    differentiable, so the gradients reach them in float32), activations
    and their gradients are bf16, GroupNorm's statistics and affine run
    in float32, and the logits are added to the float32 input."""
