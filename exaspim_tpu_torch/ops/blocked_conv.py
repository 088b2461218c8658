"""3³ SAME conv (no bias, one input) from a shared-memory halo tile.

PyTorch counterpart of ``exaspim_tpu/ops/pallas_conv.py``
(``blocked_conv3d:174``, ``supports_blocked_conv:48``). The function is the
same: ``lax.conv_general_dilated(x, k3, (1, 1, 1), "SAME")`` on NDHWC x
DHWIO with f32 accumulation and one rounding to the input dtype. The
layout is not: the TPU kernel's space-to-depth packing exists for the MXU
and is gone; activations stay plain ``(B, D, H, W, C)`` and the taps
``(3, 3, 3, Cin, Cout)``.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/blocked_conv3d.cu`` (bf16, channels in multiples of 32) or raises
with the reason. That source is its own entry point over the forward conv
design of ``csrc/nb_conv3d.cu`` (``nb_conv3d_fwd.cuh``: a halo tile in
shared memory read by ``wgmma`` as 27 shifted views), instantiated for one
input segment and no statistics, with the tile plan of
:func:`~exaspim_tpu_torch.ops.nb_conv._plan`. On a CPU tensor it runs
:func:`blocked_conv3d_plain`, the plain PyTorch version, which the CPU
tests and the kernel check use.

Differentiable like the reference's ``custom_vjp`` (``_vjp_bwd:194``): dL/dx
is the same kernel on the taps flipped over the three spatial axes with
the channels swapped; dL/dW, which the reference takes outside any Pallas
kernel, goes through the port's :func:`~exaspim_tpu_torch.ops.nb_conv.nb_conv3d_dw`.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from exaspim_tpu_torch.ops.nb_conv import _MODES, _plan, nb_conv3d_dw

__all__ = ["blocked_conv3d", "blocked_conv3d_plain", "supports_blocked_conv"]

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]
_CHANNELS = 32  # the kernel's K chunk and its smallest N tile


def supports_blocked_conv(shape, cin, cout):
    """True when ``(B, D, H, W, cin)`` @ 3³ → ``cout`` qualifies for the
    reference's kernel (the same advisory gate: the function itself also
    runs on shapes with fewer than 256 (y, x) blocks)."""
    _, d, h, w = shape[0], shape[1], shape[2], shape[3]
    return (
        cin % 32 == 0
        and cout % 32 == 0
        and d % 2 == 0 and h % 2 == 0 and w % 2 == 0
        and (h // 2) * (w // 2) >= 256
    )


def _check(x, k3):
    if x.dim() != 5:
        raise ValueError(f"x must be (B, D, H, W, Cin); got {tuple(x.shape)}")
    if k3.dim() != 5 or tuple(k3.shape[:3]) != (3, 3, 3) \
            or k3.shape[3] != x.shape[-1]:
        raise ValueError(
            f"taps must be (3, 3, 3, {x.shape[-1]}, Cout); got "
            f"{tuple(k3.shape)}")
    if x.shape[2] % 2 or x.shape[3] % 2:
        raise ValueError(
            f"H and W must be even (as the reference's 2x2 blocking "
            f"requires); got {tuple(x.shape)}")
    if k3.device != x.device or k3.dtype != x.dtype:
        raise ValueError("x and the taps must share one device and dtype")


def blocked_conv3d_plain(x, k3):
    """Plain PyTorch version: ``F.conv3d`` in f32 on the permuted tensor,
    one rounding to the input dtype."""
    _check(x, k3)
    w = k3.permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1)
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


def _launch(x, k3):
    from exaspim_tpu_torch.ops._build import load_library

    if x.dtype != torch.bfloat16:
        raise TypeError(
            f"the CUDA blocked conv kernel takes bf16 tensors; got {x.dtype}")
    b, d, h, w, cin = x.shape
    cout = k3.shape[-1]
    if cin % _CHANNELS or cout % _CHANNELS:
        raise ValueError(
            f"the CUDA blocked conv kernel needs Cin and Cout in multiples "
            f"of {_CHANNELS} (the reference's gate; dL/dx swaps them); "
            f"got {cin} -> {cout}")
    if b > 65535:
        raise ValueError(f"batch {b} exceeds the launch grid's 65535")
    x = x.contiguous()
    k = k3.reshape(27, cin, cout).contiguous()
    if x.data_ptr() % 16 or k.data_ptr() % 16:
        raise ValueError("the CUDA blocked conv kernel needs 16-byte "
                         "aligned tensors")
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    plan = _plan(b, d, h, w, (cin,), cout)
    fn = load_library("blocked_conv3d").blocked_conv3d_bf16
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16,
                      device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), k.data_ptr(), out.data_ptr(), b, d, h, w, cin,
                cout, _MODES[plan["mode"]], plan["bn"], plan["wg"],
                plan["tiles"], plan["pblocks"], stream)
    if rc != 0:
        raise RuntimeError(
            f"blocked_conv3d kernel launch failed: cudaError {rc}")
    blocked_conv3d.launches += 1
    return out


def _conv(x, k3):
    """One forward conv on the tensors' device, outside autograd."""
    _check(x, k3)
    if x.device.type == "cpu":
        return blocked_conv3d_plain(x, k3)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch(x, k3)


def _flip_taps(k3):
    """The taps of dL/dx: flipped over the three spatial axes, channels
    swapped (``_vjp_bwd:199``)."""
    return k3.flip(0, 1, 2).transpose(3, 4).contiguous()


class _BlockedConv3d(torch.autograd.Function):
    """Forward and dL/dx on the blocked kernel, dL/dW on the port's dL/dW
    kernel (f32 ``(27, Cin, Cout)``, reshaped to DHWIO and cast to the
    taps' dtype)."""

    @staticmethod
    def forward(ctx, x, k3):
        ctx.save_for_backward(x, k3)
        return _conv(x, k3)

    @staticmethod
    def backward(ctx, g):
        x, k3 = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = dk = None
        if ctx.needs_input_grad[0]:
            dx = _conv(g, _flip_taps(k3))
        if ctx.needs_input_grad[1]:
            dk = nb_conv3d_dw((x.contiguous(),), g).reshape(k3.shape).to(
                k3.dtype)
        return dx, dk


def blocked_conv3d(x, k3):
    """3³ SAME conv, no bias: ``(B, D, H, W, Cin)`` x ``(3, 3, 3, Cin, Cout)``
    → ``(B, D, H, W, Cout)`` in the input dtype, f32 accumulation.

    H and W must be even, any D. CUDA tensors go through
    ``csrc/blocked_conv3d.cu`` (bf16, Cin and Cout multiples of 32; raises
    otherwise) and count one launch in ``blocked_conv3d.launches``; CPU
    tensors go through :func:`blocked_conv3d_plain`. Differentiable in both
    arguments (see :class:`_BlockedConv3d`).
    """
    return _BlockedConv3d.apply(x, k3)


blocked_conv3d.launches = 0
