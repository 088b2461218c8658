"""3³ SAME conv (no bias) with an optional GroupNorm-statistics epilogue.

PyTorch counterpart of ``exaspim_tpu/ops/nb_conv.py`` (``nb_conv3d:778``,
``nb_conv3d_stats:896``). The function is the same; the layout is not:
activations stay plain channels-last ``(B, D, H, W, C)`` and the taps
are DHWIO ``(3, 3, 3, Cin, Cout)`` (or the same taps already reshaped to
``(27, Cin, Cout)``). The input may be one tensor or two whose channels
concatenate (the decoder's ``[skip, up]``), consumed as K-segments.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/nb_conv3d.cu`` (bf16 only) or raises. On a CPU tensor it runs
:func:`nb_conv3d_plain`, the plain PyTorch version of the same function,
which the CPU tests and the kernel check in ``chip_smoke.py`` use.

Inference only: a call that needs a gradient raises ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = ["nb_conv3d", "nb_conv3d_stats", "nb_conv3d_plain"]

_C_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]


def _segments(xs):
    xs = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"expected 1 or 2 input segments, got {len(xs)}")
    lead = xs[0].shape[:4]
    for x in xs:
        if x.dim() != 5 or x.shape[:4] != lead:
            raise ValueError(
                "segments must be (B, D, H, W, C_i) with equal B, D, H, W; "
                f"got {[tuple(s.shape) for s in xs]}"
            )
        if x.device != xs[0].device or x.dtype != xs[0].dtype:
            raise ValueError("segments must share one device and dtype")
    return xs


def _taps(k3, cin):
    if k3.dim() not in (3, 5) or k3.shape[-2] != cin or (
        k3.dim() == 5 and tuple(k3.shape[:3]) != (3, 3, 3)
    ) or (k3.dim() == 3 and k3.shape[0] != 27):
        raise ValueError(
            f"taps must be (3, 3, 3, {cin}, Cout) or (27, {cin}, Cout); "
            f"got {tuple(k3.shape)}"
        )
    return k3.reshape(27, cin, k3.shape[-1])


def nb_conv3d_plain(xs, k3, with_stats=False):
    """Plain PyTorch version: concat the segments, ``F.conv3d`` in f32,
    round to the input dtype; the stats are Σy and Σy² per
    ``(batch, channel)`` of the ROUNDED output, in f32."""
    xs = _segments(xs)
    x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    k = _taps(k3, x.shape[-1])
    w = k.reshape(3, 3, 3, k.shape[1], k.shape[2]).permute(4, 3, 0, 1, 2)
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1
    ).permute(0, 2, 3, 4, 1).to(x.dtype)
    if not with_stats:
        return y
    yf = y.float()
    return y, yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))


def _launch(xs, k, with_stats):
    from exaspim_tpu_torch.ops._build import load_library

    x0 = xs[0]
    if x0.dtype != torch.bfloat16 or k.dtype != torch.bfloat16:
        raise TypeError(
            "the CUDA conv kernel takes bf16 activations and taps; got "
            f"{x0.dtype} / {k.dtype}"
        )
    if k.device != x0.device:
        raise ValueError("taps and activations are on different devices")
    if not all(x.is_contiguous() for x in xs) or not k.is_contiguous():
        raise ValueError("the CUDA conv kernel needs contiguous tensors")
    b, d, h, w = x0.shape[:4]
    cout = k.shape[-1]
    if cout % 8:
        raise ValueError(f"Cout must be a multiple of 8, got {cout}")
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    lib = load_library("nb_conv3d")
    fn = lib.nb_conv3d_bf16
    fn.argtypes = _C_ARGTYPES
    fn.restype = ctypes.c_int
    out = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16,
                      device=x0.device)
    s1 = s2 = None
    if with_stats:
        s1 = torch.zeros((b, cout), dtype=torch.float32, device=x0.device)
        s2 = torch.zeros_like(s1)
    xa = xs[0]
    xb = xs[1] if len(xs) > 1 else None
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream(x0.device).cuda_stream
        rc = fn(
            xa.data_ptr(), None if xb is None else xb.data_ptr(),
            xa.shape[-1], 0 if xb is None else xb.shape[-1],
            k.data_ptr(), out.data_ptr(),
            None if s1 is None else s1.data_ptr(),
            None if s2 is None else s2.data_ptr(),
            b, d, h, w, cout, stream,
        )
    if rc != 0:
        raise RuntimeError(f"nb_conv3d kernel launch failed: cudaError {rc}")
    nb_conv3d.launches += 1
    return (out, s1, s2) if with_stats else out


def nb_conv3d(xs, k3, with_stats=False):
    """3³ SAME conv, no bias, f32 accumulation, output in the input dtype.

    Args:
      xs: a ``(B, D, H, W, C)`` tensor or a tuple of two whose channels
        concatenate.
      k3: taps ``(3, 3, 3, Cin, Cout)`` or ``(27, Cin, Cout)``.
      with_stats: also return f32 ``(B, Cout)`` Σy and Σy² of the rounded
        output (what GroupNorm needs).

    CUDA tensors go through the Hopper kernel (bf16, contiguous) and
    count one launch in ``nb_conv3d.launches``; CPU tensors go through
    :func:`nb_conv3d_plain`.
    """
    xs = _segments(xs)
    k = _taps(k3, sum(x.shape[-1] for x in xs))
    if torch.is_grad_enabled() and (
        k.requires_grad or any(x.requires_grad for x in xs)
    ):
        raise NotImplementedError(
            "nb_conv3d has no backward yet: gradients (the dL/dW kernel and "
            "the autograd Function) come with the training slice; call it "
            "under torch.no_grad() / torch.inference_mode()"
        )
    if xs[0].device.type == "cpu":
        return nb_conv3d_plain(xs, k, with_stats)
    if xs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {xs[0].device}")
    return _launch(xs, k, with_stats)


nb_conv3d.launches = 0


def nb_conv3d_stats(xs, k3):
    """``nb_conv3d(xs, k3, with_stats=True)``: returns ``(y, s1, s2)``."""
    return nb_conv3d(xs, k3, with_stats=True)
