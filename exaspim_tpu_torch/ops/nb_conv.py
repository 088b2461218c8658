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

Both are differentiable (``torch.autograd.Function``s, the counterparts
of ``_nb_conv3d_core`` / ``_nb_conv3d_stats_core``, ``nb_conv.py:798-961``).
The backward folds the stats cotangents into the output cotangent, runs
dL/dx as the same forward conv with flipped, channel-transposed taps, and
dL/dW through :func:`nb_conv3d_dw` (``csrc/nb_conv3d_dw.cu`` on the card,
:func:`nb_conv3d_dw_plain` on the CPU).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = [
    "nb_conv3d",
    "nb_conv3d_stats",
    "nb_conv3d_plain",
    "nb_conv3d_dw",
    "nb_conv3d_dw_plain",
]

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p,
]
_DW_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
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


def nb_conv3d_dw_plain(xs, g):
    """Plain PyTorch dL/dW: f32 ``conv3d_weight`` of the concatenated
    segments against the output cotangent ``g``; returns f32
    ``(27, Cin, Cout)``."""
    xs = _segments(xs)
    x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    cin, cout = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3).float(), (cout, cin, 3, 3, 3),
        g.permute(0, 4, 1, 2, 3).float(), padding=1,
    )
    return dw.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)


def _check_cuda(tensors, what):
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(
            f"the CUDA {what} kernel takes bf16 tensors; got "
            f"{[t.dtype for t in tensors]}"
        )
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors are on different devices")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"the CUDA {what} kernel needs contiguous, "
                         "16-byte aligned tensors")


def _launch(xs, k, with_stats):
    from exaspim_tpu_torch.ops._build import load_library

    _check_cuda((*xs, k), "conv")
    x0 = xs[0]
    b, d, h, w = x0.shape[:4]
    cout = k.shape[-1]
    if cout % 8:
        raise ValueError(f"Cout must be a multiple of 8, got {cout}")
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    fn = load_library("nb_conv3d").nb_conv3d_bf16
    fn.argtypes = _FWD_ARGTYPES
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


def _conv(xs, k, with_stats):
    """One forward conv on the tensors' device, outside autograd."""
    if xs[0].device.type == "cpu":
        return nb_conv3d_plain(xs, k, with_stats)
    if xs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {xs[0].device}")
    return _launch(xs, k, with_stats)


# Workspace splits of the dL/dW kernel: enough (M, N, split) blocks to fill
# the card several times over, at least 16 K steps of 64 voxels per split.
_DW_TARGET_BLOCKS = 2048
_DW_MIN_STEPS = 16


def _dw_splits(nvox, segs, cout):
    cin = sum(segs)
    aligned = all(c % 32 == 0 for c in segs)
    mblocks = 9 * (cin // 32) if aligned else -(-27 * cin // 32)
    bn = 64 if cout % 64 == 0 else 32
    base = mblocks * -(-cout // bn)
    steps = -(-nvox // 64)
    want = -(-_DW_TARGET_BLOCKS // base)
    return max(1, min(want, steps // _DW_MIN_STEPS, 4096))


def _launch_dw(xs, g):
    from exaspim_tpu_torch.ops._build import load_library

    _check_cuda((*xs, g), "dL/dW")
    b, d, h, w = g.shape[:4]
    cout = g.shape[-1]
    if cout % 8:
        raise ValueError(f"Cout must be a multiple of 8, got {cout}")
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    segs = [x.shape[-1] for x in xs]
    cin = sum(segs)
    splits = _dw_splits(b * d * h * w, segs, cout)
    ws = torch.empty((splits, 27, cin, cout), dtype=torch.float32,
                     device=g.device)
    out = torch.empty((27, cin, cout), dtype=torch.float32, device=g.device)
    fn = load_library("nb_conv3d_dw").nb_conv3d_dw_bf16
    fn.argtypes = _DW_ARGTYPES
    fn.restype = ctypes.c_int
    xa = xs[0]
    xb = xs[1] if len(xs) > 1 else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(
            xa.data_ptr(), None if xb is None else xb.data_ptr(),
            segs[0], 0 if xb is None else segs[1], g.data_ptr(),
            ws.data_ptr(), out.data_ptr(), b, d, h, w, cout, splits, stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"nb_conv3d_dw kernel launch failed: cudaError {rc}")
    nb_conv3d_dw.launches += 1
    return out


def nb_conv3d_dw(xs, g):
    """dL/dW of the 3³ SAME conv: f32 ``(27, Cin, Cout)`` with
    ``dW[tap, c, n] = Σ_{b, v} x[b, v + δ_tap, c] · g[b, v, n]`` (taps
    outside the volume read zero).

    ``xs`` are the conv's input segments, ``g`` the output cotangent
    ``(B, D, H, W, Cout)``. CUDA tensors go through ``csrc/nb_conv3d_dw.cu``
    (bf16, contiguous) and count one launch in ``nb_conv3d_dw.launches``;
    CPU tensors go through :func:`nb_conv3d_dw_plain`.
    """
    xs = _segments(xs)
    if g.dim() != 5 or g.shape[:4] != xs[0].shape[:4]:
        raise ValueError(f"g {tuple(g.shape)} does not match the input "
                         f"{tuple(xs[0].shape)}")
    if g.device.type == "cpu":
        return nb_conv3d_dw_plain(xs, g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return _launch_dw(xs, g)


nb_conv3d_dw.launches = 0


class _Conv3d(torch.autograd.Function):
    """3³ SAME conv with a backward on the same kernels.

    ``forward(with_stats, k, *xs)`` saves the segments and the taps (and
    ``y`` with stats). Backward, as ``_bwd_from_g`` and ``_stats_vjp_bwd``
    (``exaspim_tpu/ops/nb_conv.py:848, 943``):

    * g = (ḡ_y + ḡ₁ + 2·y·ḡ₂) in f32, cast to y's dtype (stats only);
    * dL/dx = the forward conv of g with the taps flipped over the 27 taps
      and transposed to ``(27, Cout, Cin)``, split back onto the segments;
      skipped for segments that need no gradient;
    * dL/dW = :func:`nb_conv3d_dw` (f32), cast to the taps' dtype.
    """

    @staticmethod
    def forward(ctx, with_stats, k, *xs):
        res = _conv(xs, k, with_stats)
        ctx.with_stats = with_stats
        ctx.save_for_backward(k, *xs, *((res[0],) if with_stats else ()))
        return res

    @staticmethod
    def backward(ctx, g_y, g_s1=None, g_s2=None):
        k, *xs = ctx.saved_tensors
        if ctx.with_stats:
            y = xs.pop()
            g = (g_y.float() + g_s1.float()[:, None, None, None, :]
                 + 2.0 * y.float() * g_s2.float()[:, None, None, None, :])
            g = g.to(y.dtype)
        else:
            g = g_y.to(xs[0].dtype)
        g = g.contiguous()
        need_dk = ctx.needs_input_grad[1]
        need_dx = ctx.needs_input_grad[2:]
        dxs = [None] * len(xs)
        if any(need_dx):
            k_t = k.flip(0).transpose(1, 2).contiguous()
            dx_all = _conv((g,), k_t, False)
            o = 0
            for i, x in enumerate(xs):
                c = x.shape[-1]
                if need_dx[i]:
                    dxs[i] = dx_all[..., o:o + c].contiguous()
                o += c
        dk = nb_conv3d_dw(xs, g).to(k.dtype) if need_dk else None
        return (None, dk, *dxs)


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
    :func:`nb_conv3d_plain`. Differentiable in ``xs`` and ``k3``: the
    backward runs on the same kernels (see :class:`_Conv3d`).
    """
    xs = _segments(xs)
    k = _taps(k3, sum(x.shape[-1] for x in xs))
    return _Conv3d.apply(bool(with_stats), k, *xs)


nb_conv3d.launches = 0


def nb_conv3d_stats(xs, k3):
    """``nb_conv3d(xs, k3, with_stats=True)``: returns ``(y, s1, s2)``."""
    return nb_conv3d(xs, k3, with_stats=True)
