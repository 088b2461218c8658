"""Fused elementwise asinh intensity transform and its quantising inverse.

Counterpart of ``exaspim_tpu/ops/pallas_ops.py``. Like there, nothing on
the denoising or training path calls these: both paths apply
:class:`exaspim_tpu_torch.transforms.AsinhTransform` inside larger steps.
They are the standalone single-pass forms, uint16 counts → f32 network
domain and back:

* :func:`asinh_forward`: ``log(v + sqrt(v² + 1)) / norm`` with
  ``v = (x − offset) / scale`` (asinh in its log form), uint16 or f32 in,
  f32 out;
* :func:`asinh_inverse`: ``clip(round(sinh(y·norm)·scale + offset), 0,
  max_count)`` with ``sinh`` in its exp form and round-half-to-even, f32
  in, uint16 out.

The divisions are multiplications by f32 reciprocals, as in the reference.
On a CUDA tensor each launches its kernel of ``csrc/asinh_transform.cu``
(or raises) and counts the launch; on a CPU tensor it runs its plain
version (:func:`asinh_forward_plain`, :func:`asinh_inverse_plain`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = [
    "asinh_forward",
    "asinh_inverse",
    "asinh_forward_plain",
    "asinh_inverse_plain",
]


def _f32(v):
    return float(np.float32(v))


def asinh_forward_plain(x, offset=0.0, scale=1.0, norm=1.0):
    """Plain PyTorch version of :func:`asinh_forward`."""
    v = (x.to(torch.float32) - _f32(offset)) * _f32(1.0 / scale)
    return torch.log(v + torch.sqrt(v * v + 1.0)) * _f32(1.0 / norm)


def asinh_inverse_plain(y, offset=0.0, scale=1.0, norm=1.0,
                        max_count=65535.0):
    """Plain PyTorch version of :func:`asinh_inverse`."""
    v = y.to(torch.float32) * _f32(norm)
    s = 0.5 * (torch.exp(v) - torch.exp(-v))
    counts = torch.clamp(s * _f32(scale) + _f32(offset), 0.0, _f32(max_count))
    return torch.round(counts).to(torch.int32).to(torch.uint16)


def _launch(name, argtypes, tensor, out, *scalars):
    from exaspim_tpu_torch.ops._build import load_library

    fn = getattr(load_library("asinh_transform"), name)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   *argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(tensor.device):
        stream = torch.cuda.current_stream(tensor.device).cuda_stream
        rc = fn(tensor.data_ptr(), out.data_ptr(), tensor.numel(),
                *scalars, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
    return out


def _on_card(t):
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return True


def asinh_forward(x, offset=0.0, scale=1.0, norm=1.0):
    """``arcsinh((x − offset)/scale)/norm`` over a uint16 or f32 tensor of
    any shape → f32. Agrees with ``AsinhTransform.forward`` up to the
    log-form identity. CUDA tensors go through the kernel and count one
    launch in ``asinh_forward.launches``."""
    if x.dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"expected uint16 or float32, got {x.dtype}")
    if not _on_card(x):
        return asinh_forward_plain(x, offset, scale, norm)
    x = x.contiguous()
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    name = "asinh_forward_u16" if x.dtype == torch.uint16 \
        else "asinh_forward_f32"
    _launch(name, [ctypes.c_float] * 3, x, out, _f32(offset),
            _f32(1.0 / scale), _f32(1.0 / norm))
    asinh_forward.launches += 1
    return out


asinh_forward.launches = 0


def asinh_inverse(y, offset=0.0, scale=1.0, norm=1.0, max_count=65535.0):
    """``clip(round(sinh(y·norm)·scale + offset), 0, max_count)`` over an
    f32 tensor of any shape → uint16. CUDA tensors go through the kernel
    and count one launch in ``asinh_inverse.launches``."""
    if y.dtype != torch.float32:
        raise TypeError(f"expected float32, got {y.dtype}")
    if not 0.0 <= max_count <= 65535.0:
        raise ValueError(f"max_count {max_count} does not fit uint16")
    if not _on_card(y):
        return asinh_inverse_plain(y, offset, scale, norm, max_count)
    y = y.contiguous()
    out = torch.empty(y.shape, dtype=torch.uint16, device=y.device)
    _launch("asinh_inverse_f32", [ctypes.c_float] * 4, y, out, _f32(offset),
            _f32(scale), _f32(norm), _f32(max_count))
    asinh_inverse.launches += 1
    return out


asinh_inverse.launches = 0
