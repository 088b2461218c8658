"""Intensity transforms between raw uint16 counts and the network domain.

PyTorch counterpart of ``exaspim_tpu/transforms.py``: the same five
transforms, the same constants and the same frozen-config discipline
(``build_transform(cfg)`` stamps ``.cfg`` so a checkpoint rebuilds the
mapping bit-identically).

Tensors in, tensors out, always float32 on the input's device. numpy
arrays are accepted and land on the CPU. ``inverse`` quantizes to counts:
clip to ``[0, max_count]``, round half to even (``torch.round``), and —
because torch has no uint16 arithmetic — go through int32, narrow to the
int16 bits of uint16 on the device and hand back a numpy ``uint16`` array
at the host boundary.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "IntensityTransform",
    "AsinhTransform",
    "AnscombeTransform",
    "LinearClipTransform",
    "OffsetTransform",
    "IdentityTransform",
    "estimate_offset",
    "build_transform",
    "calibrate_transform",
    "with_offset",
]


def _f32(x):
    """float32 tensor view of a tensor or array (numpy lands on the CPU)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    a = np.asarray(x, dtype=np.float32)
    # torch.from_numpy shares memory and refuses read-only buffers quietly.
    return torch.from_numpy(a if a.flags.writeable else a.copy())


class IntensityTransform:
    """Base class for count <-> normalized intensity transforms."""

    #: frozen config dict stamped by :func:`build_transform`
    cfg: Optional[Dict[str, Any]] = None

    def forward(self, x):
        """Maps raw counts to the normalized (~[0, 1]) domain."""
        raise NotImplementedError

    def inverse_float(self, y):
        """Maps normalized values to unclipped float32 counts."""
        raise NotImplementedError

    def inverse_float_smooth(self, y):
        """:meth:`inverse_float` without flat clamps, for losses that
        differentiate through the inverse; the same map where that one is
        not clamped."""
        return self.inverse_float(y)

    def inverse_counts(self, y):
        """Maps normalized values to raw counts kept on ``y``'s device: an
        int32 tensor of 0..max_count (the quantization of :meth:`inverse`)."""
        counts = self.inverse_float(y).clamp(0.0, self.max_count)
        return torch.round(counts).to(torch.int32)

    def inverse(self, y):
        """Maps normalized values to raw counts: a numpy uint16 array.

        The counts are narrowed to 16 bits on ``y``'s device, so only those
        cross the bus; from a card they land in page-locked memory, of which
        the returned array is a view."""
        counts = self.inverse_counts(y)
        # 0..65535 to the int16 bit patterns of uint16, exactly.
        bits = (counts - (counts >> 15 << 16)).to(torch.int16)
        host = torch.empty(bits.shape, dtype=torch.int16,
                           pin_memory=bits.is_cuda)
        host.copy_(bits)
        return host.numpy().view(np.uint16)


@dataclasses.dataclass(frozen=True)
class AsinhTransform(IntensityTransform):
    """``forward(x) = asinh((x - offset)/scale) / asinh((max - offset)/scale)``."""

    offset: float = 0.0
    scale: float = 32.0
    max_count: float = 65535.0

    def __post_init__(self):
        for f in ("offset", "scale", "max_count"):
            object.__setattr__(self, f, float(getattr(self, f)))
        norm = float(np.arcsinh((self.max_count - self.offset) / self.scale))
        object.__setattr__(self, "_norm", norm)

    def forward(self, x):
        return torch.asinh((_f32(x) - self.offset) / self.scale) / self._norm

    def inverse_float(self, y):
        return self.offset + self.scale * torch.sinh(_f32(y) * self._norm)


@dataclasses.dataclass(frozen=True)
class AnscombeTransform(IntensityTransform):
    """Generalized Anscombe VST for Poisson-Gaussian noise (Makitalo & Foi).

    ``unbiased_inverse=True`` uses the asymptotically unbiased constant
    1/8; ``False`` the algebraic 3/8 that exactly round-trips ``forward``.
    """

    gain: float = 1.0
    read_noise: float = 0.0
    offset: float = 0.0
    max_count: float = 65535.0
    unbiased_inverse: bool = True

    def __post_init__(self):
        for f in ("gain", "read_noise", "offset", "max_count"):
            object.__setattr__(self, f, float(getattr(self, f)))
        object.__setattr__(self, "unbiased_inverse",
                           bool(self.unbiased_inverse))
        c_inv = 1.0 / 8.0 if self.unbiased_inverse else 3.0 / 8.0
        object.__setattr__(self, "_c_inv", c_inv)
        norm = float(self._gat(_f32(self.max_count)))
        object.__setattr__(self, "_norm", norm)

    def _gat(self, x):
        arg = (self.gain * (x - self.offset) + (3.0 / 8.0) * self.gain ** 2
               + self.read_noise ** 2)
        return (2.0 / self.gain) * torch.sqrt(torch.clamp(arg, min=0.0))

    def forward(self, x):
        return self._gat(_f32(x)) / self._norm

    def inverse_float(self, y):
        d = torch.clamp(_f32(y), min=0.0) * self._norm
        arg = (d * self.gain / 2.0) ** 2
        return self.offset + (
            arg - self._c_inv * self.gain ** 2 - self.read_noise ** 2
        ) / self.gain

    def inverse_float_smooth(self, y):
        # Sign-extended: d² → d·|d| keeps the map odd and monotone below
        # y = 0 where inverse_float clamps (zero gradient), and equals it
        # for y ≥ 0.
        d = _f32(y) * self._norm
        arg = d * torch.abs(d) * (self.gain / 2.0) ** 2
        return self.offset + (
            arg - self._c_inv * self.gain ** 2 - self.read_noise ** 2
        ) / self.gain


@dataclasses.dataclass(frozen=True)
class LinearClipTransform(IntensityTransform):
    """Linear normalization with a hard brightness clip (A/B baseline)."""

    mn: float = 0.0
    mx: float = 1000.0
    clip: float = 8.0
    max_count: float = 65535.0

    def __post_init__(self):
        for f in ("mn", "mx", "clip", "max_count"):
            object.__setattr__(self, f, float(getattr(self, f)))

    def forward(self, x):
        y = (_f32(x) - self.mn) / (self.mx - self.mn + 1e-8)
        return torch.clamp(y, 0.0, self.clip)

    def inverse_float(self, y):
        return _f32(y) * (self.mx - self.mn) + self.mn


@dataclasses.dataclass(frozen=True)
class OffsetTransform(IntensityTransform):
    """A raw-count pedestal around a frozen base transform:
    ``forward(x) = base.forward(x - offset)``,
    ``inverse_float(y) = base.inverse_float(y) + offset``. The base's
    normalization constants are untouched."""

    base_transform: IntensityTransform = None
    offset: float = 0.0

    def __post_init__(self):
        object.__setattr__(self, "offset", float(self.offset))

    @property
    def max_count(self):
        return float(self.base_transform.max_count)

    def __getattr__(self, name):
        # Expose the base's non-offset parameters (scale, gain, ...).
        if name.startswith("__") or name == "base_transform":
            raise AttributeError(name)
        return getattr(self.base_transform, name)

    def forward(self, x):
        return self.base_transform.forward(_f32(x) - self.offset)

    def inverse_float(self, y):
        return self.base_transform.inverse_float(y) + self.offset

    def inverse_float_smooth(self, y):
        return self.base_transform.inverse_float_smooth(y) + self.offset


class IdentityTransform(IntensityTransform):
    """No-op transform for tests and raw-domain pipelines."""

    max_count = 65535.0

    def forward(self, x):
        return _f32(x)

    def inverse_float(self, y):
        return _f32(y)


def estimate_offset(sample, percentile=1.0, ignore_zeros=True):
    """A robust background / black point in counts: a low percentile of the
    (optionally nonzero) sample. ``ignore_zeros`` keeps zero padding outside
    the imaged volume from dragging the estimate to 0. Host numpy, as in
    the reference (``torch.quantile`` refuses inputs above 16.7 M
    elements)."""
    sample = np.asarray(sample, dtype=np.float32).reshape(-1)
    if ignore_zeros:
        nonzero = sample[sample > 0]
        if nonzero.size:
            sample = nonzero
    return float(np.percentile(sample, percentile))


_KINDS = {
    "asinh": AsinhTransform,
    "anscombe": AnscombeTransform,
    "linear": LinearClipTransform,
    "identity": IdentityTransform,
}


def build_transform(cfg):
    """Build a transform from ``{"kind": ..., "params": {...}}`` (or an
    ``{"kind": "offset", "base": <cfg>, "params": {...}}`` composition)
    and stamp the originating config onto it as ``.cfg``."""
    kind = cfg["kind"]
    params = cfg.get("params", {})
    if kind == "offset":
        transform = OffsetTransform(build_transform(cfg["base"]), **params)
    elif kind in _KINDS:
        transform = _KINDS[kind](**params)
    else:
        raise ValueError(f"Unknown transform kind: {kind}")
    object.__setattr__(transform, "cfg", {**cfg, "params": dict(params)})
    return transform


def calibrate_transform(cfg, sample):
    """Freeze data-driven params into a transform config, once, globally.

    Only the black point ``offset`` is calibrated (a low percentile of the
    sample, when ``cfg["calibrate"]["offset"]`` is set). The input cfg is
    not mutated; the returned cfg is what is serialized with the model and
    reused verbatim at inference.
    """
    cfg = {**cfg, "params": dict(cfg.get("params", {}))}
    calib = cfg.get("calibrate", {})
    if calib.get("offset", False):
        cfg["params"]["offset"] = estimate_offset(
            sample, percentile=calib.get("offset_percentile", 1.0)
        )
    return cfg


def with_offset(transform, offset):
    """Compose a raw-count background offset around a trained transform.

    Linear transforms shift both bounds; compressive ones are wrapped in
    :class:`OffsetTransform` so their normalization is untouched.
    """
    if isinstance(transform, OffsetTransform):
        transform = transform.base_transform
    cfg = getattr(transform, "cfg", None)
    if cfg is None:
        raise ValueError(
            "transform has no cfg; construct it via build_transform")
    offset = float(offset)
    if cfg["kind"] == "linear":
        params = dict(cfg.get("params", {}))
        params["mn"] = float(transform.mn) + offset
        params["mx"] = float(transform.mx) + offset
        return build_transform({**cfg, "params": params})
    return build_transform(
        {"kind": "offset", "base": cfg, "params": {"offset": offset}}
    )
