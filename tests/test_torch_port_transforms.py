"""The port's intensity transforms against exaspim_tpu.transforms.

Tolerances: forward and inverse_float agree to f32 rounding (1e-6
relative, one ulp of the largest value); inverse (uint16 counts) is
exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaspim_tpu.transforms as jt
import exaspim_tpu_torch.transforms as tt

CFGS = [
    {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}},
    {"kind": "anscombe",
     "params": {"gain": 2.0, "read_noise": 3.0, "offset": 10.0}},
    {"kind": "anscombe", "params": {"unbiased_inverse": False}},
    {"kind": "linear", "params": {"mn": 90.0, "mx": 5000.0}},
    {"kind": "identity"},
    {"kind": "offset", "base": {"kind": "asinh", "params": {"scale": 60.0}},
     "params": {"offset": 90.0}},
]


def _inputs():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 65536, (4000,)).astype(np.uint16)
    u[:8] = [0, 1, 99, 100, 101, 65535, 200, 7]
    f = rng.normal(400.0, 300.0, (4000,)).astype(np.float32)
    return u, f


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * scale)


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["kind"])
def test_transform_matches_jax(cfg):
    j, t = jt.build_transform(cfg), tt.build_transform(cfg)
    for x in _inputs():
        yj = np.array(j.forward(jnp.asarray(x)))  # writable copy
        yt = t.forward(x)
        assert isinstance(yt, torch.Tensor) and yt.dtype == torch.float32
        _close(yt.numpy(), yj)
        # Same normalized input into both inverses.
        _close(t.inverse_float(torch.from_numpy(yj)).numpy(),
               np.asarray(j.inverse_float(jnp.asarray(yj))))
        got = t.inverse(torch.from_numpy(yj))
        assert got.dtype == np.uint16
        np.testing.assert_array_equal(got,
                                      np.asarray(j.inverse(jnp.asarray(yj))))


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: c["kind"])
def test_cfg_roundtrip(cfg):
    t = tt.build_transform(cfg)
    t2 = tt.build_transform(t.cfg)
    assert t2.cfg == t.cfg
    x = _inputs()[0]
    np.testing.assert_array_equal(t.forward(x).numpy(), t2.forward(x).numpy())


def test_with_offset_matches_jax():
    for cfg in (CFGS[0], CFGS[3]):
        j = jt.with_offset(jt.build_transform(cfg), 37.0)
        t = tt.with_offset(tt.build_transform(cfg), 37.0)
        assert t.cfg == j.cfg
        x = _inputs()[0]
        _close(t.forward(x).numpy(), np.asarray(j.forward(jnp.asarray(x))))


@pytest.mark.parametrize("percentile,ignore_zeros", [(1.0, True), (5.0, True),
                                                     (1.0, False)])
def test_estimate_offset_matches_jax(percentile, ignore_zeros):
    """Host numpy in both packages: equal."""
    from exaspim_tpu.transforms import estimate_offset as jax_estimate
    from exaspim_tpu_torch.transforms import estimate_offset

    rng = np.random.default_rng(11)
    sample = rng.poisson(120.0, (24, 20, 20)).astype(np.uint16)
    sample[:4] = 0  # zero padding outside the imaged volume
    got = estimate_offset(sample, percentile, ignore_zeros)
    assert got == jax_estimate(sample, percentile, ignore_zeros)
    assert isinstance(got, float)
    assert estimate_offset(np.zeros(8)) == 0.0


@pytest.mark.parametrize("calibrate", [
    {"offset": True}, {"offset": True, "offset_percentile": 3.0}, {}, None,
])
def test_calibrate_transform_matches_jax(calibrate):
    from exaspim_tpu.transforms import calibrate_transform as jax_calibrate
    from exaspim_tpu_torch.transforms import (
        build_transform,
        calibrate_transform,
    )

    sample = np.random.default_rng(12).poisson(90.0, 4096).astype(np.float32)
    cfg = {"kind": "asinh", "params": {"offset": 0.0, "scale": 50.0}}
    if calibrate is not None:
        cfg["calibrate"] = calibrate
    frozen = {"kind": "asinh", "params": {"offset": 0.0, "scale": 50.0}}
    got = calibrate_transform(cfg, sample)
    assert got == jax_calibrate(cfg, sample)
    assert cfg["params"] == frozen["params"]  # the input is not mutated
    if calibrate and calibrate.get("offset"):
        assert got["params"]["offset"] > 0
    params = {k: v for k, v in got.items() if k != "calibrate"}
    assert build_transform(params).offset == got["params"]["offset"]
