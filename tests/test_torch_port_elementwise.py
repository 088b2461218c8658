"""The port's fused asinh ops against exaspim_tpu.ops.pallas_ops (Pallas
kernels in interpret mode) and against both packages' AsinhTransform.

On CPU tensors the port runs its plain versions, which follow the
reference operation by operation (log and exp forms, multiplication by
f32 reciprocals). Tolerances: forward within 4 f32 ulps of the result's
scale (2⁻²¹ relative plus 1e-7 absolute: XLA's and torch's log and sqrt
may round the last bit differently) of the Pallas kernel and within 1e-6
of the transform classes (the log-form identity); inverse counts equal
to the Pallas kernel's except where the two exp implementations put a
value on the other side of a .5 boundary (at most 1 count, on at most
0.1 % of the elements); forward then inverse returns the input counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.ops import pallas_ops as jp
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.ops import elementwise as te
from exaspim_tpu_torch.transforms import build_transform

CFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def _raw(seed, shape=(24, 20, 16)):
    rng = np.random.default_rng(seed)
    raw = rng.poisson(300, shape) + 37
    raw.reshape(-1)[:4] = (0, 1, 65535, 40000)
    return raw.astype(np.uint16)


@pytest.mark.parametrize("dtype", ["uint16", "float32"])
def test_forward_matches_pallas_and_transforms(dtype):
    raw = _raw(0).astype(dtype)
    t, jt = build_transform(CFG), jax_transform(CFG)
    kw = dict(offset=100.0, scale=60.0, norm=float(t._norm))
    got = te.asinh_forward(torch.from_numpy(raw), **kw)
    assert got.dtype == torch.float32 and got.shape == raw.shape
    want = np.asarray(jp.asinh_forward(jnp.asarray(raw), interpret=True, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.0 ** -21, atol=1e-7)
    f32 = raw.astype(np.float32)
    np.testing.assert_allclose(got.numpy(), t.forward(f32).numpy(), atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(jt.forward(f32)),
                               atol=1e-6)


def test_inverse_matches_pallas_and_round_trips():
    raw = _raw(1)
    t, jt = build_transform(CFG), jax_transform(CFG)
    kw = dict(offset=100.0, scale=60.0, norm=float(t._norm))
    y = te.asinh_forward(torch.from_numpy(raw), **kw)
    back = te.asinh_inverse(y, **kw)
    assert back.dtype == torch.uint16 and back.shape == raw.shape
    np.testing.assert_array_equal(back.numpy(), raw)
    # Off-grid values: the network's output is not on the count lattice.
    rng = np.random.default_rng(2)
    yn = (y.numpy() + rng.normal(0, 0.01, raw.shape)).astype(np.float32)
    yn.reshape(-1)[:2] = (-0.5, 1.5)  # clips to 0 and max_count
    got = te.asinh_inverse(torch.from_numpy(yn), **kw).numpy().astype(np.int64)
    assert got.reshape(-1)[0] == 0 and got.reshape(-1)[1] == 65535
    for want in (
        np.asarray(jp.asinh_inverse(jnp.asarray(yn), interpret=True, **kw)),
        t.inverse(yn), np.asarray(jt.inverse(yn)),
    ):
        d = np.abs(got - want.astype(np.int64))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3
    low = te.asinh_inverse(torch.from_numpy(yn), max_count=1000.0, **kw)
    assert int(low.to(torch.int32).max()) == 1000


def test_wrappers_reject_what_the_kernels_do_not_take():
    with pytest.raises(TypeError, match="uint16 or float32"):
        te.asinh_forward(torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="float32"):
        te.asinh_inverse(torch.zeros(4, dtype=torch.float64))
    with pytest.raises(ValueError, match="uint16"):
        te.asinh_inverse(torch.zeros(4), max_count=1e6)
    assert te.asinh_forward.launches == 0 and te.asinh_inverse.launches == 0
