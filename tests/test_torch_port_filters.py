"""The port's small-stencil filters against exaspim_tpu.ops.filters (and
scipy.ndimage, whose defaults both follow).

Tolerances: f32 sums of at most 33 products taken in another order than
XLA's conv: atol 1e-4 on data of order 1e3 (rtol 1e-5); the dilation is
boolean and equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from exaspim_tpu.ops import filters as jf
from exaspim_tpu_torch.ops import filters as tf


def _vol(seed, shape=(12, 14, 10)):
    return np.random.default_rng(seed).normal(500.0, 200.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("sigma", [0.8, 1.5, 4.0])
def test_gaussian_filter_matches_jax_and_scipy(sigma):
    x = _vol(0)
    got = tf.gaussian_filter(torch.from_numpy(x), sigma).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jf.gaussian_filter(jnp.asarray(x), sigma)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, ndimage.gaussian_filter(x, sigma),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(tf.gaussian_kernel1d(sigma),
                                  jf.gaussian_kernel1d(sigma))


@pytest.mark.parametrize("size", [3, 4, 16])
def test_uniform_filter_matches_jax_and_scipy(size):
    x = _vol(1, (20, 18, 17))
    got = tf.uniform_filter(torch.from_numpy(x), size).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jf.uniform_filter(jnp.asarray(x), size)),
        rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(got, ndimage.uniform_filter(x, size),
                               rtol=1e-5, atol=1e-3)


def test_separable_filter_skips_none_axes():
    x = _vol(2)
    kernels = [np.array([0.25, 0.5, 0.25], np.float32), None,
               np.array([0.1, 0.2, 0.3, 0.4], np.float32)]
    got = tf.separable_filter(torch.from_numpy(x), kernels).numpy()
    want = np.asarray(jf.separable_filter(jnp.asarray(x), kernels))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("iterations", [1, 3])
def test_binary_dilation_matches_jax_and_scipy(iterations):
    m = np.random.default_rng(3).random((9, 10, 11)) > 0.95
    got = tf.binary_dilation(torch.from_numpy(m), iterations).numpy()
    assert got.dtype == np.bool_
    np.testing.assert_array_equal(
        got, np.asarray(jf.binary_dilation(jnp.asarray(m), iterations)))
    np.testing.assert_array_equal(
        got, ndimage.binary_dilation(m, iterations=iterations))


def test_numpy_input_lands_on_the_cpu():
    out = tf.gaussian_filter(_vol(4), 1.0)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"


def test_mae_and_lmax_match_jax():
    from exaspim_tpu.ops.ssim import compute_lmax as jl, compute_mae as jm
    from exaspim_tpu_torch.ops.ssim import compute_lmax, compute_mae

    a, b = _vol(5), _vol(6)
    np.testing.assert_allclose(float(compute_mae(a, b)), float(jm(a, b)),
                               rtol=1e-6)
    assert float(compute_lmax(a, b)) == float(jl(a, b))
    ua, ub = a.astype(np.uint16), b.astype(np.uint16)
    assert float(compute_lmax(ua.astype(np.int32), ub.astype(np.int32))) == \
        float(jl(ua, ub))
