"""The port's quality metrics and phantom against the JAX package's.

SSIM/PSNR agree to 1e-5 (f32 filters, sums in another order); the
phantom and the blosc chunked ratio are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.compression.blosc import blosc_available as jax_blosc_ok
from exaspim_tpu.compression.cratio import compute_cratio as jax_cratio
from exaspim_tpu.data.synthetic import neurite_phantom as jax_phantom
from exaspim_tpu.data.synthetic import noisy_observation as jax_noisy
from exaspim_tpu.ops.filters import uniform_filter as jax_uniform
from exaspim_tpu.ops.ssim import psnr as jax_psnr
from exaspim_tpu.ops.ssim import ssim3d as jax_ssim
from exaspim_tpu_torch.compression import (
    BloscCodec,
    blosc_available,
    compute_cratio,
)
from exaspim_tpu_torch.data.synthetic import neurite_phantom, noisy_observation
from exaspim_tpu_torch.ops.ssim import psnr, ssim3d, uniform_filter


@pytest.fixture(scope="module")
def volumes():
    clean, fg = neurite_phantom((40, 36, 44), n_tubes=6, seed=3)
    noisy = noisy_observation(clean, seed=4)
    return clean, fg, noisy


def test_phantom_equals_jax_package(volumes):
    clean, fg, noisy = volumes
    jc, jfg = jax_phantom((40, 36, 44), n_tubes=6, seed=3)
    np.testing.assert_array_equal(clean, jc)
    np.testing.assert_array_equal(fg, jfg)
    np.testing.assert_array_equal(noisy, jax_noisy(jc, seed=4))


def test_uniform_filter_matches_jax():
    x = np.random.default_rng(0).normal(size=(20, 18, 17)).astype(np.float32)
    np.testing.assert_allclose(
        uniform_filter(torch.from_numpy(x), 16).numpy(),
        np.asarray(jax_uniform(jnp.asarray(x), 16)), atol=1e-5, rtol=1e-5)


def test_ssim_psnr_match_jax(volumes):
    clean, _, noisy = volumes
    a = noisy.astype(np.float32)
    dr = float(clean.max())
    np.testing.assert_allclose(
        float(ssim3d(a, clean, data_range=dr)),
        float(jax_ssim(a, clean, data_range=dr)), rtol=1e-5)
    np.testing.assert_allclose(float(ssim3d(a, clean)),
                               float(jax_ssim(a, clean)), rtol=1e-5)
    np.testing.assert_allclose(float(psnr(a, clean, dr)),
                               float(jax_psnr(a, clean, dr)), rtol=1e-5)


def test_cratio_matches_jax(volumes):
    if not (blosc_available() and jax_blosc_ok()):
        pytest.skip("libblosc is not installed on this host")
    from exaspim_tpu.compression.blosc import BloscCodec as JaxBlosc

    noisy = volumes[2]
    assert compute_cratio(noisy, BloscCodec(clevel=6)) == jax_cratio(
        noisy, JaxBlosc(clevel=6))
