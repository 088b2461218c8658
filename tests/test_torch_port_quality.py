"""The quality guard's cratio leg on an output of the port, against JAX.

The shipped checkpoint (``checkpoints/bm4dnet.msgpack``) is restored in
both packages and denoises the same small block of the bench's phantom
(``neurite_phantom`` + ``noisy_observation``, each package's own copy) with
``predict`` in f32 on the CPU. Each output is scored as ``bench.py`` scores
it: the blosc-zstd (level 6) chunked compression ratio of noisy and
denoised, and PSNR and SSIM against the clean phantom. The port's cratio
gain must be within 0.02 of the JAX package's. The two f32 outputs differ
by one count on a few voxels (f32 sums in another order; 21 of 110,592
here), which moves PSNR by ~1e-3 dB: PSNR is held within 0.01 dB, the
resolution ``bench.py`` reports. SSIM is held at the tolerance of
``tests/test_torch_port_metrics.py`` (rtol 1e-5) where one function scores
both outputs; across the packages the two ``ssim3d`` differ by ~5e-5 on
the same array (f32 cancellation in E[x²] − E[x]² near SSIM = 1), so that
comparison is held within 1e-4. Skips where libblosc is missing (the
card's machine has none, so this is where the port's cratio leg is held).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.compression.blosc import BloscCodec as JaxBlosc
from exaspim_tpu.compression.blosc import blosc_available as jax_blosc_ok
from exaspim_tpu.compression.cratio import compute_cratio as jax_cratio
from exaspim_tpu.data.synthetic import neurite_phantom as jax_phantom
from exaspim_tpu.data.synthetic import noisy_observation as jax_noisy
from exaspim_tpu.inference import predict as jax_predict
from exaspim_tpu.ops.ssim import psnr as jax_psnr
from exaspim_tpu.ops.ssim import ssim3d as jax_ssim
from exaspim_tpu.train.checkpoint import restore_pipeline as jax_restore
from exaspim_tpu_torch.compression import (
    BloscCodec,
    blosc_available,
    compute_cratio,
)
from exaspim_tpu_torch.data.synthetic import neurite_phantom, noisy_observation
from exaspim_tpu_torch.inference import predict
from exaspim_tpu_torch.ops.ssim import psnr, ssim3d
from exaspim_tpu_torch.train.checkpoint import restore_pipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack")
# A 48^3 block of the bench's generators (the bench's own is 256^3 with 24
# tubes): small enough for the CPU, with tubes and background both present.
SHAPE, TUBES = (48, 48, 48), 6
TILING = dict(patch_size=32, overlap=12, trim=5, batch_size=4)
GAIN_ATOL = 0.02
PSNR_ATOL_DB = 0.01
SSIM_RTOL, SSIM_CROSS_ATOL = 1e-5, 1e-4


def _score(noisy, out, clean, cratio, codec, psnr_fn, ssim_fn):
    drange = float(clean.max())
    return {
        "cratio_gain": cratio(out, codec) / cratio(noisy, codec),
        "psnr": float(psnr_fn(out.astype(np.float32), clean, drange)),
        "ssim": float(ssim_fn(out.astype(np.float32), clean,
                              data_range=drange)),
    }


def test_cratio_gain_with_the_shipped_checkpoint_matches_jax():
    if not (blosc_available() and jax_blosc_ok()):
        pytest.skip("libblosc is not installed on this host")
    clean, _ = neurite_phantom(SHAPE, n_tubes=TUBES, seed=0)
    noisy = noisy_observation(clean, seed=1)
    jclean, _ = jax_phantom(SHAPE, n_tubes=TUBES, seed=0)
    jnoisy = jax_noisy(jclean, seed=1)
    np.testing.assert_array_equal(noisy, jnoisy)

    model, transform = restore_pipeline(CKPT, dtype=torch.float32,
                                        device="cpu")
    with torch.no_grad():
        out = predict(noisy, model, transform, device="cpu", **TILING)
    jmodel, jparams, jtransform = jax_restore(CKPT, dtype=jnp.float32)
    jout = np.asarray(jax_predict(jnoisy, jmodel, jparams, jtransform,
                                  **TILING))
    assert out.dtype == jout.dtype == np.uint16
    # f32 sums in other orders: a count may round the other way.
    d = np.abs(out.astype(np.int32) - jout.astype(np.int32))
    assert int(d.max()) <= 1 and float((d > 0).mean()) <= 1e-3

    got = _score(noisy, out, clean, compute_cratio,
                 BloscCodec(cname="zstd", clevel=6), psnr, ssim3d)
    want = _score(jnoisy, jout, jclean, jax_cratio,
                  JaxBlosc(cname="zstd", clevel=6), jax_psnr, jax_ssim)
    print(f"cratio gain port {got['cratio_gain']:.4f} jax "
          f"{want['cratio_gain']:.4f}; psnr {got['psnr']:.4f} / "
          f"{want['psnr']:.4f}; ssim {got['ssim']:.6f} / {want['ssim']:.6f}")
    # The checkpoint denoises this block (it is no identity map); the
    # block's border keeps the gain below the 256^3 block's ~2.
    assert want["cratio_gain"] > 1.2
    assert abs(got["cratio_gain"] - want["cratio_gain"]) <= GAIN_ATOL
    assert abs(got["psnr"] - want["psnr"]) <= PSNR_ATOL_DB
    drange = float(clean.max())
    for ssim_fn in (ssim3d, jax_ssim):
        np.testing.assert_allclose(
            float(ssim_fn(out.astype(np.float32), clean, data_range=drange)),
            float(ssim_fn(jout.astype(np.float32), clean, data_range=drange)),
            rtol=SSIM_RTOL)
    assert abs(got["ssim"] - want["ssim"]) <= SSIM_CROSS_ATOL
    # The guard's SSIM leg decides alike: denoised not below noisy.
    for score, fn in ((got, ssim3d), (want, jax_ssim)):
        assert score["ssim"] >= float(fn(noisy.astype(np.float32), clean,
                                         data_range=drange))
