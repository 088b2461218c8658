"""The port's end-to-end demo against ``scripts/demo_end_to_end.py``.

The JAX demo runs as it is (loaded by path, ``main`` called) at a tiny
configuration (8 train and 4 val patches of 32³, 1 epoch at batch 4, a
width-0.25 UNet), with two things wrapped for the call: its
``restore_pipeline`` builds the held-out model in f32 (the script builds
bf16), and its compilation-cache setting is dropped. Both run on the CPU.

* ``make_foreground_mask`` is bit-equal to the JAX package's on the
  held-out phantom (clean and noisy), for k ∈ {3, 6} and dilate ∈ {0, 1, 2};
  the threshold the port takes on the card (f64, numpy's median) equals
  numpy's on a CPU tensor.
* ``score_checkpoint`` of the port (f32 on the CPU) on the JAX run's best
  checkpoint agrees with that run's ``summary.json`` field by field. The
  two f32 predictions differ by a count on a few voxels (f32 sums in other
  orders), so: the noisy block's cratio, PSNR and SSIM-free fields equal
  (the same computation on the same volume); cratio of the output within
  0.02 (a ratio printed to 2 decimals); PSNR within 0.01 dB and the
  metrics within their printed rounding plus a count's effect (below);
  SSIM within 3e-4: the JAX package's ``ssim3d`` reads 2.1e-4 above the
  float64 formula on this block (ROADMAP §3), the port within 1e-7 of it.
* The port's demo at the same configuration (``--device cpu``) writes a
  summary with the JAX demo's keys plus the three proxy keys, the same raw
  patches and masks, and teachers within the cross-package tolerance of
  ``test_torch_port_precompute.py`` (different matchers pick equally good
  group members among near-ties: RMSE of the difference ≤ 0.2·σ).
"""

import contextlib
import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaspim_tpu.train
from exaspim_tpu.ops.metrics import make_foreground_mask as jax_mask
from exaspim_tpu_torch import demo_end_to_end as demo
from exaspim_tpu_torch.compression import blosc_available
from exaspim_tpu_torch.ops.metrics import (
    make_foreground_mask,
    robust_brightness_threshold,
    tensor_brightness_threshold,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--n-train", "8", "--n-val", "4", "--patch", "32", "--epochs", "1",
        "--batch-size", "4", "--width", "0.25"]
SIGMA = 24.0
PROXY_KEYS = {"cratio_proxy_raw", "cratio_proxy_denoised",
              "cratio_proxy_gain"}


@contextlib.contextmanager
def _jax_script():
    scripts = os.path.join(ROOT, "scripts")
    sys.path.insert(0, scripts)
    update = jax.config.update
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.config, "update", lambda k, v: None
                      if k == "jax_compilation_cache_dir" else update(k, v))
            m.setattr(exaspim_tpu.train, "restore_pipeline", functools.partial(
                exaspim_tpu.train.restore_pipeline, dtype=jnp.float32))
            spec = importlib.util.spec_from_file_location(
                "demo_script", os.path.join(scripts, "demo_end_to_end.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            yield mod
    finally:
        sys.path.remove(scripts)


@pytest.fixture(scope="module")
def jax_demo(tmp_path_factory):
    if not blosc_available():
        pytest.skip("the JAX demo needs libblosc")
    out = str(tmp_path_factory.mktemp("jax_demo"))
    with _jax_script() as mod:
        mod.main(["--out", out] + TINY)
    with open(os.path.join(out, "summary.json")) as f:
        return out, json.load(f)


@pytest.fixture(scope="module")
def held_out():
    return demo.held_out_volumes()


@pytest.mark.parametrize("k", [3.0, 6.0])
@pytest.mark.parametrize("dilate", [0, 1, 2])
def test_foreground_mask_bit_equal(k, dilate, held_out):
    clean, noisy = held_out
    clean_u16 = np.clip(np.round(clean), 0, 65535).astype(np.uint16)
    for vol in (clean_u16, noisy):
        want = jax_mask(vol, k=k, dilate=dilate)
        got = make_foreground_mask(vol, k=k, dilate=dilate)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        t = make_foreground_mask(torch.from_numpy(vol.astype(np.int32)),
                                 k=k, dilate=dilate)
        np.testing.assert_array_equal(t.numpy(), want)
        assert tensor_brightness_threshold(
            torch.from_numpy(vol.astype(np.int32)), k) \
            == robust_brightness_threshold(vol, k)


def test_threshold_median_of_an_even_count():
    v = np.random.default_rng(0).integers(0, 500, 1000).astype(np.uint16)
    assert tensor_brightness_threshold(torch.from_numpy(v.astype(
        np.int32))) == robust_brightness_threshold(v)


def test_held_out_scoring_matches_the_jax_demo(jax_demo):
    _, want = jax_demo
    got = demo.score_checkpoint(want["checkpoint"], device="cpu")
    assert set(got) - set(want) == PROXY_KEYS
    assert got["checkpoint"] == want["checkpoint"]
    for k in ("cratio_raw", "psnr_vs_clean_raw"):
        assert got[k] == want[k], k
    assert abs(got["ssim_vs_clean_raw"] - want["ssim_vs_clean_raw"]) <= 3e-4
    assert abs(got["cratio_denoised"] - want["cratio_denoised"]) <= 0.02
    assert abs(got["cratio_gain"] - want["cratio_gain"]) <= 0.01
    assert abs(got["psnr_vs_clean_denoised"]
               - want["psnr_vs_clean_denoised"]) <= 0.01 + 1e-9
    assert abs(got["ssim_vs_clean_denoised"]
               - want["ssim_vs_clean_denoised"]) <= 3e-4
    # Means over the 2M voxels of the block (or their fg / bg part): a
    # count on a few voxels moves them far below their 3-decimal rounding;
    # the 99.9th percentile and the maximum move by at most the count.
    for k in ("fg_mae", "bg_mae", "top_pct_preservation",
              "false_bright_rate"):
        assert abs(got[k] - want[k]) <= 1e-3 + 1e-9, k
    for k in ("top_pct_error", "mip_max_error"):
        assert abs(got[k] - want[k]) <= 1.0 + 1e-9, k
    assert got["cratio_proxy_gain"] > 0 and np.isfinite(
        got["cratio_proxy_gain"])


def test_port_demo_matches_the_jax_demo(jax_demo, tmp_path):
    jax_out, want = jax_demo
    out = str(tmp_path / "port")
    got = demo.main(["--out", out, "--device", "cpu"] + TINY)
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == got
    assert list(k for k in got if k not in PROXY_KEYS) == list(want)
    for k in ("n_train", "epochs", "width", "loss_eps", "sigma_bm4d",
              "bm4d_step", "augment", "cratio_raw", "psnr_vs_clean_raw"):
        assert got[k] == want[k], k
    assert os.path.exists(got["checkpoint"])
    for split in ("cache_train", "cache_val"):
        for name in ("raw.npy", "fg.npy"):
            np.testing.assert_array_equal(
                np.load(os.path.join(out, split, name)),
                np.load(os.path.join(jax_out, split, name)))
        raw = np.load(os.path.join(out, split, "raw.npy")).astype(np.float64)
        a = np.load(os.path.join(out, split, "teacher.npy")).astype(
            np.float64)
        b = np.load(os.path.join(jax_out, split, "teacher.npy"))
        gap = np.sqrt(np.mean((a - b) ** 2))
        assert gap <= 0.2 * SIGMA, (split, gap)
        assert gap < np.sqrt(np.mean((a - raw) ** 2))
