"""The port's BM4D denoiser against exaspim_tpu.ops.bm4d on the CPU.

The same numpy-seeded volumes go through both packages. On CPU tensors
the port's ``matcher="kernel"`` runs the plain versions of its two
matching kernels; the JAX side runs its Pallas matcher in interpret mode,
patched into the jitted stage. Tolerances, and what each measures:

* one stage, same guide: the groups agree, so what is left is f32
  rounding in sums taken in another order, plus a rare coefficient that
  falls on the other side of the 2.7σ threshold: RMSE of the difference
  ≤ 1e-2·σ, and counts (rounded output) within 1;
* two stages: the port's stage-1 estimate differs from the reference's in
  the last bits, which re-ranks near-tied candidates in stage 2, so a few
  groups differ: RMSE of the difference ≤ 5e-2·σ, and at least 99 % of
  the rounded teachers within 1 count.
"""

import importlib

import numpy as np
import pytest
import torch

from exaspim_tpu.ops import pallas_bm4d
from exaspim_tpu_torch.data.synthetic import neurite_phantom, noisy_observation

jb = importlib.import_module("exaspim_tpu.ops.bm4d")
tb = importlib.import_module("exaspim_tpu_torch.ops.bm4d")

SIGMA = 24.0
KW = dict(block=4, group=8, step=3, search=5)
MATCHERS = {"kernel": "pallas", "dense": "xla"}


@pytest.fixture(scope="module")
def interpret_matcher():
    """Run the JAX package's Pallas matcher in interpret mode."""
    orig = pallas_bm4d.match_topk
    pallas_bm4d.match_topk = lambda *a, **k: orig(
        *a, **{**k, "interpret": True})
    yield
    pallas_bm4d.match_topk = orig


@pytest.fixture(scope="module")
def volume():
    clean, _ = neurite_phantom((20, 17, 16), n_tubes=3, seed=1)
    return noisy_observation(clean, seed=2).astype(np.float32)


def _rmse(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


@pytest.mark.parametrize("matcher", ["kernel", "dense"])
@pytest.mark.parametrize("mode", ["hard", "wiener"])
def test_stage_matches_jax(interpret_matcher, volume, mode, matcher):
    guide = volume if mode == "hard" else np.asarray(jb.bm4d_stage(
        volume, volume, SIGMA, mode="hard", matcher="xla", **KW))
    want = np.asarray(jb.bm4d_stage(volume, guide, SIGMA, mode=mode,
                                    matcher=MATCHERS[matcher], **KW))
    got = tb.bm4d_stage(volume, guide, SIGMA, mode=mode, matcher=matcher,
                        device="cpu", **KW)
    assert got.dtype == torch.float32 and got.shape == volume.shape
    got = got.numpy()
    assert _rmse(got, want) <= 1e-2 * SIGMA
    assert np.abs(np.round(got) - np.round(want)).max() <= 1


@pytest.mark.parametrize("matcher", ["kernel", "dense"])
def test_two_stage_bm4d_matches_jax(interpret_matcher, volume, matcher):
    want = np.asarray(jb.bm4d(volume, SIGMA, matcher=MATCHERS[matcher], **KW))
    got = tb.bm4d(volume, SIGMA, matcher=matcher, device="cpu", **KW).numpy()
    assert _rmse(got, want) <= 5e-2 * SIGMA
    counts = np.abs(np.round(got) - np.round(want))
    assert (counts <= 1).mean() >= 0.99
    # Both denoise: closer to each other than to the noisy input.
    assert _rmse(got, want) < 0.2 * _rmse(got, volume)
    one = tb.bm4d(volume, SIGMA, two_stage=False, matcher=matcher,
                  device="cpu", **KW)
    hard = tb.bm4d_stage(volume, volume, SIGMA, mode="hard", matcher=matcher,
                         device="cpu", **KW)
    assert torch.equal(one, hard)
    batch = tb.bm4d_batch(np.stack([volume, volume[::-1]]), SIGMA,
                          matcher=matcher, device="cpu", **KW)
    assert batch.shape == (2, *volume.shape)
    assert torch.equal(batch[0], torch.from_numpy(got))


@pytest.mark.parametrize("name,args", [
    ("_dct_matrix_np", (16,)), ("_dct4_matrix_np", (5, 3)),
    ("_kron3_matrix_np", (4,)), ("_patch_kernel_np", (4, 2)),
    ("_patch_dct_kernel_np", (4, 2)), ("_col2im_kernel_np", (4,)),
    ("_col2im_agg_kernel_np", (4,)),
])
def test_constants_equal_jax(name, args):
    got, want = getattr(tb, name)(*args), getattr(jb, name)(*args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["hard", "wiener"])
def test_agg_variants_agree(volume, mode):
    a = tb.bm4d_stage(volume, volume, SIGMA, mode=mode, agg="slices",
                      device="cpu", **KW)
    b = tb.bm4d_stage(volume, volume, SIGMA, mode=mode, agg="conv",
                      device="cpu", **KW)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("option,value,use", [
    ("matcher", "auto", "kernel"), ("matcher", "pallas", "kernel"),
    ("matcher", "xla", "dense"), ("agg", "sorted", "slices"),
])
def test_reference_only_options_name_their_counterpart(option, value, use):
    """The reference's option values that the port does not carry raise
    with the value to pass instead."""
    vol = np.zeros((16, 16, 16), np.float32)
    with pytest.raises(ValueError, match=f"{option}='{use}'"):
        tb.bm4d(vol, 1.0, device="cpu", **{option: value})


def test_factored_transform_matches_dense_kronecker():
    """The DCT-emitting patch conv followed by the (K, K) contraction
    equals the dense (K·B³)² Kronecker matrix on raw patch rows."""
    B, K = 4, 6
    rng = np.random.default_rng(5)
    vol = torch.from_numpy(rng.normal(100.0, 20.0, (10, 11, 12)).astype(
        np.float32))
    raw = tb._conv_ndhwc(vol[..., None], tb._patch_kernel_np(B, 1))
    dct = tb._conv_ndhwc(vol[..., None], tb._patch_dct_kernel_np(B, 1))
    np.testing.assert_array_equal(raw[2, 3, 4].numpy(),
                                  vol[2:6, 3:7, 4:8].reshape(-1).numpy())
    idx = rng.integers(0, raw.shape[0] * raw.shape[1] * raw.shape[2], (7, K))
    g_raw = raw.reshape(-1, B ** 3).numpy()[idx]
    g_dct = dct.reshape(-1, B ** 3).numpy()[idx]
    dense = (g_raw.reshape(7, -1) @ tb._dct4_matrix_np(K, B).T).reshape(
        7, K, B ** 3)
    fact = np.einsum("lk,rkb->rlb", tb._dct_matrix_np(K), g_dct)
    np.testing.assert_allclose(fact, dense, rtol=1e-4, atol=1e-3)


def test_constant_volume_fixed_point_and_small_sigma():
    vol = np.full((16, 16, 16), 123.0, np.float32)
    den = tb.bm4d(vol, 10.0, device="cpu").numpy()
    # Wiener shrinkage biases the DC coefficient by ~σ²/coef²: a relative
    # error of order 1e-5 on a constant volume.
    np.testing.assert_allclose(den, vol, atol=0.01)
    rng = np.random.default_rng(0)
    vol = rng.normal(500.0, 5.0, (16, 16, 16)).astype(np.float32)
    # A vanishing threshold keeps nearly every coefficient.
    assert _rmse(tb.bm4d(vol, 1e-3, device="cpu").numpy(), vol) < 2.0


def test_bad_arguments_raise_and_flags_are_restored():
    vol = np.zeros((16, 16, 16), np.float32)
    with pytest.raises(ValueError, match="3D"):
        tb.bm4d(np.zeros((4, 4), np.float32), 1.0, device="cpu")
    with pytest.raises(ValueError, match="equal 3D"):
        tb.bm4d_stage(vol, vol[:8], 1.0, device="cpu")
    with pytest.raises(ValueError, match="matcher='dense'"):
        tb.bm4d_stage(np.zeros((22,) * 3, np.float32),
                      np.zeros((22,) * 3, np.float32), 1.0, search=17,
                      device="cpu")
    for bad in (dict(mode="soft"), dict(matcher="mxu"), dict(agg="fold")):
        with pytest.raises(ValueError, match="unknown"):
            tb.bm4d_stage(vol, vol, 1.0, device="cpu", **bad)
    import inspect

    for fn in (tb.bm4d, tb.bm4d_stage, tb.bm4d_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.are_deterministic_algorithms_enabled())
    tb.bm4d(vol + 5.0, 2.0, search=5, group=4, device="cpu")
    assert flags == (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32,
                     torch.are_deterministic_algorithms_enabled())
    import exaspim_tpu_torch

    assert exaspim_tpu_torch.bm4d is tb.bm4d


def test_search_above_15_runs_through_the_dense_matcher():
    rng = np.random.default_rng(2)
    vol = rng.normal(300.0, 10.0, (19, 19, 19)).astype(np.float32)
    out = tb.bm4d_stage(vol, vol, 10.0, search=17, group=8, matcher="dense",
                        device="cpu")
    assert out.shape == vol.shape and torch.isfinite(out).all()
    assert _rmse(out.numpy(), 300.0) < _rmse(vol, 300.0)
