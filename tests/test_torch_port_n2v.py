"""Noise2Void training against exaspim_tpu.train.n2v and
scripts/train_n2v.py.

* ``inverse_float_smooth`` of every transform kind (asinh, Anscombe both
  inverses, linear, identity, an offset around Anscombe) against the JAX
  package's, below and above the transform's floor: within 1e-6 relative
  (f32 formulas in another order; measured ≤ 2e-7).
* The blind-spot draw: masks and shifts bit-equal to
  ``make_blind_spots(fold_in(key(seed), step), ...)`` at four (seed, step)
  pairs and two batch shapes, one of them a draw whose raw shifts hold the
  zero roll (seed 5, step 0, batch 16), which both replace; no zero shift
  is left. ``jax_threefry_partitionable`` is pinned on, JAX's default.
* One ``make_n2v_train_step`` step, plain and σ-aware (``sigma_gain=1``),
  from the same N2V2UNet parameters (width 0.25, value head, f32, batch 2
  of 16³, mask rate 0.05): the loss within 1e-5 relative of JAX's (1e-4
  σ-aware: the asinh inverse of a random head's prediction is exponential
  in it and multiplies its f32 rounding by up to ~10; measured 1.3e-5);
  the updated parameters within 1e-6 of JAX's except where a gradient within
  f32 rounding of zero took the other sign (Adam's first step is
  lr · sign(g) per element): at most 2 · lr there, on at most 0.5 % of
  the elements (measured: 881 of 806,569 plain, none σ-aware).
* ``sigma_gain`` without a transform raises in both.
* ``train_n2v.main`` at a tiny size (3 steps, 4 patches of 32³, batch 2,
  width 0.25) against ``scripts/train_n2v.py`` at the same flags, both in
  f32 and from the same initial parameters: the summary's keys (the
  script's, and the proxy ratios and ``step_s`` beside them), losses
  finite and falling, the logged losses within 1e-3 relative (steps
  chained on each package's own parameters drift apart as Adam's
  sign-like first updates flip on gradients within rounding of zero, as
  ``test_torch_port_augment.py`` measured: 3.3e-4 at step 2), the
  held-out PSNR within 0.05 dB and SSIM within 1e-3, the cratios within
  1 % (libblosc on this machine).
"""

import contextlib
import importlib.util
import inspect
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import exaspim_tpu.train
from exaspim_tpu.models import MODEL_REGISTRY as JAX_REGISTRY
from exaspim_tpu.models import N2V2UNet as JaxN2V2UNet
from exaspim_tpu.train import n2v as jn2v
from exaspim_tpu.train.state import create_train_state as jax_state
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data.loader import to_tensor
from exaspim_tpu_torch.models import N2V2UNet
from exaspim_tpu_torch.train import n2v, prng
from exaspim_tpu_torch.train.checkpoint import (
    params_from_flax,
    params_to_flax,
)
from exaspim_tpu_torch.train.state import create_train_state
from exaspim_tpu_torch.transforms import build_transform

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
LR = 1e-3
TINY = ["--steps", "3", "--n-patches", "4", "--patch", "32",
        "--batch-size", "2", "--width", "0.25"]


@pytest.fixture(autouse=True)
def partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


@pytest.mark.parametrize("cfg", [
    TCFG,
    {"kind": "anscombe", "params": {"gain": 2.0, "read_noise": 3.0,
                                    "offset": 90.0}},
    {"kind": "anscombe", "params": {"unbiased_inverse": False}},
    {"kind": "linear", "params": {"mn": 100.0, "mx": 900.0}},
    {"kind": "identity"},
    {"kind": "offset", "base": {"kind": "anscombe"},
     "params": {"offset": 25.0}},
], ids=["asinh", "anscombe", "anscombe-algebraic", "linear", "identity",
        "offset"])
def test_inverse_float_smooth_matches_jax(cfg):
    y = np.linspace(-0.6, 1.2, 181, dtype=np.float32)  # both sides of 0
    want = np.asarray(jax_transform(cfg).inverse_float_smooth(
        jnp.asarray(y)))
    got = build_transform(cfg).inverse_float_smooth(
        torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    if cfg["kind"] in ("anscombe", "offset"):  # sign-extended below 0
        assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (-5, 123), (5, 0)])
@pytest.mark.parametrize("shape", [(16, 8, 8, 8), (3, 20, 12, 16)])
def test_blind_spots_bit_equal_to_jax(seed, step, shape):
    key = jax.random.fold_in(jax.random.key(seed), step)
    want_m, want_s = jn2v.make_blind_spots(key, shape, mask_rate=0.05)
    got_m, got_s = n2v.make_blind_spots(
        prng.fold_in(prng.key(seed), step), shape, mask_rate=0.05,
        device="cpu")
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_m.sum() > 0
    assert not (got_s == 0).all(dim=1).any()


def test_zero_roll_case_is_drawn():
    """(5, 0) at batch 16 is the parametrised case whose raw draw holds
    the zero roll that both packages replace."""
    kshift = prng.split(prng.fold_in(prng.key(5), 0))[1]
    raw = prng.randint(kshift, (16, 3), -2, 3)
    assert (raw == 0).all(axis=1).any()
    assert raw.min() == -2 and raw.max() == 2


def _step_inputs():
    rng = np.random.default_rng(11)
    x = rng.poisson(300.0, (2, 16, 16, 16, 1)).astype(np.uint16)
    x[:, 4:8, 4:8] += rng.poisson(3000.0, (2, 4, 4, 16, 1)).astype(np.uint16)
    kw = dict(width_multiplier=0.25, head_init="normal", residual=False)
    tree = params_to_flax(N2V2UNet(**kw).init_weights(3).state_dict())
    return x, kw, tree


@pytest.mark.parametrize("sigma_gain", [None, 1.0])
def test_n2v_step_matches_jax(sigma_gain):
    x, kw, tree = _step_inputs()
    t = build_transform(TCFG)
    jstate = jax_state(JaxN2V2UNet(**kw), params=tree, total_steps=10,
                       lr=LR)
    jstep = jn2v.make_n2v_train_step(jax_transform(TCFG), mask_rate=0.05,
                                     sigma_gain=sigma_gain)
    jstate, want = jstep(jstate, jnp.asarray(x),
                         jax.random.fold_in(jax.random.key(2), 9))
    state = create_train_state(N2V2UNet(**kw), lr=LR, total_steps=10,
                               params=tree)
    step = n2v.make_n2v_train_step(t, mask_rate=0.05, sigma_gain=sigma_gain)
    state, loss = step(state, to_tensor(x, "cpu"),
                       prng.fold_in(prng.key(2), 9))
    np.testing.assert_allclose(loss.item(), float(want),
                               rtol=1e-5 if sigma_gain is None else 1e-4)
    want_p = params_from_flax(jax.tree.map(np.asarray, jstate.params))
    got_p = dict(state.model.named_parameters())
    n = flipped = 0
    for k, w in want_p.items():
        d = (got_p[k].detach() - w).abs()
        assert float(d.max()) <= 2 * LR * 1.001, k
        n += d.numel()
        flipped += int((d > 1e-6).sum())
    assert flipped <= 0.005 * n, (flipped, n)


def test_sigma_gain_needs_a_transform():
    for make in (jn2v.make_n2v_train_step, n2v.make_n2v_train_step):
        with pytest.raises(ValueError, match="sigma_gain requires"):
            make(sigma_gain=1.0)


@contextlib.contextmanager
def _jax_script(init_tree):
    """``scripts/train_n2v.py`` in f32, starting from ``init_tree``."""
    scripts = os.path.join(ROOT, "scripts")
    sys.path.insert(0, scripts)
    update = jax.config.update

    def f32_model(**kw):
        return JaxN2V2UNet(**{**kw, "dtype": jnp.float32})

    def from_tree(model, **kw):
        return jax_state(model, params=init_tree, **kw)

    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.config, "update", lambda k, v: None
                      if k == "jax_compilation_cache_dir" else update(k, v))
            m.setitem(JAX_REGISTRY, "N2V2UNet", f32_model)
            m.setattr(exaspim_tpu.train, "create_train_state", from_tree)
            spec = importlib.util.spec_from_file_location(
                "train_n2v_script", os.path.join(scripts, "train_n2v.py"))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            yield mod
    finally:
        sys.path.remove(scripts)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from exaspim_tpu_torch.compression import blosc_available
    from exaspim_tpu_torch.train import train_n2v

    if not blosc_available():
        pytest.skip("the JAX script needs libblosc")
    init = N2V2UNet(width_multiplier=0.25, head_init="normal",
                    residual=False).init_weights(0)
    tree = params_to_flax(init.state_dict())
    out = {}
    for name in ("jax", "port"):
        d = str(tmp_path_factory.mktemp(name))
        if name == "jax":
            with jax.threefry_partitionable(True), _jax_script(tree) as mod:
                mod.main(["--out", d] + TINY)
        else:
            train_n2v.main(["--out", d, "--device", "cpu"] + TINY)
        with open(os.path.join(d, "summary.json")) as f:
            out[name] = json.load(f)
    return out


def test_train_n2v_summary_matches_the_script(runs):
    want, got = runs["jax"], runs["port"]
    extra = {"cratio_proxy_noisy", "cratio_proxy_denoised",
             "cratio_proxy_gain", "step_s"}
    assert set(got) == set(want) | extra
    for k in ("model", "sigma_gain", "steps", "width"):
        assert got[k] == want[k], k
    losses = [e["loss"] for e in got["train_log"]]
    assert [e["step"] for e in got["train_log"]] == [
        e["step"] for e in want["train_log"]] == [0, 2]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    np.testing.assert_allclose(
        losses, [e["loss"] for e in want["train_log"]], rtol=1e-3)
    for k in ("psnr_noisy_db", "psnr_denoised_db"):
        assert abs(got[k] - want[k]) <= 0.05, k
    for k in ("ssim_noisy", "ssim_denoised"):
        assert abs(got[k] - want[k]) <= 1e-3, k
    for k in ("cratio_noisy", "cratio_denoised"):
        assert abs(got[k] - want[k]) <= 0.01 * want[k], k
    assert got["step_s"] is None  # no window after step 200 in 3 steps
    assert np.isfinite(got["cratio_proxy_gain"])


def test_new_entry_points_default_to_the_card(tmp_path):
    from exaspim_tpu_torch import import_torch_checkpoint as entry
    from exaspim_tpu_torch.train import import_torch_checkpoint, train_n2v

    assert inspect.signature(import_torch_checkpoint).parameters[
        "device"].default == "cuda"
    assert inspect.signature(n2v.make_blind_spots).parameters[
        "device"].default == "cuda"
    for main in (train_n2v.main, entry.main):
        with pytest.MonkeyPatch.context() as m:
            m.setattr(torch.cuda, "is_available", lambda: False)
            argv = (["--out", str(tmp_path)] if main is train_n2v.main
                    else ["a.pth", "b.msgpack"])
            with pytest.raises(RuntimeError, match="--device cpu"):
                main(argv)


def test_no_jax_scan_covers_the_new_modules():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from test_torch_port_inference import _port_files
    finally:
        sys.path.pop(0)
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    for rel in ("import_torch_checkpoint.py", "train/train_n2v.py",
                "train/n2v.py", "train/prng.py"):
        assert os.path.join("exaspim_tpu_torch", rel) in names, rel
