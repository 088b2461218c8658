"""The per-step orientation draw and the augmented cached step against
exaspim_tpu.train.state.

* ``orientation_code(seed, step)`` equals JAX's
  ``randint(fold_in(key(seed), step), (), 0, 48)`` for seeds 0-7 and steps
  0-255, exactly. The draw depends on ``jax_threefry_partitionable``
  (it changes how ``split`` and the random bits hash their counters); the
  tests pin it on, JAX's default, which the reference ran with.
* The port's augmented cached step (f32, width 0.25 UNet, ``head_init=
  "normal"``, packed fg with the foreground-preserving target, so the mask
  is oriented too) against the JAX step from the same params, cache and
  seed, three steps (orientation codes 28, 13, 16 for seed 3: three axis
  permutations, flips of two axes). Each step of the port starts from the
  JAX state's params at that step count: the losses agree within 1e-5
  relative, the tolerance of ``test_torch_port_train_step.py``'s cached
  step. (Chained on their own params instead, the two drift apart by up
  to 7e-4 relative in three steps, augmented or not: Adam's first steps
  are ≈ lr·sign(g), and a gradient within f32 rounding of zero takes the
  other sign in the other framework. The update itself is held to optax
  in ``test_torch_port_train_step.py``.)
* ``Trainer(augment=True)`` against the JAX Trainer from one checkpoint
  (the default zero head; 4 patches of 16³, batch 2, 2 epochs): the logged loss and the
  validation metrics within 1e-3 relative, as
  ``test_torch_port_trainer.py`` holds the unaugmented Trainer.
* As in the JAX Trainer (``exaspim_tpu/train/trainer.py:426, :475``),
  ``augment=True`` raises without the card-resident cache (both packages
  held) and on non-cubic patches.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import Trainer as JaxTrainer
from exaspim_tpu.train import state as js
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data.cache import CachedPatchDataset, \
    CachedValidateDataset
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train import state as ts
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")


@pytest.fixture(autouse=True)
def partitionable_threefry():
    with jax.threefry_partitionable(True):
        yield


def test_orientation_code_of_seed_3():
    assert [ts.orientation_code(3, s) for s in range(10)] == [
        28, 13, 16, 31, 23, 34, 11, 6, 44, 40]


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's codes for seeds 0-7 x steps 0-255, in one compiled call."""
    with jax.threefry_partitionable(True):
        draw = jax.jit(jax.vmap(jax.vmap(
            lambda seed, step: jax.random.randint(jax.random.fold_in(
                jax.random.key(seed), step), (), 0, 48),
            in_axes=(None, 0)), in_axes=(0, None)))
        return np.asarray(draw(jnp.arange(8, dtype=jnp.int32),
                               jnp.arange(256, dtype=jnp.int32)))


@pytest.mark.parametrize("seed", range(8))
def test_orientation_code_matches_jax_draw(seed, jax_draws):
    got = [ts.orientation_code(seed, s) for s in range(256)]
    np.testing.assert_array_equal(got, jax_draws[seed])


def test_orientation_code_takes_int32_seeds():
    assert ts.orientation_code(-1, 5) == int(jax.random.randint(
        jax.random.fold_in(jax.random.key(-1), 5), (), 0, 48))
    with pytest.raises(ValueError, match="int32"):
        ts.orientation_code(2 ** 31, 0)


def test_augmented_cached_step_matches_jax():
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    rng = np.random.default_rng(5)
    raw = rng.poisson(300.0, (6, 16, 16, 16)).astype(np.uint16)
    teacher = rng.poisson(300.0, raw.shape).astype(np.uint16)
    fg = rng.random(raw.shape) < 0.2
    kw = dict(fg_weight=20.0, preserve_foreground=True, fg_packed=True,
              patch_shape=(16, 16, 16), augment=True, seed=3)
    jstate = js.create_train_state(jm, params=params, total_steps=3)
    jstep = js.make_cached_train_step(transform=jax_transform(TCFG),
                                      donate=False, **kw)
    step = ts.make_cached_train_step(transform=build_transform(TCFG), **kw)
    dev = [torch.from_numpy(raw.view(np.int16)),
           torch.from_numpy(teacher.view(np.int16)),
           torch.from_numpy(ts.pack_fg_bits(fg))]
    codes = []
    orient = ts.orient_batch

    def spy(batch, code):
        codes.append(code)
        return orient(batch, code)

    for i, idx in enumerate(([2, 0], [5, 1], [3, 4])):
        # The port's step from the JAX state's params at the same step
        # count, so each loss reads that step's draw and batch alone.
        state = ts.create_train_state(
            UNet(**KW), total_steps=3,
            params=jax.tree.map(np.asarray, jstate.params))
        state.step = i
        ts.orient_batch = spy
        try:
            state, loss = step(state, *dev, torch.tensor(idx))
        finally:
            ts.orient_batch = orient
        jstate, want = jstep(jstate, jnp.asarray(raw), jnp.asarray(teacher),
                             jnp.asarray(js.pack_fg_bits(fg)),
                             jnp.asarray(idx, jnp.int32))
        np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
        # raw + teacher in one pass, then fg: one code each step.
        assert codes[-2:] == [ts.orientation_code(3, i)] * 2
        assert state.step == int(jstate.step) == i + 1


def test_orientation_changes_the_step():
    """The same batch and params with and without the draw (seed 3, step
    0: code 28) give different losses, so the orientation reaches the
    model."""
    rng = np.random.default_rng(6)
    raw = torch.from_numpy(rng.poisson(300.0, (2, 16, 16, 16)).astype(
        np.int16))
    teacher = torch.from_numpy(rng.poisson(300.0, (2, 16, 16, 16)).astype(
        np.int16))
    losses = []
    for augment in (False, True):
        torch.manual_seed(0)
        state = ts.create_train_state(UNet(**KW), total_steps=1)
        step = ts.make_cached_train_step(
            0.0, transform=build_transform(TCFG), augment=augment, seed=3)
        losses.append(step(state, raw, teacher, None,
                           torch.tensor([0, 1]))[1].item())
    assert losses[0] != losses[1]


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("augment")
    out = {}
    for name, patch in (("cube", (16, 16, 16)), ("slab", (8, 16, 16))):
        out[name] = (
            make_synthetic_cache(str(root / name / "train"), 4, patch, TCFG,
                                 seed=1),
            make_synthetic_cache(str(root / name / "val"), 2, patch, TCFG,
                                 seed=2))
    return root, out


@pytest.mark.parametrize("case,match", [
    ("loader", "device-cache"), ("slab", "cubic")])
def test_augment_raises_as_jax(caches, case, match):
    root, dirs = caches
    train, val = dirs["cube" if case == "loader" else case]
    dev_cache = case != "loader"
    if case == "loader":  # the JAX Trainer raises before building a state
        jt = JaxTrainer(str(root / f"jax-{case}"), JaxUNet(**KW),
                        jax_transform(TCFG), epochs=1, batch_size=2,
                        augment=True, device_cache=dev_cache,
                        tensorboard=False, keep_mips=0)
        with pytest.raises(ValueError, match=match):
            jt.run(JCached(train), JVal(val))
    tt = Trainer(str(root / f"port-{case}"), UNet(**KW),
                 build_transform(TCFG), epochs=1, batch_size=2, augment=True,
                 device_cache=dev_cache, exact_cratio_examples=0,
                 device="cpu")
    with pytest.raises(ValueError, match=match):
        tt.run(CachedPatchDataset(train), CachedValidateDataset(val))


def _events(trainer):
    with open(os.path.join(trainer.session_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_augmented_trainer_matches_jax(caches):
    root, dirs = caches
    train, val = dirs["cube"]
    jm = JaxUNet(width_multiplier=0.25)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    run = dict(epochs=2, batch_size=2, val_every=2, seed=5, augment=True)
    jt = JaxTrainer(str(root / "jax-run"), JaxUNet(width_multiplier=0.25), jax_transform(TCFG),
                    tensorboard=False, keep_mips=0, exact_cratio_examples=0,
                    **run)
    jt.load_pretrained_weights(ckpt)
    jt.run(JCached(train), JVal(val))
    tt = Trainer(str(root / "port-run"), UNet(width_multiplier=0.25), build_transform(TCFG),
                 exact_cratio_examples=0, device="cpu", **run)
    tt.load_pretrained_weights(ckpt)
    tt.run(CachedPatchDataset(train), CachedValidateDataset(val))
    je, te = _events(jt), _events(tt)
    for kind in ("train", "val"):
        a = [e for e in te if e["event"] == kind]
        b = [e for e in je if e["event"] == kind]
        assert [e["step"] for e in a] == [e["step"] for e in b]
        for x, y in zip(a, b):
            for k in ("loss", "val_loss", "val_fg_mae", "val_bg_mae",
                      "val_score"):
                if k in y:
                    assert abs(x[k] - y[k]) <= 1e-3 * abs(y[k]), (k, x, y)
    with open(os.path.join(tt.session_dir, "config.json")) as f:
        assert json.load(f)["augment"] is True
