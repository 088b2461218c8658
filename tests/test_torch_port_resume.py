"""Full-state resume: the port's ``latest_state.ckpt`` against the JAX
package's, both ways.

Tiny caches (8 train + 4 val 16³ patches, written by the JAX package), a
width-0.25 UNet in f32 on the CPU, both trainers warm-started from the same
checkpoint, batch 4 (2 steps an epoch), validation every 2 steps. A run of
one epoch writes ``latest_state.ckpt`` at step 2; a trainer of two epochs
resumes it and takes the second epoch (steps 3-4, the epoch's own
permutation), as a preempted two-epoch run would.

* A state the JAX package wrote resumes in the port, and one the port wrote
  resumes in the JAX package (read by ``exaspim_tpu.train.
  restore_train_state``: params, Adam's moments and counts bit-equal to the
  port's). After the two more steps, each package's params agree with the
  other's within 1e-5 absolute (lr 1e-3: Adam moves a parameter by at most
  ~1e-3 a step; the two frameworks' gradients differ at f32 rounding, which
  the moments carried over from the file keep from being amplified).
* Within the port, one epoch, preemption and resume gives the same bits as
  two epochs straight.
* Mismatched transform or model config raises, as
  ``tests/test_train.py::test_full_state_resume`` and
  ``::test_trainer_rejects_model_config_mismatch`` hold the JAX Trainer.
* ``full_state_every=3`` throttles the full-state file as
  ``tests/test_train.py::test_full_state_every_throttles_resume_checkpoint``.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import Trainer as JaxTrainer
from exaspim_tpu.train import create_train_state as jax_state
from exaspim_tpu.train import restore_train_state as jax_restore
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data.cache import CachedPatchDataset, \
    CachedValidateDataset
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train.checkpoint import params_from_flax, \
    read_train_state
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")
RUN = dict(batch_size=4, val_every=2, seed=42)
ATOL = 1e-5


class Preempted(Exception):
    """Stands for the end of a preempted process."""


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    train = make_synthetic_cache(str(root / "train"), 8, (16, 16, 16), TCFG,
                                 seed=1)
    val = make_synthetic_cache(str(root / "val"), 4, (16, 16, 16), TCFG,
                               seed=2)
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    return root, train, val, ckpt


def _jax_run(out, caches, epochs, resume=None):
    _, train, val, ckpt = caches
    t = JaxTrainer(str(out), JaxUNet(**KW), jax_transform(TCFG),
                   tensorboard=False, keep_mips=0, epochs=epochs, **RUN)
    t.load_pretrained_weights(ckpt)
    state = t.run(JCached(train), JVal(val), resume_state=resume)
    return t, params_from_flax(jax.tree.map(np.asarray, state.params))


def _port_trainer(out, epochs, transform=TCFG, model=None, **kw):
    return Trainer(str(out), model or UNet(**KW), build_transform(transform),
                   device="cpu", epochs=epochs, exact_cratio_examples=0,
                   **{**RUN, **kw})


def _port_run(out, caches, epochs, resume=None, **kw):
    _, train, val, ckpt = caches
    t = _port_trainer(out, epochs, **kw)
    t.load_pretrained_weights(ckpt)
    state = t.run(CachedPatchDataset(train), CachedValidateDataset(val),
                  resume_state=resume)
    return t, {k: v.detach().clone() for k, v in state.params.items()}


def _latest(trainer):
    return os.path.join(trainer.ckpt_dir, "latest_state.ckpt")


def _close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=0,
                                   atol=ATOL, err_msg=k)


def test_jax_state_resumes_in_the_port(caches):
    root = caches[0]
    first, _ = _jax_run(root / "j1", caches, epochs=1)
    latest = _latest(first)
    _, want = _jax_run(root / "j2", caches, epochs=2, resume=latest)
    t, got = _port_run(root / "p2", caches, epochs=2, resume=latest)
    _close(got, want)
    tree, meta = read_train_state(_latest(t))
    assert int(tree["step"]) == meta["step"] == 4


def test_port_state_resumes_in_jax(caches, port_first):
    root = caches[0]
    first, params = port_first
    latest = _latest(first)
    template = jax_state(JaxUNet(**KW), patch_shape=(16, 16, 16), lr=1e-3,
                         total_steps=4, seed=42)
    restored, meta = jax_restore(latest, template)
    assert int(restored.step) == meta["step"] == 2
    assert meta["format"] == "exaspim_tpu.trainstate.v1"
    for k, v in params_from_flax(
            jax.tree.map(np.asarray, restored.params)).items():
        np.testing.assert_array_equal(v.numpy(), params[k].numpy(),
                                      err_msg=k)
    adam, _, sched = restored.opt_state
    assert int(adam.count) == int(sched.count) == 2
    tree, _ = read_train_state(latest)
    for key in ("mu", "nu"):
        want = params_from_flax(tree["opt_state"]["0"][key])
        got = params_from_flax(jax.tree.map(np.asarray, getattr(adam, key)))
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())
    _, want = _jax_run(root / "j3", caches, epochs=2, resume=latest)
    _, got = _port_run(root / "p3", caches, epochs=2, resume=latest)
    _close(got, want)


def test_resume_equals_an_uninterrupted_run(caches, monkeypatch):
    root = caches[0]
    _, straight = _port_run(root / "straight", caches, epochs=2)
    save = Trainer.validate_and_checkpoint

    def preempt(self, *args):
        save(self, *args)
        raise Preempted

    _, train, val, ckpt = caches
    cut = _port_trainer(root / "cut", 2)
    cut.load_pretrained_weights(ckpt)
    with monkeypatch.context() as m:
        m.setattr(Trainer, "validate_and_checkpoint", preempt)
        with pytest.raises(Preempted):
            cut.run(CachedPatchDataset(train), CachedValidateDataset(val))
    latest = _latest(cut)
    assert read_train_state(latest)[1]["step"] == 2
    _, resumed = _port_run(root / "resumed", caches, epochs=2, resume=latest)
    for k in straight:
        np.testing.assert_array_equal(resumed[k].numpy(),
                                      straight[k].numpy(), err_msg=k)


@pytest.fixture(scope="module")
def port_first(caches):
    """The port's one-epoch run: its trainer and final params."""
    return _port_run(caches[0] / "p1", caches, epochs=1)


def test_resume_rejects_transform_and_model_mismatch(caches, port_first):
    root, train, val, _ = caches
    latest = _latest(port_first[0])
    other = {"kind": "asinh", "params": {"offset": 0.0, "scale": 9.0}}
    with pytest.raises(ValueError, match="transform"):
        _port_trainer(root / "m2", 2, transform=other).run(
            CachedPatchDataset(train), CachedValidateDataset(val),
            resume_state=latest)
    with pytest.raises(ValueError, match="model_config"):
        _port_trainer(root / "m3", 2, model=UNet(width_multiplier=0.5)).run(
            CachedPatchDataset(train), CachedValidateDataset(val),
            resume_state=latest)


@pytest.mark.parametrize("epochs,written", [(3, True), (2, False)])
def test_full_state_every_throttles(caches, epochs, written):
    root, train, val, _ = caches
    t = _port_trainer(root / f"fse{epochs}", epochs, full_state_every=3)
    t.run(CachedPatchDataset(train), CachedValidateDataset(val))
    scored = glob.glob(os.path.join(t.ckpt_dir, "BM4DNet-*.ckpt"))
    assert len(scored) == t._n_validations == epochs
    assert os.path.exists(_latest(t)) == written


def test_zero_dim_leaves_keep_their_shape():
    """The full state's counters are 0-d arrays; the port's writer once
    stored them with shape (1,) (``np.ascontiguousarray`` makes a 0-d
    array 1-d), which Flax then restored as 1-d."""
    from flax import serialization

    from exaspim_tpu_torch._msgpack import packb, unpackb

    tree = {"count": np.asarray(7, np.int32),
            "mu": np.arange(6, dtype=np.float32).reshape(2, 3).T}
    blob = packb(tree)
    for read in (serialization.msgpack_restore, unpackb):
        got = read(blob)
        for k, v in tree.items():
            assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v)
    assert blob == serialization.msgpack_serialize(tree)
