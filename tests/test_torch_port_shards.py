"""Shard rotation, TensorBoard scalars and validation MIPs of the port's
Trainer against ``exaspim_tpu.train.Trainer``.

A forced ``device_cache=True`` whose budget holds two batches of a
12-patch 16³ cache at batch 2 rotates 3 shards an epoch. Both trainers are
warm-started from one JAX-written checkpoint (width-0.25 UNet, f32 on the
CPU) and run 2 epochs (12 steps):

* the shard plan and every step's batch indices (shard start + the
  shard-local permutation of ``SeedSequence([seed, epoch, shard])``) are
  equal, exactly, and each epoch visits every patch once;
* the logged losses, the validation loss and the proxy stay within
  ``test_torch_port_trainer.py``'s 1e-3 relative; the count-space
  validation metrics within 1e-2 (read 5.4e-3 at most): after twelve
  AdamW steps, not four, the f32 parameter gaps are larger, and the
  asinh inverse maps the predictions of a barely trained model to counts
  that magnify them (MAEs of hundreds to thousands of counts); the exact
  cratio ±0.02 as there;
* ``config.json`` records ``device_cache_shards: 3``, and the uploads
  cover rows [0, 4), [4, 8), [8, 12) each epoch;
* both write the same TensorBoard scalar tags and the same
  ``keep_mips`` PNG names.

``_resolve_device_cache`` returns JAX's shard count for every gating
case, and ``_upload_cache`` of a row range crosses a multi-dir boundary.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import exaspim_tpu.train.state as jstate
import exaspim_tpu_torch.train.trainer as ttrainer
from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import Trainer as JaxTrainer
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data.cache import (
    CachedPatchDataset,
    CachedValidateDataset,
)
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")
N, B, P = 12, 2, (16, 16, 16)
ROW_B = 2 * 2 * 16 ** 3  # raw + teacher uint16 (fg skipped at fg_weight 0)
RUN = dict(epochs=2, batch_size=B, val_every=100, seed=42, keep_mips=2,
           exact_cratio_examples=2, device_cache=True,
           device_cache_budget=2 * B * ROW_B + 1)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    train = make_synthetic_cache(str(root / "train"), N, P, TCFG, seed=1)
    val = make_synthetic_cache(str(root / "val"), 4, P, TCFG, seed=2)
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, *P, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    return root, train, val, ckpt


def _recording(trainer, make, rows):
    """Wrap ``trainer._upload_cache`` and the cached step ``make`` builds
    so that every step appends its global batch rows to ``rows``."""
    upload, lo = trainer._upload_cache, [0]

    def up(ds, row_lo=0, row_hi=None):
        lo[0] = row_lo
        return upload(ds, row_lo, row_hi)

    def made(*args, **kw):
        step = make(*args, **kw)

        def run(state, raw, teacher, fg, idx):
            rows.append([lo[0] + int(i) for i in np.asarray(idx)])
            return step(state, raw, teacher, fg, idx)

        return run

    trainer._upload_cache = up
    return made


def _events(trainer):
    with open(os.path.join(trainer.session_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _scalar_tags(trainer):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )

    acc = EventAccumulator(os.path.join(trainer.session_dir, "tb"))
    acc.Reload()
    return {t: [(e.step, e.value) for e in acc.Scalars(t)]
            for t in acc.Tags()["scalars"]}


def test_shard_rotation_matches_jax(caches, monkeypatch):
    root, train, val, ckpt = caches
    jrows, trows = [], []
    jt = JaxTrainer(str(root / "jax"), JaxUNet(**KW), jax_transform(TCFG),
                    **RUN)
    jt.load_pretrained_weights(ckpt)
    assert jt._resolve_device_cache(JCached(train)) == 3
    monkeypatch.setattr(jstate, "make_cached_train_step", _recording(
        jt, jstate.make_cached_train_step, jrows))
    jt.run(JCached(train), JVal(val))
    tt = Trainer(str(root / "port"), UNet(**KW), build_transform(TCFG),
                 device="cpu", log_every=1, **RUN)
    tt.load_pretrained_weights(ckpt)
    assert tt._resolve_device_cache(CachedPatchDataset(train)) == 3
    monkeypatch.setattr(ttrainer, "make_cached_train_step", _recording(
        tt, ttrainer.make_cached_train_step, trows))
    tt.run(CachedPatchDataset(train), CachedValidateDataset(val))

    # The batch-index stream: equal, and the plan it follows.
    assert trows == jrows and len(trows) == 2 * N // B
    want = []
    for epoch in range(2):
        for s in range(3):
            perm = np.random.default_rng(
                np.random.SeedSequence([42, epoch, s])).permutation(4)
            want += [[4 * s + int(i) for i in perm[lo:lo + B]]
                     for lo in range(0, 4, B)]
    assert trows == want
    for epoch in range(2):
        assert sorted(sum(trows[6 * epoch:6 * epoch + 6], [])) \
            == list(range(N))

    je, te = _events(jt), _events(tt)
    cfg = json.load(open(os.path.join(tt.session_dir, "config.json")))
    assert cfg["device_cache_shards"] == 3 and cfg["device_cache"] is True
    assert [e["rows"] for e in te if e["event"] == "device_cache_upload"] \
        == [[0, 4], [4, 8], [8, 12]] * 2
    jtrain = {e["step"]: e["loss"] for e in je if e["event"] == "train"}
    ttrain = {e["step"]: e["loss"] for e in te if e["event"] == "train"}
    assert len(ttrain) == 12
    for step, loss in jtrain.items():
        np.testing.assert_allclose(ttrain[step], loss, rtol=1e-3)
    jval = [e for e in je if e["event"] == "val"][-1]
    tval = [e for e in te if e["event"] == "val"][-1]
    for k in ("val_loss", "val_cratio_proxy"):
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-3, err_msg=k)
    for k in jval:
        if k.startswith("val_") and k not in ("val_loss", "val_cratio"):
            np.testing.assert_allclose(tval[k], jval[k], rtol=1e-2,
                                       err_msg=k)
    assert tval["val_cratio"] == pytest.approx(jval["val_cratio"], abs=0.02)

    # Observability: the same scalar tags and MIP names (the JAX trainer
    # leaves its writer's buffer to the writer's own schedule).
    jt._writer.flush()
    tags, jtags = _scalar_tags(tt), _scalar_tags(jt)
    assert set(tags) == set(jtags)
    assert {"train_loss", "voxels_per_sec", "val_loss", "val_score",
            "val_cratio_proxy", "val_fg_mae"} <= set(tags)
    # TensorBoard stores f32.
    assert tags["val_loss"] == [(12, pytest.approx(tval["val_loss"]))]
    assert tags["train_loss"] == [(k, pytest.approx(v))
                                  for k, v in sorted(ttrain.items())]
    names = sorted(os.path.basename(p)
                   for p in glob.glob(os.path.join(tt.mip_dir, "*.png")))
    assert names == sorted(os.path.basename(p) for p in glob.glob(
        os.path.join(jt.mip_dir, "*.png")))
    assert names == ["step0000012_ex0.png", "step0000012_ex1.png"]


def test_resolve_device_cache_matches_jax(caches, tmp_path):
    _, train, _, _ = caches
    ours, theirs = CachedPatchDataset(train), JCached(train)
    cases = [dict(device_cache="auto"), dict(device_cache=False),
             dict(device_cache=True),
             dict(device_cache="auto", device_cache_budget=1024),
             dict(device_cache=True, device_cache_budget=5 * B * ROW_B),
             dict(device_cache=True, device_cache_budget=B * ROW_B),
             dict(device_cache=True, device_cache_budget=7 * ROW_B,
                  batch_size=3),
             dict(device_cache="auto", batch_size=5),
             dict(device_cache=True, device_cache_budget=1024),
             dict(device_cache=True, batch_size=64)]
    for i, kw in enumerate(cases):
        kw = {"batch_size": B, **kw}
        t = Trainer(str(tmp_path / f"t{i}"), UNet(**KW),
                    build_transform(TCFG), device="cpu", tensorboard=False,
                    **kw)
        j = JaxTrainer(str(tmp_path / f"j{i}"), JaxUNet(**KW),
                       jax_transform(TCFG), tensorboard=False, **kw)
        try:
            want = j._resolve_device_cache(theirs)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:30]):
                t._resolve_device_cache(ours)
            continue
        assert t._resolve_device_cache(ours) == want, kw
        assert t._cache_nbytes(ours, resident=False) \
            == j._cache_nbytes(theirs, resident=False)


def test_upload_of_a_row_range(caches, tmp_path):
    root, train, _, _ = caches
    other = make_synthetic_cache(str(root / "other"), 5, P, TCFG, seed=3)
    ds = CachedPatchDataset([train, other])
    t = Trainer(str(tmp_path / "u"), UNet(**KW), build_transform(TCFG),
                device="cpu", tensorboard=False, fg_weight=5.0)
    t._UPLOAD_CHUNK_BYTES = 3 * ds._raw[0][0].nbytes  # several chunks
    raw, teacher, fg = t._upload_cache(ds, 10, 15)
    whole = [np.concatenate(p)[10:15] for p in (ds._raw, ds._teacher,
                                                 ds._fg)]
    np.testing.assert_array_equal(raw.numpy().view(np.uint16), whole[0])
    np.testing.assert_array_equal(teacher.numpy().view(np.uint16), whole[1])
    from exaspim_tpu_torch.train.state import pack_fg_bits

    np.testing.assert_array_equal(fg.numpy(), pack_fg_bits(whole[2]))
    ev = _events(t)[-1]
    assert ev["rows"] == [10, 15] and ev["fg"] == "packed"
