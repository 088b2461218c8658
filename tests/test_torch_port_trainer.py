"""The port's Trainer end to end against exaspim_tpu.train.Trainer.

Tiny caches (8 train + 4 val 16³ patches, written by the JAX package),
a width-0.25 UNet in f32 on the CPU, both trainers warm-started from the
same checkpoint, batch 4, 2 epochs (4 steps), validation every 2 steps
with exact cratios of the first 2 examples. Compared: the logged loss,
every validation metric and the score (1e-3 relative: after four AdamW
steps the params differ at f32 rounding, amplified where a gradient is
near zero and Adam's step is ≈ lr·sign(g)), the exact cratio (±0.02, a
ratio rounded to 2 decimals of predictions that may differ by a count),
and the score-named checkpoints. The streaming loader path must give the
same losses as the card-resident-cache path (same permutation).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.models import UNet as JaxUNet
from exaspim_tpu.train import Trainer as JaxTrainer
from exaspim_tpu.train.checkpoint import save_checkpoint as jax_save
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data.cache import CachedPatchDataset, \
    CachedValidateDataset
from exaspim_tpu_torch.models import UNet
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}
KW = dict(width_multiplier=0.25, head_init="normal")
WEIGHTS = {"fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5,
           "cratio": 10.0}
RUN = dict(epochs=2, batch_size=4, val_every=2, exact_cratio_examples=2,
           checkpoint_weights=WEIGHTS, seed=42)


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    train = make_synthetic_cache(str(root / "train"), 8, (16, 16, 16), TCFG,
                                 seed=1)
    val = make_synthetic_cache(str(root / "val"), 4, (16, 16, 16), TCFG,
                               seed=2)
    jm = JaxUNet(**KW)
    params = jax.jit(jm.init)(jax.random.key(0),
                              jnp.zeros((1, 16, 16, 16, 1)))["params"]
    ckpt = jax_save(str(root / "init.ckpt"), params, jm.config, TCFG)
    return root, train, val, ckpt


def _events(trainer):
    with open(os.path.join(trainer.session_dir, "log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ckpts(trainer):
    return sorted(os.listdir(trainer.ckpt_dir))


def test_trainer_matches_jax(caches):
    root, train, val, ckpt = caches
    jt = JaxTrainer(str(root / "jax"), JaxUNet(**KW), jax_transform(TCFG),
                    tensorboard=False, keep_mips=0, **RUN)
    jt.load_pretrained_weights(ckpt)
    jt.run(JCached(train), JVal(val))
    tt = Trainer(str(root / "port"), UNet(**KW), build_transform(TCFG),
                 device="cpu", **RUN)
    tt.load_pretrained_weights(ckpt)
    tt.run(CachedPatchDataset(train), CachedValidateDataset(val))

    je, te = _events(jt), _events(tt)
    jtrain = [e for e in je if e["event"] == "train"]
    ttrain = [e for e in te if e["event"] == "train"]
    assert [e["step"] for e in ttrain] == [e["step"] for e in jtrain] == [4]
    np.testing.assert_allclose([e["loss"] for e in ttrain],
                               [e["loss"] for e in jtrain], rtol=1e-3)
    jval = [e for e in je if e["event"] == "val"]
    tval = [e for e in te if e["event"] == "val"]
    assert [e["step"] for e in tval] == [e["step"] for e in jval] == [2, 4]
    for a, b in zip(tval, jval):
        assert a.keys() == b.keys()
        for k in a:
            if k in ("event", "step"):
                continue
            tol = 0.02 if k == "val_cratio" else 1e-3 * abs(b[k])
            assert abs(a[k] - b[k]) <= tol, (k, a[k], b[k])
    pat = re.compile(r"BM4DNet-\d{8}-(\d+)-(-?[\d.]+)\.ckpt$")
    jc = [pat.match(n).groups() for n in _ckpts(jt) if pat.match(n)]
    tc = [pat.match(n).groups() for n in _ckpts(tt)]
    assert [s for s, _ in tc] == [s for s, _ in jc] == ["2", "4"]
    for (_, a), (_, b) in zip(tc, jc):
        assert abs(float(a) - float(b)) <= 1e-3 * abs(float(b))
    with open(os.path.join(tt.session_dir, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["device_cache"] is True and cfg["total_steps"] == 4


def test_streaming_loader_path_equals_cached_path(caches):
    root, train, val, ckpt = caches
    losses = []
    for mode in (True, False):
        t = Trainer(str(root / f"mode-{mode}"), UNet(**KW),
                    build_transform(TCFG), device="cpu", device_cache=mode,
                    log_every=1, **{**RUN, "exact_cratio_examples": 0})
        t.load_pretrained_weights(ckpt)
        t.run(CachedPatchDataset(train), CachedValidateDataset(val))
        ev = _events(t)
        losses.append([e["loss"] for e in ev if e["event"] == "train"])
        assert [e["val_cratio"] for e in ev if e["event"] == "val"] == [0, 0]
    assert len(losses[0]) == 4
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-6)
