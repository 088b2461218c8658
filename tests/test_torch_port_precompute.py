"""The port's cache builder against scripts/precompute.py (loaded by
path), on the same seeds, and the caches read both ways.

Raw patches, foreground masks, ``transform.json`` and the keys and values
of ``config.json`` are equal. The teachers come from different matchers
(the port's bf16-table matcher in its plain version, the script's f32
XLA matcher on the CPU), which pick different but equally good group
members among near-ties: RMSE of the difference ≤ 0.2·σ, and both
teachers closer to each other than to the raw patches.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from exaspim_tpu.data import cache as jc
from exaspim_tpu_torch.data import cache as tc
from exaspim_tpu_torch.data import precompute as tp
from exaspim_tpu_torch.data import synthetic as tsyn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMA = 24.0


def _script():
    spec = importlib.util.spec_from_file_location(
        "precompute_script", os.path.join(ROOT, "scripts", "precompute.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
    root = tmp_path_factory.mktemp("caches")
    kw = dict(split="val", source="synthetic", n=3, patch=(16, 16, 16),
              sigma_bm4d=SIGMA, seed=7)
    ours = tp.precompute(str(root / "torch"), device="cpu", **kw)
    theirs = _script().precompute(str(root / "jax"), **kw)
    return ours, theirs


def test_cache_equals_the_scripts(caches):
    ours, theirs = caches
    for name in ("raw.npy", "fg.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(ours, name)),
                                      np.load(os.path.join(theirs, name)))
    for name in ("transform.json", "config.json"):
        with open(os.path.join(ours, name)) as f, \
                open(os.path.join(theirs, name)) as g:
            assert json.load(f) == json.load(g)
    raw = np.load(os.path.join(ours, "raw.npy")).astype(np.float64)
    a = np.load(os.path.join(ours, "teacher.npy"))
    b = np.load(os.path.join(theirs, "teacher.npy"))
    assert a.dtype == b.dtype == np.uint16 and a.shape == b.shape
    gap = np.sqrt(np.mean((a.astype(np.float64) - b) ** 2))
    assert gap <= 0.2 * SIGMA, gap
    assert gap < 0.5 * np.sqrt(np.mean((a - raw) ** 2))
    # The seed stream of the split: patch i is item i of seed + stream.
    ds = tsyn.SyntheticPatchDataset(n=3, patch_shape=(16, 16, 16),
                                    seed=7 + tp.SEED_STREAMS["val"])
    np.testing.assert_array_equal(raw[2], ds.raw_and_fg(2)[0])


def test_caches_open_in_both_packages(caches):
    ours, theirs = caches
    for reader in (tc, jc):
        both = reader.CachedValidateDataset([ours, theirs])
        assert len(both) == 6 and both.patch_shape == (16, 16, 16)
        assert reader.load_cache_transform([ours, theirs]) == \
            tp.DEFAULT_TRANSFORM
        raw, teacher, raw2, fg = both[1]
        assert raw.dtype == teacher.dtype == np.uint16 and fg.dtype == bool
        np.testing.assert_array_equal(raw, both[4][0])
    for i in range(3):
        for a, b in zip(tc.CachedPatchDataset(ours)[i],
                        jc.CachedPatchDataset(ours)[i]):
            np.testing.assert_array_equal(a, b)


def test_module_constants_and_refusals(tmp_path):
    script = _script()
    assert tp.SEED_STREAMS == script.SEED_STREAMS
    assert tp.DEFAULT_TRANSFORM == script.DEFAULT_TRANSFORM
    with pytest.raises(ValueError, match="frozen"):
        tp.precompute(str(tmp_path / "c"), transform_cfg={
            "kind": "asinh", "params": {"scale": 60.0},
            "calibrate": {"n": 4}}, device="cpu")
    # The live source needs its brain-spec JSON; refused before any file
    # is written.
    with pytest.raises(ValueError, match="brain-spec"):
        tp.precompute(str(tmp_path / "l"), source="live", device="cpu")
    assert not os.path.exists(tmp_path / "l")
    import inspect

    assert inspect.signature(tp.precompute).parameters["device"].default \
        == "cuda"


def test_main_writes_a_cache(tmp_path, capsys):
    out = str(tmp_path / "m")
    tp.main(["--split", "train", "--out", out, "--n", "2", "--patch", "13",
             "16", "10", "--sigma-bm4d", "10", "--bm4d-step", "4",
             "--family", "mix", "--seed", "3", "--device", "cpu"])
    assert "cache complete" in capsys.readouterr().out
    ds = tc.CachedPatchDataset(out)
    assert len(ds) == 2 and ds.patch_shape == (13, 16, 10)
    with open(os.path.join(out, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["bm4d_step"] == 4 and cfg["family"] == "mix" and \
        cfg["seed_stream"] == 0 and cfg["sigma_bm4d"] == 10.0
    raw, teacher, _ = ds[1]
    assert teacher.any() and not np.array_equal(raw, teacher)
