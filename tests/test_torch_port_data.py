"""The port's data pipeline against exaspim_tpu.data: synthetic items
and caches bit for bit, the cache contract read both ways, and the
loader's batch order and collates equal."""

import os

import numpy as np
import pytest
import torch

from exaspim_tpu.data import cache as jc
from exaspim_tpu.data import loader as jld
from exaspim_tpu.data import synthetic as jsyn
from exaspim_tpu_torch.data import cache as tc
from exaspim_tpu_torch.data import loader as tld
from exaspim_tpu_torch.data import synthetic as tsyn

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


@pytest.mark.parametrize("family", ["a", "b", "mix"])
def test_synthetic_items_equal_jax(family):
    kw = dict(n=3, patch_shape=(12, 14, 16), seed=5, family=family)
    got, want = tsyn.SyntheticPatchDataset(**kw), \
        jsyn.SyntheticPatchDataset(**kw)
    assert len(got) == len(want) == 3
    for i in (0, 1, -1):
        for a, b in zip(got[i], want[i]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_bm4d_teacher_dataset():
    """``use_bm4d_teacher=True``: raw and fg equal the JAX dataset's, the
    teacher is the port's BM4D. Against the JAX teacher (f32 XLA matcher
    on the CPU, so other members among near-ties): RMSE ≤ 0.2·σ."""
    kw = dict(n=2, patch_shape=(16, 16, 16), seed=5, sigma_bm4d=16.0,
              use_bm4d_teacher=True)
    got = tsyn.SyntheticPatchDataset(device="cpu", **kw)[1]
    want = jsyn.SyntheticPatchDataset(**kw)[1]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    assert got[1].dtype == np.uint16 and got[1].shape == (16, 16, 16)
    gap = np.sqrt(np.mean((got[1].astype(np.float64) - want[1]) ** 2))
    assert gap <= 0.2 * 16.0, gap
    gauss = tsyn.SyntheticPatchDataset(device="cpu", **{
        **kw, "use_bm4d_teacher": False})[1][1]
    assert not np.array_equal(gauss, got[1])


def test_caches_swap_both_ways(tmp_path):
    ours = tsyn.make_synthetic_cache(str(tmp_path / "t"), 4, (8, 8, 8),
                                     TCFG, seed=3)
    theirs = jsyn.make_synthetic_cache(str(tmp_path / "j"), 4, (8, 8, 8),
                                       TCFG, seed=3)
    for name in ("raw.npy", "teacher.npy", "fg.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(ours, name)),
                                      np.load(os.path.join(theirs, name)))
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 65535, (5, 8, 8, 8), dtype=np.uint16)
    teacher = rng.integers(0, 65535, raw.shape, dtype=np.uint16)
    fg = rng.random(raw.shape) < 0.5
    jc.write_cache(str(tmp_path / "w"), raw, teacher, fg, TCFG,
                   config={"n": 5})
    dirs = [str(tmp_path / "w"), theirs]
    assert tc.load_cache_transform(dirs) == jc.load_cache_transform(dirs)
    got, want = tc.CachedValidateDataset(dirs), jc.CachedValidateDataset(dirs)
    assert len(got) == len(want) == 9 and got.patch_shape == (8, 8, 8)
    for i in (0, 4, 5, 8, -1):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(FileNotFoundError):
        tc.CachedPatchDataset(str(tmp_path / "missing"))


def test_loader_batches_equal_jax():
    ds = tsyn.SyntheticPatchDataset(n=7, patch_shape=(4, 4, 4), seed=1)
    for shuffle, drop_last in ((True, False), (False, True)):
        mk = dict(shuffle=shuffle, seed=9, drop_last=drop_last)
        got = tld.DataLoader(ds, 3, tld.make_count_train_collate(True), **mk)
        want = jld.DataLoader(ds, 3, jld.make_count_train_collate(True), **mk)
        assert len(got) == len(want)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            gb, wb = list(got), list(want)
            assert len(gb) == len(wb)
            for a, b in zip(gb, wb):
                for u, v in zip(a, b):
                    np.testing.assert_array_equal(u, v)
    items = [(np.full((2, 2, 2), i, np.uint16),) * 3
             + (np.ones((2, 2, 2), bool),) for i in range(2)]
    for a, b in zip(tld.make_count_val_collate()(items),
                    jld.make_count_val_collate()(items)):
        np.testing.assert_array_equal(a, b)


def test_uint16_travels_as_int16_bits():
    a = np.array([[0, 1, 32767, 32768, 65535]], np.uint16)
    t = tld.to_tensor(a, "cpu")
    assert t.dtype == torch.int16
    np.testing.assert_array_equal(tld.counts_f32(t).numpy(),
                                  a.astype(np.float32))
    batches = list(tld.prefetch_to_device(iter([(a, a[0])] * 3), 2, "cpu"))
    assert len(batches) == 3
    np.testing.assert_array_equal(tld.counts_f32(batches[2][1]).numpy(),
                                  a[0].astype(np.float32))
