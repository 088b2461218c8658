"""The port's loader against the JAX package's: host collates and worker
processes.

* ``make_train_collate`` / ``make_val_collate`` apply the frozen transform
  on the host: within 1e-6 of the JAX package's (both f32; the transforms
  agree to f32 rounding), masks and counts equal.
* ``DataLoader(num_workers=2)`` gives the stream of ``num_workers=0`` (the
  producer thread) and of the JAX package's loader with two workers,
  batch for batch, shuffled or not, with and without ``drop_last``;
  a worker's exception reaches the consumer; ``close`` stops the workers.
* Batches come back through shared slots sized by the first batch: a
  later batch too large for its slot (it comes back pickled), values that
  are no arrays, and a stream stopped early and started again all give
  the thread stream. A host collate (its transform runs torch ops) runs
  in the workers, after the parent has used torch's thread pool, within
  1e-6 of the thread stream (the same f32 ops, chunked otherwise over
  threads: a vector and a scalar asinh may differ by an ulp); run in a
  subprocess with a time limit, so that a hang fails the test.
* The rule for datasets whose items run torch ops (a BM4D teacher, on the
  card or the CPU): ``num_workers > 0`` raises ``ValueError``. A forked
  worker cannot use CUDA, nor the OpenMP pool torch started in the parent:
  in a child forked after the parent ran a parallel CPU op, the teacher's
  ``F.pad`` waited forever. Numpy-only items (phantoms with their Gaussian
  teacher) run in workers.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest

from exaspim_tpu.data import loader as jld
from exaspim_tpu.data.cache import CachedPatchDataset as JCached
from exaspim_tpu.data.cache import CachedValidateDataset as JVal
from exaspim_tpu.data.synthetic import make_synthetic_cache
from exaspim_tpu.transforms import build_transform as jax_transform
from exaspim_tpu_torch.data import loader as tld
from exaspim_tpu_torch.data.cache import (
    CachedPatchDataset,
    CachedValidateDataset,
)
from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset
from exaspim_tpu_torch.transforms import build_transform

TCFG = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    root = tmp_path_factory.mktemp("workers")
    return make_synthetic_cache(str(root / "c"), 10, (12, 12, 12), TCFG,
                                seed=4)


def _same_batches(a, b, atol=0.0):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.shape == v.shape and u.dtype == v.dtype
            if atol:
                np.testing.assert_allclose(u, v, rtol=0, atol=atol)
            else:
                np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("preserve", [False, True])
def test_host_collates_match_jax(cache, preserve):
    ds, jds = CachedValidateDataset(cache), JVal(cache)
    items = [ds[i] for i in range(5)]
    ours = tld.make_train_collate(build_transform(TCFG), preserve)(
        [it[:2] + it[3:] for it in items])
    theirs = jld.make_train_collate(jax_transform(TCFG), preserve)(
        [it[:2] + it[3:] for it in (jds[i] for i in range(5))])
    _same_batches([ours], [theirs], atol=1e-6)
    assert ours[0].shape == (5, 12, 12, 12, 1) and ours[0].dtype == np.float32
    ours = tld.make_val_collate(build_transform(TCFG))(items)
    theirs = jld.make_val_collate(jax_transform(TCFG))(
        [jds[i] for i in range(5)])
    _same_batches([ours], [theirs], atol=1e-6)
    np.testing.assert_array_equal(ours[2], np.stack([it[0] for it in items]))


@pytest.mark.parametrize("shuffle,drop_last", [(True, False), (True, True),
                                               (False, False)])
def test_worker_stream_equals_thread_stream_and_jax(cache, shuffle,
                                                    drop_last):
    ds = CachedPatchDataset(cache)
    kw = dict(shuffle=shuffle, seed=3, drop_last=drop_last)
    collate = tld.make_count_train_collate()
    thread = tld.DataLoader(ds, 3, collate, **kw)
    workers = tld.DataLoader(ds, 3, collate, num_workers=2, prefetch=1, **kw)
    jax_workers = jld.DataLoader(JCached(cache), 3,
                                 jld.make_count_train_collate(),
                                 num_workers=2, **kw)
    try:
        for epoch in (0, 1):
            for ld in (thread, workers, jax_workers):
                ld.set_epoch(epoch)
            got = list(workers)
            assert len(got) == len(workers) == (3 if drop_last else 4)
            _same_batches(got, list(thread))
            _same_batches(got, list(jax_workers))
    finally:
        workers.close()
        jax_workers.close()
    assert workers._pool is None


class _Broken:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise KeyError("item 2")
        return np.zeros(2), np.zeros(2), np.zeros(2, bool)


def test_worker_exception_reaches_the_consumer():
    ld = tld.DataLoader(_Broken(), 1, tld.make_count_train_collate(),
                        num_workers=2)
    try:
        with pytest.raises(KeyError, match="item 2"):
            list(ld)
    finally:
        ld.close()


def test_torch_op_items_refuse_worker_processes():
    from exaspim_tpu_torch.data.live import TrainDataset

    for ds in (TrainDataset(), TrainDataset(device="cpu"),
               SyntheticPatchDataset(n=4, use_bm4d_teacher=True),
               SyntheticPatchDataset(n=4, use_bm4d_teacher=True,
                                     device="cpu")):
        assert ds.items_run_torch
        with pytest.raises(ValueError, match="torch ops"):
            tld.DataLoader(ds, 2, tld.make_count_train_collate(),
                           num_workers=1)
        tld.DataLoader(ds, 2, tld.make_count_train_collate())  # thread: ok
    host = SyntheticPatchDataset(n=4, patch_shape=(8, 8, 8))
    assert not host.items_run_torch
    ld = tld.DataLoader(host, 2, tld.make_count_train_collate(),
                        num_workers=2)
    try:
        got = list(ld)
    finally:
        ld.close()
    _same_batches(got, list(tld.DataLoader(host, 2,
                                           tld.make_count_train_collate())))


class _Growing:
    """Item i: i + 1 values, so later batches outgrow the first one's
    slot."""

    def __len__(self):
        return 9

    def __getitem__(self, i):
        return np.arange(i + 1, dtype=np.float32) + i


def _concat(items):
    return np.concatenate(items), len(items), [float(it[0]) for it in items]


def test_worker_slots_fallback_and_early_stop():
    want = list(tld.DataLoader(_Growing(), 2, _concat))
    ld = tld.DataLoader(_Growing(), 2, _concat, num_workers=2, prefetch=1)
    try:
        for _ in range(2):
            got = list(ld)
            assert len(got) == len(want) == 5
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1:] == b[1:]
            it = iter(ld)  # stopped early: its slots are drained first
            next(it), next(it)
            it.close()
        assert ld._slot_bytes == 64  # the first batch's 3 values, aligned
    finally:
        ld.close()
    assert ld._pool is None and ld._slots is None


_HOST_COLLATE = textwrap.dedent("""
    import numpy as np
    import torch

    from exaspim_tpu_torch.data import loader as tld
    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset
    from exaspim_tpu_torch.transforms import build_transform

    torch.asinh(torch.rand(64, 64, 64, 8))  # the parent's thread pool is up
    ds = SyntheticPatchDataset(n=8, patch_shape=(8, 8, 8))
    collate = tld.make_train_collate(build_transform(
        {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}))
    want = list(tld.DataLoader(ds, 3, collate, shuffle=True, seed=1))
    ld = tld.DataLoader(ds, 3, collate, shuffle=True, seed=1, num_workers=2)
    try:
        for epoch in (0, 1):
            got = list(ld)
            assert len(got) == len(want) == 3
            for a, b in zip(got, want):
                for u, v in zip(a, b):
                    assert u.shape == v.shape and u.dtype == v.dtype
                    np.testing.assert_allclose(u, v, rtol=0, atol=1e-6)
    finally:
        ld.close()
    print("ok")
""")


def test_host_collate_runs_in_workers():
    out = subprocess.run([sys.executable, "-c", _HOST_COLLATE],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
