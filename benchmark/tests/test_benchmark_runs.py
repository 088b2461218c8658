"""Whole runs of the harness on the CPU at a tiny size (the program's plain
versions of its kernels, in a copy of the benchmark whose traffic files
are shrunk): each cell comes out correct, a cell and a metric added as
files only are run and read, and with the timed path broken underneath
``correct`` comes out false, once for each fault a cell can have."""

from __future__ import annotations

import importlib
import io
import json
import os
import shutil
import time

import pytest
import torch

from benchmark import harness

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)

TINY = {
    "denoise": lambda t: (
        t["inputs"].update(shape=[64, 64, 64], block=[32, 32, 32], count=2,
                           tubes=3),
        t["denoise"].update(slab_z=32, patch_size=32, batch_size=2),
        t.update(warmup_units=1), t["check"].update(reference_batch=2)),
    "trainer": lambda t: (
        t["inputs"].update(patch=16, count=32, volumes=2, block=[32] * 3,
                           tubes=3),
        t.update(batch_size=4, warmup_units=4)),
    "teacher": lambda t: (
        t["inputs"].update(patch=16, count=16, volumes=1, block=[32] * 3,
                           tubes=3),
        t.update(warmup_units=1)),
}


def tiny_copy(dst):
    """The benchmark and BENCHMARK.json copied under ``dst`` with every
    traffic file shrunk; the checkpoint linked. Returns the copy's
    benchmark directory."""
    bench_dir = os.path.join(dst, "benchmark")
    shutil.copytree(BENCH, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    os.makedirs(os.path.join(dst, "checkpoints"))
    os.symlink(os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack"),
               os.path.join(dst, "checkpoints", "bm4dnet.msgpack"))
    tdir = os.path.join(bench_dir, "traffic")
    for f in os.listdir(tdir):
        path = os.path.join(tdir, f)
        with open(path) as fh:
            t = json.load(fh)
        TINY[t["entry"]](t)
        with open(path, "w") as fh:
            json.dump(t, fh)
    return bench_dir


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench")))


def run(bench_dir, workload, seed=2 ** 31 + 11, trace=False):
    torch.manual_seed(0)
    return harness.run_cell(workload, seed, 1.0, trace, device="cpu",
                            bench_dir=bench_dir, t_process=time.perf_counter(),
                            out=io.StringIO(), err=io.StringIO())


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("workload", cells())
def test_cell_runs_correct_on_the_cpu(tiny, workload):
    res = run(tiny, workload)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    assert "setup_s" in res["metrics"]
    assert list(res)[-1] == "checks"


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    bench_dir = tiny_copy(str(tmp_path))
    with open(os.path.join(bench_dir, "traffic", "denoise-512.json")) as f:
        t = json.load(f)
    t["denoise"]["slab_z"] = 64  # one slab, no halos
    with open(os.path.join(bench_dir, "traffic", "denoise-one.json"),
              "w") as f:
        json.dump(t, f)
    shutil.copy(os.path.join(bench_dir, "limits",
                             "bm4dnet-w1.denoise-512.json"),
                os.path.join(bench_dir, "limits",
                             "bm4dnet-w1.denoise-one.json"))
    with open(os.path.join(bench_dir, "metrics", "units_done.py"), "w") as f:
        f.write("def read(run):\n    return len(run.units)\n")
    path = os.path.join(tmp_path, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["workloads"].append({"name": "bm4dnet-w1.denoise-one",
                           "config": "bm4dnet-w1", "traffic": "denoise-one",
                           "chips": 1, "why": "one slab"})
    for m in b["end_to_end"]:
        if m["name"] == "denoise_mvox_s":
            m["workloads"].append("bm4dnet-w1.denoise-one")
    b["end_to_end"].append({"name": "units_done", "unit": "units",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["bm4dnet-w1.denoise-one"]})
    with open(path, "w") as f:
        json.dump(b, f)
    res = run(bench_dir, "bm4dnet-w1.denoise-one")
    assert res["correct"]
    assert res["metrics"]["units_done"]["value"] == res["attempted"]
    assert "denoise_mvox_s" in res["metrics"]


# ---- faults planted under the timed path


def _frozen_steps(monkeypatch):
    """A step that returns its state unchanged: the update runs, then the
    parameters are put back."""
    from exaspim_tpu_torch.train.state import TrainState

    orig = TrainState.apply_gradients

    def frozen(self):
        saved = [p.detach().clone() for p in self.model.parameters()]
        orig(self)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", frozen)


def _half_batch_trainer(monkeypatch):
    """Half of each batch left out, the mean taken over the rest."""
    from exaspim_tpu_torch.train import trainer

    make = trainer.make_train_step

    def halved(*a, **k):
        step = make(*a, **k)

        def run_half(state, x, y, fg):
            h = x.shape[0] // 2
            return step(state, x[:h], y[:h], fg[:h])
        return run_half

    monkeypatch.setattr(trainer, "make_train_step", halved)


def _half_batch_denoise(monkeypatch):
    """Half of each batch of patches left out of the stitch."""
    from exaspim_tpu_torch import inference

    orig = inference._patch_batches

    def halved(*a, **k):
        for sb, pred, mask in orig(*a, **k):
            h = (len(sb) + 1) // 2
            pred, mask = pred.clone(), mask.clone()
            pred[h:] = 0
            mask[h:] = 0
            yield sb, pred, mask

    monkeypatch.setattr(inference, "_patch_batches", halved)


def _altered_answer(monkeypatch):
    """An answer altered where it is produced: one 8³ cube of a volume's
    output off by 1,000 counts (the check's limits pass errors up to 220
    counts at a voxel: bf16 alone reads up to 56)."""
    from exaspim_tpu_torch import pipeline

    orig = pipeline.predict

    def altered(*a, **k):
        out = orig(*a, **k)
        out[8:16, 8:16, 8:16] += 1000
        return out

    monkeypatch.setattr(pipeline, "predict", altered)


def _half_batch_teacher(monkeypatch):
    """Half of each batch of patches left out of BM4D, handed back as
    they came."""
    bm4d = importlib.import_module("exaspim_tpu_torch.ops.bm4d")
    orig = bm4d.bm4d_batch

    def halved(vols, *a, **k):
        out = orig(vols, *a, **k)
        h = (len(vols) + 1) // 2
        out[h:] = torch.as_tensor(vols[h:], device=out.device)
        return out

    monkeypatch.setattr(bm4d, "bm4d_batch", halved)


def _altered_teacher(monkeypatch):
    """Stage 2's estimate altered where it is produced: one 4³ cube off by
    100 counts."""
    bm4d = importlib.import_module("exaspim_tpu_torch.ops.bm4d")
    orig = bm4d._stage

    def altered(noisy, guide, sigma, B, K, step, W, mode, *a, **k):
        out = orig(noisy, guide, sigma, B, K, step, W, mode, *a, **k)
        if mode == "wiener":
            out[:, 4:8, 4:8, 4:8] += 100.0
        return out

    monkeypatch.setattr(bm4d, "_stage", altered)


FAULTS = {
    "bm4dnet-w1.denoise-512": [_half_batch_denoise, _altered_answer],
    "bm4dnet-w1.train-stream": [_frozen_steps, _half_batch_trainer],
    "bm4dnet-w1.teachers": [_half_batch_teacher, _altered_teacher],
}


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w, fs in FAULTS.items() for f in fs],
    ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_fault_under_the_timed_path_is_not_correct(tiny, workload, fault,
                                                     monkeypatch):
    fault(monkeypatch)
    res = run(tiny, workload)
    assert not res["correct"], res["checks"]
