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

def merged(base, over):
    """``base`` with ``over``'s keys put in, nested dicts key by key."""
    out = dict(base)
    for k, v in over.items():
        out[k] = merged(base[k], v) if isinstance(v, dict) \
            and isinstance(base.get(k), dict) else v
    return out


def tiny_copy(dst, block="tiny", bench=BENCH, root=ROOT):
    """The benchmark and BENCHMARK.json copied under ``dst`` with every
    traffic file shrunk by its own ``block`` of overrides (``tiny`` for
    the CPU, ``small`` for the card tests), and every file a
    configuration names under ``weights`` linked. Returns the copy's
    benchmark directory."""
    bench_dir = os.path.join(dst, "benchmark")
    shutil.copytree(bench, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), dst)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        configs = json.load(f)["configs"]
    for c in configs:
        with open(os.path.join(root, c["file"])) as f:
            w = json.load(f)["weights"]
        if isinstance(w, str) and not os.path.exists(os.path.join(dst, w)):
            os.makedirs(os.path.dirname(os.path.join(dst, w)), exist_ok=True)
            os.symlink(os.path.join(root, w), os.path.join(dst, w))
    tdir = os.path.join(bench_dir, "traffic")
    for f in os.listdir(tdir):
        path = os.path.join(tdir, f)
        with open(path) as fh:
            t = json.load(fh)
        with open(path, "w") as fh:
            json.dump(merged(t, t[block]), fh)
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

    orig = pipeline._predict  # the pipeline's call of each slab

    def altered(*a, **k):
        out = orig(*a, **k)
        out[8:16, 8:16, 8:16] += 1000
        return out

    monkeypatch.setattr(pipeline, "_predict", altered)


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


# ---- a model of another architecture, added as files only

TINY_ARCH_REFERENCE = '''"""The plain reference of TinyRes: x + W2 * relu(W1 * x + b1) + b2."""

import torch
import torch.nn.functional as F

from benchmark.reference import unet

MODELS = ("TinyRes",)


def _conv(p, name, x, quant):
    w = p[f"{name}/kernel"]
    w = w.reshape(3, 3, 3, *w.shape[1:]).permute(4, 3, 0, 1, 2)
    b = p[f"{name}/bias"]
    if quant is unet.Bf16:
        return F.conv3d(x, w.to(x.dtype), b.to(x.dtype), padding=1)
    if quant is None:
        return F.conv3d(x, w, b, padding=1)
    return quant.output(F.conv3d(quant.input(x), quant.input(w), b,
                                 padding=1))


def forward(p, x, model_cfg, quant=None):
    h = x.to(torch.bfloat16) if quant is unet.Bf16 else x
    h = F.relu(_conv(p, "Conv_0", h, quant))
    return x + _conv(p, "Conv_1", h, quant).float()
'''

TINY_ARCH_COUNTS = '''def conv_shapes(n, model_config):
    c = model_config["channels"]
    return [("fwd", n, (1,), c), ("fwd", n, (c,), 1), ("dx", n, (1,), c)]
'''


def tiny_res_class():
    """A model of an architecture the benchmark has never seen, built from
    the port's ``Conv3`` as a model of the port would be."""
    from exaspim_tpu_torch.models.unet3d import Conv3

    class TinyRes(torch.nn.Module):
        def __init__(self, channels=8, dtype=torch.float32):
            super().__init__()
            self.config = {"model": "TinyRes", "channels": channels}
            self.dtype = dtype
            self.Conv_0 = Conv3(1, channels, dtype, bias=True)
            self.Conv_1 = Conv3(channels, 1, dtype, bias=True)

        def forward(self, x):
            y, _, _ = self.Conv_0(x.to(self.dtype))
            y, _, _ = self.Conv_1(torch.relu(y))
            return x + y.to(x.dtype)

    return TinyRes


def add_tiny_arch(tmp_path, traffic):
    """Files only: a configuration with weights from the seed, its
    reference, its counts, a traffic mix (a copy of ``traffic`` with its
    own ``tiny`` block) and the cell's limits, and the entries in
    BENCHMARK.json. Returns the copy's benchmark directory and the cell."""
    bench_dir = tiny_copy(str(tmp_path))
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "bm4dnet-w1.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tinyres-c8", source="a test model", reduced=[],
               weights={"init": "seed"},
               model_config={"model": "TinyRes", "channels": 8})
    for sub, name, text in (
            ("configs", "tinyres-c8.json", json.dumps(cfg)),
            ("reference", "tinyres.py", TINY_ARCH_REFERENCE),
            ("counts", "TinyRes.py", TINY_ARCH_COUNTS)):
        with open(os.path.join(bench_dir, sub, name), "w") as f:
            f.write(text)
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           f"{traffic}.json")) as f:
        t = json.load(f)
    with open(os.path.join(bench_dir, "traffic", "arch-mix.json"), "w") as f:
        json.dump(merged(t, t["tiny"]), f)
    cell = "tinyres-c8.arch-mix"
    shutil.copy(os.path.join(bench_dir, "limits", f"bm4dnet-w1.{traffic}.json"),
                os.path.join(bench_dir, "limits", f"{cell}.json"))
    path = os.path.join(tmp_path, "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    b["configs"].append({"name": "tinyres-c8", "source": "a test model",
                         "file": "benchmark/configs/tinyres-c8.json",
                         "reduced": [], "why": "files only"})
    b["workloads"].append({"name": cell, "config": "tinyres-c8",
                           "traffic": "arch-mix", "chips": 1,
                           "why": "files only"})
    with open(path, "w") as f:
        json.dump(b, f)
    return bench_dir, cell


@pytest.mark.parametrize("traffic,fault", [
    ("denoise-512", "_altered_answer"), ("train-stream", "_frozen_steps")])
def test_a_model_of_another_architecture_added_as_files(
        tmp_path, monkeypatch, traffic, fault):
    from exaspim_tpu_torch.models import MODEL_REGISTRY

    monkeypatch.setitem(MODEL_REGISTRY, "TinyRes", tiny_res_class())
    bench_dir, cell = add_tiny_arch(tmp_path, traffic)
    res = run(bench_dir, cell)
    assert res["correct"], res["checks"]
    assert "setup_s" in res["metrics"]
    globals()[fault](monkeypatch)
    assert not run(bench_dir, cell)["correct"]


@pytest.mark.parametrize("name", [
    "pipeline.forwarded_ratio", "kernel.conv_roofline.denoise",
    "mfu.denoise", "kernel.conv_roofline.train", "mfu.train"])
def test_a_reader_of_a_model_without_counts_reads_none(name):
    from types import SimpleNamespace

    traffic = {"entry": "denoise", "kernels": ["nb_conv3d", "nb_conv3d_dw"],
               "batch_size": 4, "inputs": {"patch": 16, "shape": [32] * 3},
               "denoise": {"slab_z": 32, "patch_size": 16, "overlap": 4,
                           "batch_size": 4}}
    trace = SimpleNamespace(device=[(0.0, 10.0, "nb_conv3d_kernel")],
                            host=[], busy_s=1e-5, window_s=1.0)
    r = SimpleNamespace(
        config={"model_config": {"model": "NoCountsNet"}}, traffic=traffic,
        units=[(32.0 ** 3, 0.5)], window_s=1.0, trace=trace, world=1,
        counters={"nb_conv3d.launches": 36, "nb_conv3d_dw.launches": 18},
        bench_dir=BENCH)
    reader = harness.load_module(harness.metric_reader(BENCH, name),
                                 f"bench_metric_{name}")
    assert reader.read(r) is None
    r.config = {"model_config": {"model": "UNet", "width_multiplier": 1.0}}
    assert reader.read(r) is not None
