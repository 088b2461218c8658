"""The control of every cell on the card, at a size a test run holds: the
plain reference in the precision below the configuration's, put in the
program's place, must come out not correct on three seeds, while the
program's own runs at that size come out correct.

    python3 -m pytest -q -m gpu benchmark/tests/test_benchmark_card.py
"""

from __future__ import annotations

import io
import json
import os
import time

import pytest
import torch

from benchmark import harness
from benchmark.tests.test_benchmark_runs import ROOT, tiny_copy

SMALL = {
    "denoise": lambda t: (
        t["inputs"].update(shape=[256, 256, 256], block=[128] * 3, count=2),
        t["denoise"].update(slab_z=128), t.update(warmup_units=1)),
    "trainer": lambda t: (
        t["inputs"].update(count=128, volumes=2, block=[128] * 3),
        t.update(batch_size=8, warmup_units=4)),
    "teacher": lambda t: (
        t["inputs"].update(count=64, volumes=1, block=[128] * 3),
        t.update(warmup_units=1)),
}


@pytest.fixture(scope="module")
def card_copy(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    bench_dir = tiny_copy(str(tmp_path_factory.mktemp("card")))
    # tiny_copy shrank the traffic for the CPU; on the card take the
    # cell's own files again at SMALL's sizes.
    tdir = os.path.join(bench_dir, "traffic")
    for f in os.listdir(tdir):
        with open(os.path.join(ROOT, "benchmark", "traffic", f)) as fh:
            t = json.load(fh)
        SMALL[t["entry"]](t)
        with open(os.path.join(tdir, f), "w") as fh:
            json.dump(t, fh)
    return bench_dir


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_and_program_passes_on_the_card(card_copy, workload):
    def run(seed, control):
        return harness.run_cell(workload, seed, 2.0, False, device="cuda",
                                bench_dir=card_copy,
                                t_process=time.perf_counter(),
                                control=control, out=io.StringIO(),
                                err=io.StringIO())

    bench = harness.load_json(os.path.join(card_copy, "..", "BENCHMARK.json"))
    _, _, traffic, _ = harness.cell_files(card_copy, bench, workload)
    control = harness.entry_module(card_copy, traffic).CONTROL
    assert run(2 ** 31 + 3, None)["correct"]
    for seed in (101, 202, 2 ** 31 + 303):
        assert not run(seed, control)["correct"], seed
