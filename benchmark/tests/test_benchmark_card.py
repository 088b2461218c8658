"""The control of every cell on the card, at a size a test run holds: the
plain reference in the precision below the configuration's, put in the
program's place, must come out not correct on three seeds, while the
program's own runs at that size come out correct. A cell on several cards
runs one process a card (``launch.py``) and skips where the host has
fewer cards.

    python3 -m pytest -q -m gpu benchmark/tests/test_benchmark_card.py
"""

from __future__ import annotations

import io
import json
import os
import sys
import time

import pytest
import torch

from benchmark import harness, launch
from benchmark.tests.test_benchmark_runs import ROOT, tiny_copy

HERE = os.path.dirname(os.path.abspath(__file__))


@pytest.fixture(scope="module")
def card_copy(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control is read on the card")
    # Each traffic file at its own ``small`` block's sizes.
    return tiny_copy(str(tmp_path_factory.mktemp("card")), block="small")


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("workload", _cells())
def test_control_fails_and_program_passes_on_the_card(card_copy, workload):
    bench = harness.load_json(os.path.join(card_copy, "..", "BENCHMARK.json"))
    cell, _, traffic, _ = harness.cell_files(card_copy, bench, workload)
    control = harness.entry_module(card_copy, traffic).CONTROL
    chips = cell["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA devices")

    def run(seed, control):
        if chips == 1:
            return harness.run_cell(workload, seed, 2.0, False,
                                    device="cuda", bench_dir=card_copy,
                                    t_process=time.perf_counter(),
                                    control=control, out=io.StringIO(),
                                    err=io.StringIO())
        out = io.StringIO()
        code = launch.launch(
            [sys.executable, os.path.join(HERE, "rank_child.py"),
             "--bench-dir", card_copy, "--workload", workload, "--device",
             "cuda", "--seconds", "2", "--seeds", str(seed)]
            + (["--control", control] if control else []), chips, out=out)
        assert code == 0
        (line,) = [x for x in out.getvalue().splitlines()
                   if x.startswith("{")]
        return json.loads(line)

    assert run(2 ** 31 + 3, None)["correct"]
    for seed in (101, 202, 2 ** 31 + 303):
        assert not run(seed, control)["correct"], seed
