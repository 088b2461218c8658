"""A cell on several processes, on the CPU: a four-card data-parallel
training cell added as files only (the ``train-dp4`` traffic and limits,
and its entry in BENCHMARK.json) runs through the launcher at a tiny size
at two gloo ranks, one process each, and prints one result line; with the
gradient exchange left out the check comes out not correct; with one
rank killed, or with JAX loaded on a rank other than 0, the launcher
ends the other and exits non-zero, with no result line, within its
timeout. And the ranks' agreement on the window's end, over a store, on
one host, and the collectives' readers on a hand-made trace."""

from __future__ import annotations

import io
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from benchmark import harness, launch
from benchmark.tests.test_benchmark_runs import tiny_copy

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
CELL = "bm4dnet-w1.train-dp4"


def add_cell(bench_dir, cell=CELL, chips=4):
    """The cell's entry in the copy's BENCHMARK.json, reporting
    ``train_mvox_s``: its traffic and limits files are there already."""
    path = os.path.join(bench_dir, "..", "BENCHMARK.json")
    with open(path) as f:
        b = json.load(f)
    config, traffic = cell.split(".", 1)
    b["workloads"].append({"name": cell, "config": config,
                           "traffic": traffic, "chips": chips,
                           "why": "files only"})
    for m in b["end_to_end"]:
        if m["name"] == "train_mvox_s":
            m["workloads"].append(cell)
    with open(path, "w") as f:
        json.dump(b, f)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    bench_dir = tiny_copy(str(tmp_path_factory.mktemp("bench-ranks")))
    add_cell(bench_dir)
    return bench_dir


def _launch(bench_dir, *extra, timeout_s=600.0):
    out = io.StringIO()
    t0 = time.monotonic()
    code = launch.launch(
        [sys.executable, os.path.join(HERE, "rank_child.py"), "--bench-dir",
         bench_dir, "--workload", CELL, "--device", "cpu", "--seeds",
         str(2 ** 31 + 17), *extra], 2, timeout_s=timeout_s, out=out)
    results = [json.loads(line) for line in out.getvalue().splitlines()
               if line.startswith("{")]
    return code, results, time.monotonic() - t0


def test_two_gloo_ranks_run_the_data_parallel_cell_correct(tiny):
    code, results, _ = _launch(tiny)
    assert code == 0
    assert len(results) == 1
    res = results[0]
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == 2
    assert res["attempted"] >= 1
    assert "train_mvox_s" in res["metrics"]


def test_the_exchange_left_out_is_not_correct(tiny):
    code, results, _ = _launch(tiny, "--fault", "no_exchange")
    assert code == 0
    assert len(results) == 1
    assert not results[0]["correct"], results[0]["checks"]


def test_a_killed_rank_ends_the_run_with_no_result(tiny):
    code, results, took = _launch(tiny, "--fault", "die", timeout_s=300.0)
    assert code != 0
    assert results == []
    assert took < 300.0


def test_jax_loaded_on_another_rank_gives_no_result(tiny):
    """Rank 0 loads nothing forbidden and prints its line; rank 1 finds
    JAX (a stand-in) once its window has closed and exits with 3, so the
    launcher drops rank 0's line and exits non-zero."""
    code, results, took = _launch(tiny, "--fault", "jax", timeout_s=300.0)
    assert code == 3
    assert results == []
    assert took < 300.0


def test_the_launcher_ends_a_hung_run_at_its_timeout():
    out = io.StringIO()
    t0 = time.monotonic()
    code = launch.launch([sys.executable, "-c",
                          "import time; print('{}'); time.sleep(600)"], 2,
                         timeout_s=3.0, out=out)
    assert code == 124
    assert out.getvalue() == ""
    assert time.monotonic() - t0 < 30.0


@pytest.mark.parametrize("deadline_unit", [1, 2, 5])
def test_ranks_stop_on_the_same_unit(deadline_unit):
    """Rank 0's clock passes the deadline after ``deadline_unit`` units;
    rank 1 runs ahead as far as the agreement lets it, and both end on
    the same unit, ``LAG`` past it."""
    port = launch.free_ports(1)[0]
    made = {}

    def make(rank):
        made[rank] = harness.Ranks(rank, 2, port, timeout_s=30)

    t = threading.Thread(target=make, args=(1,))
    t.start()
    make(0)
    t.join(timeout=30)
    last = {}

    def units(rank):
        ranks = made[rank]
        ranks.begin_run()
        n = 0
        while True:
            n += 1
            if ranks.over(n, rank == 0 and n >= deadline_unit):
                last[rank] = n
                return

    threads = [threading.Thread(target=units, args=(r,)) for r in (0, 1)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert last[0] == last[1] == deadline_unit + harness.Ranks.LAG


def _read(name, r):
    return harness.load_module(harness.metric_reader(BENCH, name),
                               f"bench_metric_{name}").read(r)


@pytest.mark.parametrize("name,ms", [
    # NCCL on [10, 30] and [60, 70] µs, two units: 30 µs / 2.
    ("comm.allreduce_ms.train_dp4", 30e-3 / 2),
    # A compute kernel overlaps [20, 25] and a copy [60, 70]; the copy
    # hides nothing: (15 + 10) µs / 2.
    ("comm.exposed_ms.train_dp4", 25e-3 / 2),
])
def test_the_collectives_readers_on_a_hand_made_trace(name, ms):
    device = [(0.0, 10.0, "nb_conv3d_kernel"),
              (10.0, 30.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
              (20.0, 25.0, "elementwise_kernel"),
              (60.0, 70.0, "ncclDevKernel_AllReduce_Sum_f32_RING_LL"),
              (60.0, 70.0, "Memcpy HtoD (Pinned -> Device)")]
    r = SimpleNamespace(trace=SimpleNamespace(device=device, host=[]),
                        units=[(1.0, 0.0)] * 2)
    assert _read(name, r) == pytest.approx(ms)
    one_card = SimpleNamespace(trace=SimpleNamespace(
        device=[d for d in device if "nccl" not in d[2]], host=[]),
        units=[(1.0, 0.0)] * 2)
    assert _read(name, one_card) is None


@pytest.mark.parametrize("family", ["mfu.train", "kernel.conv_roofline.train"])
def test_the_four_card_names_take_the_training_readers(family):
    """``<family>.dp4`` is read by ``<family>``'s reader, which counts a
    rank's share of the global batch and the peak of every card: four
    ranks at four times the batch read what one card does at one."""
    assert harness.metric_reader(BENCH, family + ".dp4") \
        == harness.metric_reader(BENCH, family)

    def run_at(world):
        return SimpleNamespace(
            config={"model_config": {"model": "UNet",
                                     "width_multiplier": 1.0}},
            traffic={"entry": "trainer", "batch_size": 8 * world,
                     "kernels": ["nb_conv3d", "nb_conv3d_dw"],
                     "inputs": {"patch": 16}},
            units=[(1.0, 0.5)] * 3, window_s=1.0, world=world,
            trace=SimpleNamespace(device=[(0.0, 10.0, "nb_conv3d_kernel")],
                                  host=[], busy_s=1e-5, window_s=1.0),
            counters={"nb_conv3d_dw.launches": 54}, bench_dir=BENCH)

    one = _read(family + ".dp4", run_at(1))
    assert one is not None
    assert _read(family + ".dp4", run_at(4)) == pytest.approx(one)
