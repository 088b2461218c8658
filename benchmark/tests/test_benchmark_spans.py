"""The readers of the program's spans (``spans.py`` and the six metrics
over it) on a hand-made trace whose answers are worked out by hand, then
in traced whole runs of the denoise and trainer cells at a tiny size on
the CPU, where the spans are recorded and no device operation is."""

from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from benchmark import harness, spans
from benchmark.tests.test_benchmark_runs import run, tiny_copy

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)

# Host spans (µs) of one thread: a volume holding two waits, a write nested
# in the first wait, a cast that starts inside the first wait's idle gap.
HOST = [
    (0.0, 100.0, "pipeline.volume"),
    (10.0, 40.0, "pipeline.wait"),
    (12.0, 20.0, "pipeline.write"),
    (60.0, 80.0, "pipeline.wait"),
    (82.0, 95.0, "inference.cast"),
    (70.0, 71.0, "aten::copy_"),
]
# Two streams overlap on [15, 20]: busy [0, 30], [50, 65], [90, 120]; the
# device idles on [30, 50] (across the first wait's end) and [65, 90]
# (across the second wait's end and the whole cast but its last 5 µs).
DEVICE = [(0.0, 20.0, "k1"), (15.0, 30.0, "k2"), (50.0, 65.0, "k3"),
          (90.0, 120.0, "k4")]


def _run(host=HOST, device=DEVICE, units=2, entry="denoise"):
    return SimpleNamespace(
        trace=SimpleNamespace(host=list(host), device=list(device)),
        units=[(1.0, 0.0)] * units, traffic={"entry": entry})


@pytest.mark.parametrize("names,idle_us", [
    (("pipeline.wait",), 10.0 + 15.0),
    # The nested write adds nothing; the volume holds both gaps whole.
    (("pipeline.wait", "pipeline.write"), 25.0),
    (("pipeline.volume",), 20.0 + 25.0),
    (("pipeline.volume", "pipeline.wait", "inference.cast"), 45.0),
    (("inference.cast",), 8.0),
    (("pipeline.write",), 0.0),
])
def test_idle_inside_spans_counts_each_instant_once(names, idle_us):
    assert spans.idle_seconds_in(_run(), names) == pytest.approx(
        idle_us * 1e-6)


def test_span_seconds_sums_each_occurrence():
    r = _run()
    assert spans.span_seconds(r, ("pipeline.wait",)) == pytest.approx(50e-6)
    assert spans.span_seconds(r, ("pipeline.wait", "pipeline.write")) \
        == pytest.approx(58e-6)


def test_nothing_traced_reads_none():
    r = _run()
    assert spans.span_seconds(r, ("trainer.step",)) is None
    assert spans.idle_seconds_in(r, ("trainer.step",)) is None
    cpu = _run(device=[])
    assert spans.span_seconds(cpu, ("pipeline.wait",)) == pytest.approx(
        50e-6)
    assert spans.idle_seconds_in(cpu, ("pipeline.wait",)) is None
    untraced = SimpleNamespace(trace=None, units=[(1.0, 0.0)])
    assert spans.span_seconds(untraced, ("pipeline.wait",)) is None
    assert spans.idle_seconds_in(untraced, ("pipeline.wait",)) is None
    assert spans.per_unit_ms(SimpleNamespace(units=[]), 1.0) is None


def _read(name, r):
    return harness.load_module(harness.metric_reader(BENCH, name),
                               f"bench_metric_{name}").read(r)


@pytest.mark.parametrize("name,entry,host,ms", [
    ("pipeline.wait_ms", "denoise", HOST, 50e-3 / 2),
    ("pipeline.staging_idle_ms", "denoise", HOST, 25e-3 / 2 + 8e-3 / 2),
    ("model.launch_idle_ms.denoise", "denoise",
     [(30.0, 50.0, "inference.forward"), (60.0, 70.0, "inference.stitch")],
     (20e-3 + 5e-3) / 2),
    ("model.launch_idle_ms.train", "trainer",
     [(25.0, 55.0, "trainer.step")], 20e-3 / 2),
    ("loader.wait_ms.train", "trainer",
     [(0.0, 4.0, "loader.wait"), (40.0, 41.0, "loader.wait")], 5e-3 / 2),
    ("trainer.stall_idle_ms.train", "trainer",
     [(28.0, 35.0, "loader.wait"), (35.0, 45.0, "loader.upload"),
      (66.0, 68.0, "trainer.log")], (15e-3 + 2e-3) / 2),
])
def test_each_metric_reads_its_spans(name, entry, host, ms):
    assert _read(name, _run(host=host, entry=entry)) == pytest.approx(ms)
    # The parent of the program records none of these spans.
    assert _read(name, _run(host=[(0.0, 99.0, "bench.denoise_volume")],
                            entry=entry)) is None


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("bench-spans")))


@pytest.mark.parametrize("workload,waits,idles", [
    ("bm4dnet-w1.denoise-512", ["pipeline.wait_ms"],
     ["pipeline.staging_idle_ms", "model.launch_idle_ms.denoise"]),
    ("bm4dnet-w1.train-stream", ["loader.wait_ms.train"],
     ["model.launch_idle_ms.train", "trainer.stall_idle_ms.train"]),
])
def test_traced_cpu_run_reads_the_waits_and_no_device_idle(
        tiny, workload, waits, idles):
    res = run(tiny, workload, trace=True)
    assert res["correct"], res["checks"]
    for name in waits:
        assert res["metrics"][name]["value"] >= 0.0
        assert res["metrics"][name]["unit"] == "ms"
    for name in idles:
        assert name not in res["metrics"]
