"""The benchmark's files against its own rules: names and units, every
per-layer metric reported where the end-to-end metric it moves is, every
file the harness finds by name present, no module of JAX or of the JAX
package imported, and the frozen operation and byte counts at the shapes
whose bounds PERF.md gives."""

from __future__ import annotations

import ast
import json
import os
import re

import pytest

from benchmark import harness, yardstick

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "exaspim_tpu"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _metrics(bench):
    return bench["end_to_end"] + bench["per_layer"]


def test_names_and_units_use_allowed_characters(bench):
    names = [m["name"] for m in _metrics(bench)]
    names += [w["name"] for w in bench["workloads"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    for name in names:
        assert NAME.match(name), name
    for m in _metrics(bench):
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in (_metrics(bench), bench["workloads"], bench["configs"]):
        assert len({x["name"] for x in group}) == len(group)


def test_keys_and_bounds(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in bench["end_to_end"])


def _reported(bench, metric):
    cells = [w["name"] for w in bench["workloads"]]
    return set(metric.get("workloads", cells))


def test_per_layer_metrics_move_a_metric_their_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert _reported(bench, m) <= _reported(bench, e2e[m["moves"]]), \
            m["name"]


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m for m in bench["end_to_end"]
               if w["name"] in _reported(bench, m)]
        assert len(e2e) >= 2
        assert any(w["name"] in _reported(bench, m)
                   for m in bench["per_layer"])


def test_files_found_by_name_exist(bench):
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in bench["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        with open(os.path.join(BENCH, "traffic", f"{w['traffic']}.json")) \
                as f:
            entry = json.load(f)["entry"]
        assert os.path.exists(os.path.join(BENCH, "cells", f"{entry}.py"))
        assert os.path.exists(os.path.join(BENCH, "limits",
                                           f"{w['name']}.json"))
    for m in _metrics(bench):
        assert os.path.exists(harness.metric_reader(BENCH, m["name"]))


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            assert mod.split(".")[0] not in FORBIDDEN, (path, mod)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(BENCH, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            for mod in _imports(os.path.join(ref, f)):
                top = mod.split(".")[0]
                assert top in {"__future__", "math", "json", "struct",
                               "numpy", "torch", "benchmark"}, (f, mod)
                if top == "benchmark":
                    assert mod.startswith("benchmark.reference"), (f, mod)


def test_frozen_bounds_match_perf_md():
    # Rows 1-2 on the 256³ block: 3 batches of 9 patches of 96³.
    assert yardstick.forward_conv_bound_s("UNet", 9, 96, 1.0) * 3e3 \
        == pytest.approx(10.53, abs=0.005)
    # A training step at batch 32 of 64³: rows 1-2, row 3.
    fwd_dx, dw = yardstick.step_conv_bound_s("UNet", 32, 64, 1.0)
    assert fwd_dx * 1e3 == pytest.approx(7.23, abs=0.005)
    assert dw * 1e3 == pytest.approx(3.70, abs=0.005)
    # The N2V step at batch 16, width 0.5.
    fwd_dx, dw = yardstick.step_conv_bound_s("N2V2UNet", 16, 64, 0.5)
    assert fwd_dx * 1e3 == pytest.approx(0.859, abs=0.0005)
    assert dw * 1e3 == pytest.approx(0.451, abs=0.0005)
    # Row 4 on a 64³ patch: two stages of the matcher on one guide.
    assert 2 * yardstick.match_bound_s((64,) * 3, 4, 3, 9, 16) * 1e3 \
        == pytest.approx(0.0138, abs=0.00005)


def test_streamed_plan_counts_the_pipeline_patches():
    # 512³ in slabs of 256 with 96-plane halos: 2 slabs of 5 × 6 × 6
    # patches, 40 batches of 9 (phase 16's 720 conv launches / 18).
    assert yardstick.streamed_patches((512,) * 3, 256, 96, 12, 9) == 360
    assert yardstick.count_patches((512,) * 3, 96, 12) == 216
    assert len([s for s in yardstick.conv_shapes("UNet", 64, 1.0)
                if s[0] == "fwd"]) == 18


def test_a_metric_without_a_file_of_its_own_takes_its_family_reader(
        tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "device.idle.py").write_text("")
    assert harness.metric_reader(str(tmp_path), "device.idle.teacher") \
        == str(tmp_path / "metrics" / "device.idle.py")
    (tmp_path / "metrics" / "device.idle.teacher.py").write_text("")
    assert harness.metric_reader(str(tmp_path), "device.idle.teacher") \
        == str(tmp_path / "metrics" / "device.idle.teacher.py")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader(str(tmp_path), "model.noconv_ms.teacher")
