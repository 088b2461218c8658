"""The benchmark's engine: finds a cell's files by name, runs its entry
through set-up and one measured window, reads the metrics and prints the
result line.

A cell ``<config>.<traffic>`` of ``BENCHMARK.json`` names its files:
``configs/<config>.json`` (the model), ``traffic/<traffic>.json`` (the
inputs and the entry, ``cells/<entry>.py``), ``limits/<cell>.json``
(the limits of the check that decides ``correct``) and, per metric, a
reader ``read(run)`` that returns a number or None: ``metrics/<metric>.py``
or, where that file is absent, the reader of the metric's family, the
name less its last dotted parts (``device.idle.train`` →
``metrics/device.idle.py``). Nothing here lists cells or metrics: a later
change adds a cell or a metric by adding files.

An entry is a module with a class ``Cell(ctx)`` with ``run(h)``, ``free()`` and
``check()``. ``run`` makes its inputs from ``ctx.seed``, builds the
program and warms up every shape the window uses, then calls
``h.begin_window()``, runs units until ``h.over()``, finishing the unit in
flight, reports each with ``h.unit_done(size)`` (and, for steps,
``h.step_mark()`` after enqueueing the step) and calls ``h.end_window()``.
``free`` drops the program's state; ``check`` then runs the plain
reference over the window's outputs and returns ``[(name, value,
limit)]``; the run is correct when no value exceeds its limit.

A cell on several cards runs one process a card (``launch.py``), each
with the same seed and ``ctx.rank`` / ``ctx.world`` set. Rank 0 owns the
window's clock, the check and the one result line, and its trace is the
one the metrics read; the ranks agree on the window's last unit through a
``TCPStore`` (:class:`Ranks`) and hand rank 0 their memory peaks and
traced busy time. Every rank exits with 3, printing nothing on standard
output, where it finds JAX loaded once its window has closed.
"""

from __future__ import annotations

import datetime
import importlib.util
import json
import os
import sys
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from benchmark import trace as trace_mod

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "exaspim_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench_dir, bench, workload):
    """``(cell, config, traffic, limits)`` of the workload named
    ``workload`` in ``bench`` (the parsed ``BENCHMARK.json``)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = load_json(os.path.join(bench_dir, "..", conf["file"]))
    traffic = load_json(os.path.join(bench_dir, "traffic",
                                     f"{cell['traffic']}.json"))
    limits = load_json(os.path.join(bench_dir, "limits", f"{workload}.json"))
    return cell, config, traffic, limits


def metric_reader(bench_dir, name):
    """The path of metric ``name``'s reader: its own file, or its
    family's."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = os.path.join(bench_dir, "metrics", ".".join(parts[:n]) + ".py")
        if os.path.exists(path):
            return path
    raise FileNotFoundError(f"no reader for the metric {name!r}")


def entry_module(bench_dir, traffic):
    """The module ``cells/<entry>.py`` of a traffic file: its ``Cell``
    and its ``CONTROL``, the name of the control its check is set
    against."""
    return load_module(os.path.join(bench_dir, "cells",
                                    f"{traffic['entry']}.py"),
                       f"bench_cell_{traffic['entry']}")


def cell_metrics(bench, workload, trace):
    """The metric entries the cell reports: the end-to-end ones without
    ``trace``, the per-layer ones with it."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


class Ranks:
    """The ranks of a cell on several cards, one process each, agreeing
    over a ``TCPStore`` (rank 0 serves it) on where the window ends.

    Rank 0 alone reads the clock. After each unit ``n`` of the window it
    publishes ``p<n>``: 0, or the unit the window ends on, which it fixes
    at ``n + LAG`` when ``n`` finishes past the deadline. Before enqueueing
    unit ``n + 1`` a rank reads ``p<n + 1 − LAG>``, waiting for rank 0 to
    get there, so no rank runs a unit that another leaves out and no rank
    waits on the device: one store round trip a unit on the host, timed
    in ``wait_s``. The window runs ``LAG`` units past the deadline.
    """

    LAG = 4

    def __init__(self, rank, world, port, timeout_s=900):
        self.rank, self.world = int(rank), int(world)
        self.store = dist.TCPStore(
            "127.0.0.1", int(port), self.world, self.rank == 0,
            timeout=datetime.timedelta(seconds=timeout_s))
        self.runs = 0

    @classmethod
    def from_env(cls):
        """The ranks of a process started by ``launch.py``, or None for a
        process on its own."""
        env = os.environ
        if int(env.get("WORLD_SIZE", "1")) <= 1 \
                or "BENCHMARK_STORE_PORT" not in env:
            return None
        return cls(env["RANK"], env["WORLD_SIZE"],
                   env["BENCHMARK_STORE_PORT"])

    def begin_run(self):
        """Fresh keys for this process's next run (each rank runs the
        same runs in the same order)."""
        self.prefix = f"run{self.runs}/"
        self.runs += 1
        self.stop_at = None
        self.wait_s = 0.0

    def over(self, n, late):
        """Whether unit ``n`` of the window (1, 2, ...) is its last;
        ``late``: rank 0's clock is past the deadline."""
        t = time.perf_counter()
        done = False
        if self.rank == 0:
            if self.stop_at is None and late:
                self.stop_at = n + self.LAG
            self.store.set(f"{self.prefix}p{n}", str(self.stop_at or 0))
            done = self.stop_at is not None and n >= self.stop_at
        elif n + 1 - self.LAG >= 1:
            stop = int(self.store.get(f"{self.prefix}p{n + 1 - self.LAG}"))
            done = 0 < stop <= n
        self.wait_s += time.perf_counter() - t
        return done

    def done(self):
        """Rank 0: the run's result is out. The other ranks wait for it,
        so that every rank leaves a run, and its process group, together."""
        key = f"{self.prefix}done"
        if self.rank == 0:
            self.store.set(key, "1")
            # Rank 0 serves the store: it stays until every rank has read.
            self.store.wait([f"{self.prefix}left{r}"
                             for r in range(1, self.world)])
        else:
            self.store.get(key)
            self.store.set(f"{self.prefix}left{self.rank}", "1")

    def gather(self, record):
        """Every rank's ``record`` (a JSON-able dict: its memory peaks, its
        traced busy time), in rank order, on rank 0; None on the others."""
        self.store.set(f"{self.prefix}rec{self.rank}", json.dumps(record))
        if self.rank != 0:
            return None
        return [json.loads(self.store.get(f"{self.prefix}rec{r}"))
                for r in range(self.world)]


class Window:
    """The clock of one run: set-up from process start to the window's
    start; the window from there to the end of the unit in flight at the
    deadline."""

    def __init__(self, t_process, seconds, device, trace, ranks=None):
        self.t_process = t_process
        self.ranks = ranks
        self.seconds = float(seconds)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.trace = trace
        self.units = []      # (size, host seconds since the window's start)
        self.marks = []      # CUDA events at the end of each step
        self.setup_s = None
        self.window_s = None
        self.prof = None
        self.peak_setup = 0
        self.peak_window = 0
        self.counters = {}
        self._counter_fns = {}
        self.phases = []     # (set-up phase, seconds since process start)

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def mark(self, name):
        """The end of set-up phase ``name``, on the host clock (printed on
        standard error: where set-up's time goes)."""
        self.phases.append((name, time.perf_counter() - self.t_process))

    def watch(self, name, fn):
        """A program counter ``fn()`` whose change over the window is
        recorded as ``counters[name]``."""
        self._counter_fns[name] = fn

    def begin_window(self):
        self.sync()
        if self.cuda:
            self.peak_setup = torch.cuda.max_memory_allocated(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)
        self._c0 = {k: fn() for k, fn in self._counter_fns.items()}
        if self.trace:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
        self.t0 = time.perf_counter()
        self.setup_s = self.t0 - self.t_process
        self.deadline = self.t0 + self.seconds
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()

    def over(self):
        late = time.perf_counter() >= self.deadline
        if self.ranks is None:
            return late
        return self.ranks.over(len(self.units), late)

    def unit_done(self, size):
        self.units.append((float(size), time.perf_counter() - self.t0))

    def step_mark(self):
        """Record the end of a step on the compute stream (no sync)."""
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def end_window(self):
        self.sync()
        self.window_s = time.perf_counter() - self.t0
        if self.prof is not None:
            self.prof.stop()
        self.counters = {k: fn() - self._c0[k]
                         for k, fn in self._counter_fns.items()}
        if self.cuda:
            self.peak_window = torch.cuda.max_memory_allocated(self.device)

    def step_ms(self):
        """Each step's interval in ms: from the previous step's end (the
        window's start for the first) to its own end."""
        if self.cuda:
            evs = [self._start] + self.marks
            return [a.elapsed_time(b) for a, b in zip(evs, evs[1:])]
        ts = [self.t0] + self.marks
        return [1e3 * (b - a) for a, b in zip(ts, ts[1:])]


def forbidden_modules():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in FORBIDDEN)


def refuse_forbidden(err=sys.stderr):
    """Exit with 3, naming them on ``err``, where modules of JAX or of the
    JAX package are loaded in this process."""
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or of the JAX package were loaded: {found}",
              file=err, flush=True)
        raise SystemExit(3)


def run_cell(workload, seed, seconds, trace, device="cuda", bench_dir=HERE,
             t_process=None, control=None, out=sys.stdout, err=sys.stderr,
             ranks=None):
    """One run of one cell; prints the result line and returns it (on
    rank 0; the other ranks of ``ranks`` return None).
    ``control`` (the entry's ``CONTROL``, or ``"half_batch"`` for
    training cells) puts the reference in the control's precision, or
    with a planted fault, in the program's place for the check; ``"bf16"``
    puts the U-Net reference in the configuration's own precision there
    (a witness of what bf16 alone reads)."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = load_json(os.path.join(bench_dir, "..", "BENCHMARK.json"))
    _, config, traffic, limits = cell_files(bench_dir, bench, workload)
    rank, world = (0, 1) if ranks is None else (ranks.rank, ranks.world)
    if ranks is not None:
        ranks.begin_run()
    ctx = SimpleNamespace(config=config, traffic=traffic, limits=limits,
                          seed=int(seed), device=device, bench_dir=bench_dir,
                          root=os.path.dirname(bench_dir), control=control,
                          rank=rank, world=world)
    entry = entry_module(bench_dir, traffic)
    w = Window(t_process, seconds, device, trace, ranks)
    cellobj = entry.Cell(ctx)
    cellobj.run(w)
    # Each rank traces its own card; the metrics read rank 0's trace, the
    # busy time is averaged over the cards.
    traced = trace_mod.read(w.prof, w.window_s) if w.prof is not None \
        else None
    record = {"peaks": [w.peak_setup, w.peak_window],
              "busy_s": None if traced is None else traced.busy_s}
    if ranks is None:
        records = [record]
    else:
        print(f"rank {rank}: the window's stop agreed in "
              f"{1e3 * ranks.wait_s / max(len(w.units), 1):.4f} ms a unit "
              f"({len(w.units)} units)", file=err, flush=True)
        records = ranks.gather(record)
        if rank != 0:
            cellobj.free()
            # Every rank looks once its window has closed: a rank that
            # loaded JAX exits non-zero, and the launcher then drops rank
            # 0's result line.
            refuse_forbidden(err)
            ranks.done()
            return None
    print("setup phases (s since process start): " + ", ".join(
        f"{n} {t:.3f}" for n, t in w.phases + [("window", w.setup_s)]),
        file=err, flush=True)
    run = SimpleNamespace(
        config=config, traffic=traffic, setup_s=w.setup_s,
        window_s=w.window_s, units=w.units,
        step_ms=w.step_ms() if w.marks else [], counters=w.counters,
        peak_bytes=max(r["peaks"][1] for r in records), trace=traced,
        world=world, bench_dir=bench_dir)
    if run.step_ms:
        slow = sorted(range(len(run.step_ms)), key=lambda i: -run.step_ms[i])
        print("steps %d, median %.3f ms, slowest (index: ms) %s" % (
            len(run.step_ms), sorted(run.step_ms)[len(run.step_ms) // 2],
            ", ".join(f"{i}: {run.step_ms[i]:.3f}" for i in slow[:8])),
            file=err, flush=True)
    peak = max(max(r["peaks"]) for r in records)
    cellobj.free()
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        reader = load_module(metric_reader(bench_dir, m["name"]),
                             f"bench_metric_{m['name']}")
        value = reader.read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    checks = cellobj.check()
    refuse_forbidden(err)
    over = sum(1 for _, v, lim in checks if not v <= lim)
    for name, v, lim in checks:
        print(f"check {name} = {v!r} (limit {lim!r})", file=err, flush=True)
    result = {
        "correct": over == 0 and bool(checks),
        "attempted": len(w.units),
        "failed": int(getattr(cellobj, "failed_units", 0)),
        "metrics": metrics,
        "device": device_record(device, peak, world),
    }
    if run.trace is not None:
        result["device"]["busy_s"] = sum(r["busy_s"] for r in records) \
            / len(records)
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown
    result["checks"] = {name: {"value": float(v), "limit": float(lim)}
                        for name, v, lim in checks}
    print(json.dumps(result), file=out, flush=True)
    if ranks is not None:
        ranks.done()
    return result


def device_record(device, peak, count=1):
    """``peak``: the fullest card's."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def end_ranks():
    """Leave the program's process group, where a cell joined one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
