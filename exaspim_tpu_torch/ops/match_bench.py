"""Time the BM4D matcher alone on the card.

PyTorch counterpart of ``scripts/match_bench.py``: block matching at the
defaults of the teacher path (block 4, step 3, search 9) on a seeded
normal(100, 24) volume of ``dim``³ per size (64 and 128 by default; a
size whose ``(dim − 4) % 3`` is not 0 is reflect-padded to the next that
is, as ``bm4d_stage`` pads). Per size it times, between CUDA events, the
mean of ``--reps`` calls after one warm-up:

* ``match_topk`` on one guide (``match_topk_ms``: the fused kernel, one
  launch) and on a batch of ``--batch`` guides (per guide), and the fused
  kernel's table instance on the same batch with the same tiles
  (``table_batch_ms_per_guide``): the difference is what the selection
  costs inside the fused kernel;
* the two halves on their own: ``match_distances`` (the table) and
  ``select_topk`` on that table, with ``torch.topk`` of the same packed
  keys beside the selection (a yardstick the port never calls);
* with ``--plain``, the plain PyTorch version of the whole matcher;
* with ``--teachers N``, the teacher path around it: ``bm4d_batch`` on N
  synthetic 64³ patches in the path's batches of 8, seconds per patch on
  the host clock (median of three runs, after a warm-up), and the device's
  idle share during one batch (``torch.profiler``);

and gives the card's bound beside them: the operations of the separable
evaluation (:func:`match_operations`) at the FP32 vector peak, or the
guide read once and the starts written once at the memory rate, the
larger. It uses only the matcher's public functions, so the same file
times an older checkout of the package put first on ``PYTHONPATH``: there
``match_topk`` was the table kernel followed by the selection kernel
(``fused`` false in the record) and took one guide at a time.

    python -m exaspim_tpu_torch.ops.match_bench [dim ...] [--group K]
    PYTHONPATH=OLD_ROOT python exaspim_tpu_torch/ops/match_bench.py

With ``device="cpu"`` (the tests) it runs the plain versions and times
them on the host clock; those are no device numbers.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from exaspim_tpu_torch.ops import bm4d_match as tm

__all__ = ["main", "match_operations", "bound_ms", "BLOCK", "STEP",
           "SEARCH"]

BLOCK, STEP, SEARCH = 4, 3, 9
PEAK_F32_FLOPS = 67e12  # H100 SXM, outside the tensor cores
PEAK_BYTES = 3.35e12


def match_operations(shape, grid, block=BLOCK, search=SEARCH):
    """f32 operations the distance table of a guide of ``shape`` needs when
    nothing is computed twice, at the rounding points and in the summation
    order of the function: a squared difference (subtract, multiply) once
    per unordered voxel pair within the window (the pair of Δ is the pair
    of −Δ seen from the other voxel, and a reflected neighbour is an
    in-volume one), then per offset the three strided box sums of B−1 adds
    each, over z on every (y, x) column, over y on the reference rows, over
    x on the references."""
    Z, Y, X = shape
    gz, gy, gx = grid
    w3 = search ** 3
    squares = 2.0 * Z * Y * X * (w3 - 1) / 2
    sums = (block - 1.0) * w3 * (gz * Y * X + gz * gy * X + gz * gy * gx)
    return squares + sums


def bound_ms(shape, grid, group, block=BLOCK, search=SEARCH):
    """The least time an H100 could take for the fused matcher on one
    guide: its operations at the FP32 peak, or the guide read once and the
    ``3·R·K`` int32 starts written once, whichever is longer; and which."""
    refs = grid[0] * grid[1] * grid[2]
    t_ops = match_operations(shape, grid, block, search) / PEAK_F32_FLOPS
    t_bytes = (4 * np.prod(shape) + 12 * refs * group) / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _volume(dim, n, seed=0):
    rng = np.random.default_rng(seed)
    vol = rng.normal(100.0, 24.0, (n, dim, dim, dim)).astype(np.float32)
    tail = (-(dim - BLOCK)) % STEP
    return np.pad(vol, [(0, 0)] + [(0, tail)] * 3, mode="reflect")


def _timer(device, reps):
    def ms(fn):
        fn()
        if device != "cuda":
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            return 1e3 * (time.perf_counter() - t0) / reps
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    return ms


def _table_batch(vols):
    """The fused kernel's matching half on a batch: its table instance, one
    launch, with the tiles the fused kernel takes (the plain version on a
    CPU tensor)."""
    if vols.device.type != "cuda":
        return [tm.match_distances_plain(v, BLOCK, STEP, SEARCH)
                for v in vols]
    grid = tm.grid_shape(vols.shape[1:], BLOCK, STEP)
    plan = tm._match_plan(grid, BLOCK, STEP, SEARCH)
    out = torch.empty((vols.shape[0] * grid[0] * grid[1] * grid[2],
                       SEARCH ** 3), dtype=torch.bfloat16, device=vols.device)
    tm._launch("bm4d_match_table_f32", tm._pad_guides(vols, SEARCH), grid,
               BLOCK, STEP, SEARCH, plan, (), out)
    return out


def bench(dim, group=16, batch=8, reps=20, plain=False, device="cuda"):
    """One size: the record described in the module docstring."""
    vols = torch.from_numpy(_volume(dim, batch)).to(device)
    g = vols[0]
    grid = tm.grid_shape(g.shape, BLOCK, STEP)
    fused = hasattr(tm.match_topk, "launches")
    ms = _timer(device, reps)
    rec = {"dim": dim, "shape": list(g.shape), "refs": grid[0] * grid[1]
           * grid[2], "group": group, "batch": batch, "fused": fused,
           "device": (torch.cuda.get_device_name(0) if device == "cuda"
                      else "cpu (plain versions, host clock)")}
    rec["match_topk_ms"] = ms(
        lambda: tm.match_topk(g, BLOCK, group, STEP, SEARCH))
    if fused:
        per = ms(lambda: tm.match_topk(vols, BLOCK, group, STEP, SEARCH))
        rec["table_batch_ms_per_guide"] = ms(
            lambda: _table_batch(vols)) / batch
    else:  # one guide at a time
        per = ms(lambda: [tm.match_topk(v, BLOCK, group, STEP, SEARCH)
                          for v in vols])
    rec["match_topk_batch_ms_per_guide"] = per / batch
    table = tm.match_distances(g, BLOCK, STEP, SEARCH)
    rec["table_ms"] = ms(lambda: tm.match_distances(g, BLOCK, STEP, SEARCH))
    rec["select_ms"] = ms(
        lambda: tm.select_topk(table, grid, group, STEP, SEARCH))
    keys = tm._keys(table, SEARCH)
    rec["topk_ms"] = ms(
        lambda: torch.topk(keys, group, dim=1, largest=False))
    if plain:
        rec["plain_ms"] = _timer(device, 1)(lambda: tm.select_topk_plain(
            tm.match_distances_plain(g, BLOCK, STEP, SEARCH), grid, group,
            STEP, SEARCH))
    rec["bound_ms"], rec["bound_by"] = bound_ms(tuple(g.shape), grid, group)
    inside = (f" (its table instance {rec['table_batch_ms_per_guide']:.4f})"
              if fused else "")
    print(f"{dim}^3 ({'fused' if fused else 'table + select'}): match_topk "
          f"{rec['match_topk_ms']:.4f} ms, in a batch of {batch} "
          f"{rec['match_topk_batch_ms_per_guide']:.4f} ms per guide{inside}; "
          "table "
          f"{rec['table_ms']:.4f} + select {rec['select_ms']:.4f} ms "
          f"(torch.topk {rec['topk_ms']:.4f}); bound {rec['bound_ms']:.4f} "
          f"ms ({rec['bound_by']})", flush=True)
    return rec


def teachers(n, batch=8, sigma=24.0, device="cuda"):
    """``bm4d_batch`` on ``n`` synthetic 64³ patches in batches of
    ``batch``: seconds per patch and the idle share of one batch."""
    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset
    from exaspim_tpu_torch.ops.bm4d import bm4d_batch

    ds = SyntheticPatchDataset(n=n, seed=42)
    raws = np.stack([ds.raw_and_fg(i)[0] for i in range(n)]).astype(
        np.float32)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    def run(lo, hi):
        bm4d_batch(raws[lo:hi], sigma, device=device).cpu()

    run(0, batch)
    times = []
    for _ in range(3):
        sync()
        t0 = time.perf_counter()
        for lo in range(0, n, batch):
            run(lo, lo + batch)
        times.append((time.perf_counter() - t0) / n)
    rec = {"patches": n, "batch": batch, "seconds_per_patch": times,
           "median_s": float(np.median(times)), "idle_share": None}
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(0, batch)
            sync()
            wall = time.perf_counter() - t0
        busy = sum(getattr(e, "self_device_time_total", 0)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        rec.update(profile_wall_s=wall, device_busy_s=busy,
                   idle_share=max(0.0, 1 - busy / wall) if busy else None)
    idle = ("not measured" if rec["idle_share"] is None
            else f"{rec['idle_share']:.3f}")
    print(f"bm4d_batch, {n} patches of 64^3 in batches of {batch}: seconds "
          f"per patch {times} (median {rec['median_s']:.5f}); idle share of "
          f"one batch {idle}", flush=True)
    return rec


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dims", type=int, nargs="*", default=[64, 128])
    ap.add_argument("--group", type=int, default=16)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plain", action="store_true",
                    help="also time the plain version once")
    ap.add_argument("--teachers", type=int, default=0,
                    help="also time bm4d_batch on this many 64^3 patches")
    args = ap.parse_args(argv)
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("match_bench times kernels on a CUDA card; none "
                           "is available")
    out = {"matcher": [bench(d, args.group, args.batch, args.reps,
                             args.plain, device) for d in args.dims]}
    if args.teachers:
        out["teachers"] = teachers(args.teachers, args.batch, device=device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
