"""Conv micro-benchmark: the library conv vs the port's two conv kernels.

PyTorch counterpart of ``scripts/nb_bench.py``. Times the UNet's three hot
conv shapes three ways on the card:

* ``F.conv3d`` (cuDNN; the counterpart of the script's XLA column, a
  yardstick only: the port never calls it on a path),
* ``blocked_conv3d`` (``csrc/blocked_conv3d.cu``, the shared-memory halo
  tile),
* ``nb_conv3d`` (``csrc/nb_conv3d.cu``, the implicit GEMM that re-reads
  every voxel once per tap).

Each timing chains ``REPS`` applications (the output of one is the input
of the next, so nothing can be elided) and ends in a scalar f32 checksum;
one warm-up chain, then the best of ``TIMED_CHAINS`` chains between CUDA
events. Two things of the script are not carried over because they exist
for the TPU only: its ``unpack+pack`` column (the port's kernels read and
write plain NDHWC, there is no blocked layout to convert) and the one-jit
``fori_loop`` chain (PyTorch queues the 16 launches without a host round
trip, and CUDA events time the device, not the link).

    python -m exaspim_tpu_torch.ops.nb_bench [--batch 32]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from exaspim_tpu_torch.ops.blocked_conv import blocked_conv3d
from exaspim_tpu_torch.ops.nb_conv import nb_conv3d

__all__ = ["bench_shape", "main", "REPS", "TIMED_CHAINS", "SHAPES"]

REPS = 16
TIMED_CHAINS = 3
# (D, H, W, Cin, Cout): encoder stage 1 / decoder top, stage 2, stage 3.
SHAPES = ((64, 64, 64, 32, 32), (32, 32, 32, 64, 64), (16, 16, 16, 128, 128))


def _timed(chain, x):
    """Seconds per chain (best of ``TIMED_CHAINS`` after one warm-up) and
    the checksum. On the card the clock is a pair of CUDA events; on the
    CPU (control-flow rehearsals only) the host's."""
    check = float(chain(x))
    best = float("inf")
    for _ in range(TIMED_CHAINS):
        if x.is_cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            s = chain(x)
            end.record()
            torch.cuda.synchronize(x.device)
            dt = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            s = chain(x)
            dt = time.perf_counter() - t0
        best = min(best, dt)
        check = float(s)
    return best, check


def _chain(step):
    def run(x):
        y = x
        for _ in range(REPS):
            y = step(y)
        return y.float().sum()
    return run


def bench_shape(b, d, h, w, cin, cout, dtype=torch.bfloat16, device="cuda"):
    """Time the three convs at one shape; prints one line and returns
    ``{"label", "gflop", "library_ms", "blocked_ms", "nb_ms", ...}`` with
    the milliseconds of ONE application."""
    if cin != cout:
        raise ValueError("chained bench needs cin == cout")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(
        rng.normal(0, 0.3, (b, d, h, w, cin)).astype(np.float32)
    ).to(device, dtype)
    # scaled so chained convs neither vanish nor blow up in bf16
    k = torch.from_numpy(
        rng.normal(0, 1.0, (3, 3, 3, cin, cout)).astype(np.float32)
    ).to(device, dtype)
    k = (k / k.float().pow(2).sum(dim=(0, 1, 2, 3)).sqrt()).to(dtype)
    w_lib = k.permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)

    def lib_step(y):
        return F.conv3d(y.permute(0, 4, 1, 2, 3), w_lib,
                        padding=1).permute(0, 2, 3, 4, 1)

    k27 = k.reshape(27, cin, cout).contiguous()
    with torch.no_grad():
        t_lib, c_lib = _timed(_chain(lib_step), x)
        t_blk, c_blk = _timed(_chain(lambda y: blocked_conv3d(y, k)), x)
        t_nb, c_nb = _timed(_chain(lambda y: nb_conv3d(y, k27)), x)
    gflop = 2 * 27 * cin * cout * b * d * h * w / 1e9
    res = {
        "label": f"B{b} {d}x{h}x{w} C{cin}->{cout}",
        "gflop": gflop,
        "clock": "cuda events" if x.is_cuda else "host",
    }
    for name, t, c in (("library", t_lib, c_lib), ("blocked", t_blk, c_blk),
                       ("nb", t_nb, c_nb)):
        res[f"{name}_ms"] = 1e3 * t / REPS
        res[f"{name}_tflops"] = gflop / (t / REPS) / 1e3
        res[f"{name}_checksum"] = c
    print(f"{res['label']:28s} library {res['library_ms']:7.3f} ms "
          f"({res['library_tflops']:5.1f} TF/s)"
          f" | blocked {res['blocked_ms']:7.3f} "
          f"({res['blocked_tflops']:5.1f} TF/s)"
          f" | nb {res['nb_ms']:7.3f} ({res['nb_tflops']:5.1f} TF/s)"
          f" | checksums {c_lib:.4g} {c_blk:.4g} {c_nb:.4g}", flush=True)
    return res


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args(argv)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("nb_bench times kernels on a CUDA card; "
                               "none is available")
        print("device:", torch.cuda.get_device_name(0), flush=True)
    out = {"batch": args.batch, "reps": REPS, "timed_chains": TIMED_CHAINS,
           "shapes": [bench_shape(args.batch, *s, device=device)
                      for s in SHAPES]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
