"""Conv micro-benchmark: the library conv vs the port's two conv kernels.

PyTorch counterpart of ``scripts/nb_bench.py``. Times the UNet's three hot
conv shapes three ways on the card:

* ``F.conv3d`` (cuDNN; the counterpart of the script's XLA column, a
  yardstick only: the port never calls it on a path),
* ``blocked_conv3d`` (``csrc/blocked_conv3d.cu``, the counterpart of
  ``ops/pallas_conv.py``: its own entry point over the same forward
  kernels, ``csrc/nb_conv3d_fwd.cuh``, for one segment without
  statistics),
* ``nb_conv3d`` (``csrc/nb_conv3d.cu``, the conv of the model paths).

Each timing chains ``REPS`` applications (the output of one is the input
of the next, so nothing can be elided) and ends in a scalar f32 checksum;
one warm-up chain, then the best of ``TIMED_CHAINS`` chains between CUDA
events. Two things of the script are not carried over because they exist
for the TPU only: its ``unpack+pack`` column (the port's kernels read and
write plain NDHWC, there is no blocked layout to convert) and the one-jit
``fori_loop`` chain (PyTorch queues the 16 launches without a host round
trip, and CUDA events time the device, not the link).

    python -m exaspim_tpu_torch.ops.nb_bench [--batch 32]

``--path-shapes`` instead times ``nb_conv3d`` alone at the shapes of the
port's model paths, each shape once, with the sums and the wrapper's mean
host time per launch: the 18 forward convs of the 256³ block's path
(``chip_smoke.py`` phase 4: patches of 96³ at batch 9, with statistics,
times 3 batches per block), six of those shapes at a fixed batch
(:data:`INFERENCE_SHAPES`, batch 2), and every conv of one training step
of the default configuration (batch 32 of 64³: 18 forwards with
statistics, 17 dL/dx in plain mode, :func:`unet_conv_shapes`), and the
step's 18 dL/dW launches through ``nb_conv3d_dw`` (:func:`unet_dw_shapes`,
summed as ``dw_ms``). It uses only the public ``nb_conv3d`` and
``nb_conv3d_dw``, so the same file times an older checkout of the package
put first on ``PYTHONPATH``:

    PYTHONPATH=OLD_ROOT python exaspim_tpu_torch/ops/nb_bench.py --path-shapes
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.nn.functional as F

from exaspim_tpu_torch.ops.blocked_conv import blocked_conv3d
from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw

__all__ = ["bench_shape", "main", "path_shapes", "unet_conv_shapes",
           "unet_dw_shapes", "REPS", "TIMED_CHAINS", "SHAPES", "INFERENCE_SHAPES"]

REPS = 16
TIMED_CHAINS = 3
# (D, H, W, Cin, Cout): encoder stage 1 / decoder top, stage 2, stage 3.
SHAPES = ((64, 64, 64, 32, 32), (32, 32, 32, 64, 64), (16, 16, 16, 128, 128))
# (B, n, segments, Cout): six of the inference path's conv shapes at batch 2
# (entry, top, decoder top, stage 2 decoder, stage 4 decoder, bottleneck),
# as chip_smoke.py phase 3 checks and times them beside the path's own.
INFERENCE_SHAPES = ((2, 96, (1,), 32), (2, 96, (32,), 32),
                    (2, 96, (32, 32), 32), (2, 48, (64, 64), 64),
                    (2, 12, (256, 256), 256), (2, 6, (256,), 256))


def unet_conv_shapes(n, width=1.0, base=(32, 64, 128, 256, 512)):
    """The 3³ convs of one forward and backward of ``models.UNet`` on an
    ``n``³ input: a list of ``(kind, n_i, segments, Cout)`` with kind
    ``"fwd"`` (18, with statistics) or ``"dx"`` (17: every conv but the
    entry conv, whose input needs no gradient, as the forward conv of the
    cotangent with transposed taps)."""
    c1, c2, c3, c4, c5 = (int(c * width) for c in base)
    fwd = []
    for i, (cin, cout) in enumerate(((1, c1), (c1, c2), (c2, c3), (c3, c4),
                                     (c4, c5 // 2))):
        fwd += [(n >> i, (cin,), cout), (n >> i, (cout,), cout)]
    for i, (cs, cu, cout) in enumerate(((c4, c5 // 2, c4 // 2),
                                        (c3, c4 // 2, c3 // 2),
                                        (c2, c3 // 2, c2 // 2),
                                        (c1, c2 // 2, c1))):
        m = n >> (3 - i)
        fwd += [(m, (cs, cu), (cs + cu) // 2), (m, ((cs + cu) // 2,), cout)]
    out = [("fwd", *f) for f in fwd]
    out += [("dx", m, (cout,), sum(segs)) for m, segs, cout in fwd[1:]]
    return out


def unet_dw_shapes(n, width=1.0):
    """The dL/dW launches of one backward of ``models.UNet`` on an ``n``³
    input: ``(n_i, segments, Cout)`` of each of the 18 forward convs."""
    return [(m, segs, cout) for kind, m, segs, cout
            in unet_conv_shapes(n, width) if kind == "fwd"]


def _conv_ms(b, n, segs, cout, stats, reps):
    """Mean device ms of one ``nb_conv3d`` launch (``stats`` True or
    False) or one ``nb_conv3d_dw`` launch (``stats == "dw"``; ``cout`` is
    then the cotangent's width) on seeded random bf16 inputs (CUDA events
    around one replay of a CUDA graph of ``reps`` wrapper calls, after one
    warm-up, so that the host's time per call, which approaches the
    device's at the smallest shapes, does not enter), and the mean host µs
    the wrapper took to return from a launch."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = tuple(torch.randn((b, n, n, n, c), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for c in segs)
    if stats == "dw":
        g = torch.randn((b, n, n, n, cout), generator=gen, device="cuda",
                        dtype=torch.bfloat16)

        def run():
            nb_conv3d_dw(xs, g)
    else:
        k = (torch.randn((27, sum(segs), cout), generator=gen, device="cuda")
             / np.sqrt(27 * sum(segs))).to(torch.bfloat16)

        def run():
            nb_conv3d(xs, k, with_stats=stats)
    with torch.no_grad():
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        host_us = (time.perf_counter() - t0) / reps * 1e6
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                run()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        del graph
    return start.elapsed_time(end) / reps, host_us


_MODE_NAMES = {True: "stats", False: "plain", "dw": "dL/dW"}
# The 256^3 block's tiling (inference.plan_tiling): 96^3 patches, batch 9,
# 3 batches per block.
BLOCK_PATCH, BLOCK_BATCH, BLOCK_BATCHES = 96, 9, 3


def path_shapes(train_batch=32, train_n=64):
    """Time ``nb_conv3d`` at the block, inference and training path shapes
    and ``nb_conv3d_dw`` at the training step's;
    prints one line per shape, the sums and the mean host time per launch,
    and returns them. ``block_ms`` is per 256³ block (the 18 forward convs
    of one batch, times its 3 batches); ``dw_ms`` sums the training step's
    18 dL/dW launches."""
    rows = [("block", BLOCK_BATCH, n, segs, cout, True)
            for kind, n, segs, cout in unet_conv_shapes(BLOCK_PATCH)
            if kind == "fwd"]
    rows += [("inference", b, n, segs, cout, True)
             for b, n, segs, cout in INFERENCE_SHAPES]
    rows += [("training", train_batch, n, segs, cout, kind == "fwd")
             for kind, n, segs, cout in unet_conv_shapes(train_n)]
    rows += [("dw", train_batch, n, segs, cout, "dw")
             for n, segs, cout in unet_dw_shapes(train_n)]
    res = {"block_ms": 0.0, "inference_ms": 0.0, "training_ms": 0.0,
           "dw_ms": 0.0, "shapes": []}
    host = []
    for path, b, n, segs, cout, stats in rows:
        ms, host_us = _conv_ms(b, n, segs, cout, stats,
                               50 if n <= 16 else 20 if n <= 48 else 10)
        res[f"{path}_ms"] += ms * (BLOCK_BATCHES if path == "block" else 1)
        res["shapes"].append([path, b, n, list(segs), cout, stats, ms,
                              host_us])
        host.append(host_us)
        print(f"{path:9s} B={b:<2d} {n:3d}^3 {'|'.join(map(str, segs)):>7s}"
              f"->{cout:<3d} {_MODE_NAMES[stats]}  {ms:.4f} ms  "
              f"host {host_us:.1f} us", flush=True)
        torch.cuda.empty_cache()
    res["host_us_mean"] = float(np.mean(host))
    print(f"sums: block (54 convs, B={BLOCK_BATCH}) {res['block_ms']:.4f} "
          f"ms, inference (6 shapes, B=2) {res['inference_ms']:.4f} ms, "
          f"training step (35 convs, B={train_batch}) "
          f"{res['training_ms']:.4f} ms, dL/dW of the step (18 launches) "
          f"{res['dw_ms']:.4f} ms; host {res['host_us_mean']:.1f} us "
          "per launch (mean over the shapes)", flush=True)
    return res


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
    ap.add_argument("--path-shapes", action="store_true",
                    help="time nb_conv3d and nb_conv3d_dw alone at the "
                    "model paths' shapes")
    args = ap.parse_args(argv)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("nb_bench times kernels on a CUDA card; "
                               "none is available")
        print("device:", torch.cuda.get_device_name(0), flush=True)
    if args.path_shapes:
        out = path_shapes()
        print(json.dumps(out), flush=True)
        return out
    out = {"batch": args.batch, "reps": REPS, "timed_chains": TIMED_CHAINS,
           "shapes": [bench_shape(args.batch, *s, device=device)
                      for s in SHAPES]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
