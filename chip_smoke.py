#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (it builds ``exaspim_tpu_torch/csrc/nb_conv3d.cu``
for ``sm_90a`` into ``exaspim_tpu_torch/build/``) and exits non-zero
without a card. Phases, each announced by a ``# phase:`` line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile the conv kernel, print its seconds and ptxas report;
3. kernel vs plain: the Hopper conv against its plain PyTorch version on
   the card, at the shapes the main path gives it, with and without the
   GroupNorm-statistics epilogue, plus its time beside the plain
   version's, cuDNN's (a yardstick only) and the card's bound;
4. main path: the shipped checkpoint denoises the 256³ bench block
   (``neurite_phantom(n_tubes=24, seed=0)``, ``noisy_observation(seed=1)``)
   through ``predict(..., patch_size="auto")``; the launch count shows
   every 3³ conv went through the kernel; then timed runs, a profile and
   a small-input check against the f32 CPU path;
5. quality: PSNR, SSIM and the blosc-zstd chunked ratio gain against the
   clean phantom, held to the repository's quality guard.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
BLOCK, OVERLAP, TRIM = 256, 12, 5

# The quality guard of bench.py (quality_ok), with the same limits.
MIN_CRATIO_GAIN = 1.9
MIN_PSNR_GAIN_DB = 8.0
# The JAX package's record on the same block (BENCH_r05.json), shown as
# information beside this run's numbers.
REF_R05 = {"cratio_gain": 2.025, "psnr_gain_db": 9.72, "ssim_denoised": 0.9999}

# H100 SXM published dense peaks (NVIDIA data sheet) for the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# Kernel vs plain: both round one f32 sum to bf16, in different orders, so
# an element may differ by one bf16 ulp (2^-8 relative): allow two ulps of
# the largest value. The stats sum those rounded values over ~1e6 voxels.
OUT_RTOL = 2.0 ** -7
STATS_RTOL = 1e-3

_T0 = time.time()


def phase(name):
    print(f"# phase: {name} t={time.time() - _T0:.1f}s", flush=True)


def fail(msg):
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` runs (CUDA events,
    after one warm-up)."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernel(name, b, n, segs, cout, rng):
    """Kernel vs plain version at one conv shape; returns its record."""
    import torch
    import torch.nn.functional as F

    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_plain

    cin = sum(segs)
    xs = tuple(
        torch.from_numpy(rng.standard_normal((b, n, n, n, c), np.float32))
        .to("cuda", torch.bfloat16) for c in segs
    )
    k = torch.from_numpy(
        rng.standard_normal((27, cin, cout), np.float32)
        / np.sqrt(27 * cin, dtype=np.float32)
    ).to("cuda", torch.bfloat16)
    y, s1, s2 = nb_conv3d(xs, k, with_stats=True)
    y_plain_mode = nb_conv3d(xs, k)
    py, p1, p2 = nb_conv3d_plain(xs, k, with_stats=True)
    torch.cuda.synchronize()
    yf, pf = y.float(), py.float()
    err = float((yf - pf).abs().max())
    scale = float(pf.abs().max())
    if not torch.isfinite(yf).all() or err > OUT_RTOL * scale:
        fail(f"{name}: kernel output off by {err} (max |plain| {scale})")
    if not torch.equal(y_plain_mode, y):
        fail(f"{name}: the plain mode differs from the stats mode")
    abs_sum = pf.abs().sum(dim=(1, 2, 3))
    e1 = float(((s1 - p1).abs() / abs_sum).max())
    e2 = float(((s2 - p2).abs() / p2).max())
    if e1 > STATS_RTOL or e2 > STATS_RTOL:
        fail(f"{name}: stats off (Σy {e1:.2e} of Σ|y|, Σy² {e2:.2e})")

    # Times: the kernel as the main path runs it (stats mode), the plain
    # version, and one cuDNN call on the pre-concatenated input.
    reps = 20 if n <= 48 else 10
    kernel_ms = cuda_ms(lambda: nb_conv3d(xs, k, with_stats=True), reps)
    plain_ms = cuda_ms(lambda: nb_conv3d_plain(xs, k, with_stats=True), 3)
    xcat = torch.cat(xs, -1).permute(0, 4, 1, 2, 3)  # channels_last_3d view
    wlib = k.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    library_ms = cuda_ms(lambda: F.conv3d(xcat, wlib, padding=1), reps)

    vox = b * n ** 3
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout + 8 * b * cout
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    rec = {
        "shape": name, "batch": b, "max_abs_err": err,
        "rel_err": err / scale, "stats_err_s1": e1, "stats_err_s2": e2,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "tflops": flops / kernel_ms / 1e9,
    }
    print(
        f"{name} B={b}: max|d|={err:.3e} (rel {err / scale:.2e} <= "
        f"{OUT_RTOL:.2e}) stats {e1:.1e}/{e2:.1e} <= {STATS_RTOL:.0e}  "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) {rec['tflops']:.1f} TFLOP/s",
        flush=True,
    )
    return rec


def profile_once(run):
    """Device time by kernel over one main-path run (torch.profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): the CPU-side
        # aten ops would count their kernels' time a second time.
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    if not rows:
        print("profile: no device time recorded (not measured)")
        return None
    conv_s = sum(r[0] for r in rows if "nb_conv3d_kernel" in r[1]) / 1e6
    print(f"profile: wall {wall:.4f} s, device busy {busy_s:.4f} s "
          f"(idle share {max(0.0, 1 - busy_s / wall):.3f}), of which "
          f"nb_conv3d kernels {conv_s:.4f} s")
    for dev_us, key, count in rows[:10]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<5d} {key[:90]}")
    return {"wall_s": wall, "device_busy_s": busy_s, "conv_s": conv_s,
            "top": [[key, dev_us / 1e3, count]
                    for dev_us, key, count in rows[:15]]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from exaspim_tpu_torch.compression import (
        BloscCodec,
        blosc_available,
        compute_cratio,
    )
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.inference import plan_tiling, predict
    from exaspim_tpu_torch.ops import _build
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
    from exaspim_tpu_torch.ops.ssim import psnr, ssim3d
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    record = {}
    phase("device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)
    record["nvidia_smi"] = smi

    phase("build")
    t0 = time.time()
    _build.load_library("nb_conv3d")
    record["build_s"] = time.time() - t0
    print(f"build_s={record['build_s']:.2f}", flush=True)
    for line in _build.build_log("nb_conv3d").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())

    phase("kernel vs plain")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    shapes = [
        ("96^3 1->32", 2, 96, (1,), 32),
        ("96^3 32->32", 2, 96, (32,), 32),
        ("96^3 (32|32)->32", 2, 96, (32, 32), 32),
        ("48^3 (64|64)->64", 2, 48, (64, 64), 64),
        ("12^3 (256|256)->256", 2, 12, (256, 256), 256),
        ("6^3 256->256", 2, 6, (256,), 256),
    ]
    checks = [check_kernel(*s, rng) for s in shapes]
    record["kernel_checks"] = checks

    phase("main path: restore + phantom")
    model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                        device="cuda")
    clean, _ = neurite_phantom((BLOCK,) * 3, n_tubes=24, seed=0)
    img = noisy_observation(clean, seed=1)
    patch, batch = plan_tiling(img.shape, OVERLAP)
    n_batches = -(-27 // batch)
    print(f"patch={patch} batch={batch} batches={n_batches}", flush=True)

    def run():
        return predict(img, model, transform, patch_size="auto",
                       overlap=OVERLAP, trim=TRIM)

    phase("main path: counted run")
    torch.cuda.reset_peak_memory_stats()
    nb_conv3d.launches = 0
    t0 = time.perf_counter()
    out = run()
    first_s = time.perf_counter() - t0
    launches = nb_conv3d.launches
    want = 18 * n_batches
    print(f"first run {first_s:.4f} s, nb_conv3d launches {launches} "
          f"(expected {want})", flush=True)
    if launches != want:
        fail(f"nb_conv3d launched {launches} times, expected {want}")
    if out.shape != img.shape or out.dtype != np.uint16:
        fail(f"output {out.shape} {out.dtype}")

    phase("main path: timed runs")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = run()
        times.append(time.perf_counter() - t0)
    sec = float(np.median(times))
    record.update({
        "patch": patch, "batch": batch, "launches_per_block": launches,
        "block_s": times, "seconds_per_block": sec,
        "voxels_per_s": img.size / sec,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    })
    print(f"seconds per block {times} (median {sec:.4f}); voxels/s "
          f"{img.size / sec:.1f}; peak device memory "
          f"{record['peak_mem_gb']:.2f} GiB", flush=True)

    phase("main path: profile")
    record["profile"] = profile_once(run)

    phase("main path: small input vs the f32 CPU path")
    # The same checkpoint, f32 on the CPU through the plain conv: the card's
    # bf16 output must stay within bf16 reach of it. Tolerance: bf16 keeps
    # 8 bits, ~0.4 % in the transform domain, which the asinh inverse maps
    # to a few counts at the background and ~1 % at bright voxels.
    small = img[:48, :48, :48]
    got = predict(small, model, transform, patch_size="auto",
                  overlap=OVERLAP, trim=TRIM).astype(np.float64)
    cpu_model, _ = restore_pipeline(CKPT, dtype=torch.float32, device="cpu")
    ref = predict(small, cpu_model, transform, patch_size="auto",
                  overlap=OVERLAP, trim=TRIM, device="cpu").astype(np.float64)
    dev = np.abs(got - ref)
    rel = dev / (ref + 100.0)
    print(f"48^3 vs CPU f32: mean |d| {dev.mean():.4f} counts, max |d| "
          f"{dev.max():.1f}, max |d|/(ref+100) {rel.max():.4f}", flush=True)
    record["small_vs_cpu"] = {"mean_abs": dev.mean(), "max_abs": dev.max(),
                              "max_rel": rel.max()}
    if not np.isfinite(got).all() or dev.mean() > 2.0 or rel.max() > 0.05:
        fail("the card's output strays from the f32 CPU path")

    phase("quality")
    drange = float(clean.max())
    clean_d = torch.from_numpy(clean).cuda()
    noisy_d = torch.from_numpy(img.astype(np.float32)).cuda()
    out_d = torch.from_numpy(out.astype(np.float32)).cuda()
    q = {
        "psnr_noisy_db": float(psnr(noisy_d, clean_d, drange)),
        "psnr_denoised_db": float(psnr(out_d, clean_d, drange)),
        "ssim_noisy": float(ssim3d(noisy_d, clean_d, data_range=drange)),
        "ssim_denoised": float(ssim3d(out_d, clean_d, data_range=drange)),
    }
    q["psnr_gain_db"] = q["psnr_denoised_db"] - q["psnr_noisy_db"]
    ok = q["ssim_denoised"] >= q["ssim_noisy"] and \
        q["psnr_gain_db"] >= MIN_PSNR_GAIN_DB
    if blosc_available():
        codec = BloscCodec(cname="zstd", clevel=6)
        q["cratio_noisy"] = compute_cratio(img, codec)
        q["cratio_denoised"] = compute_cratio(out, codec)
        q["cratio_gain"] = q["cratio_denoised"] / q["cratio_noisy"]
        ok = ok and q["cratio_gain"] >= MIN_CRATIO_GAIN
        print(f"cratio {q['cratio_noisy']} -> {q['cratio_denoised']} gain "
              f"{q['cratio_gain']:.4f} (>= {MIN_CRATIO_GAIN}; r05 "
              f"{REF_R05['cratio_gain']})")
    else:
        print("cratio: unavailable (libblosc not found)")
    print(f"psnr {q['psnr_noisy_db']:.4f} -> {q['psnr_denoised_db']:.4f} dB "
          f"gain {q['psnr_gain_db']:.4f} (>= {MIN_PSNR_GAIN_DB}; r05 "
          f"{REF_R05['psnr_gain_db']})")
    print(f"ssim {q['ssim_noisy']:.6f} -> {q['ssim_denoised']:.6f} "
          f"(not lower; r05 {REF_R05['ssim_denoised']})", flush=True)
    record["quality"] = q
    if not ok:
        fail(f"quality guard: {q}")

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_record.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)

    def total(key):
        return sum(c[key] for c in checks)

    t_ops = sum(c["bound_ms"] for c in checks if c["bound_by"] == "operations")
    kernels = [{
        "name": "nb_conv3d",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:358",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in checks),
        # Sums over the six checked main-path shapes, stats mode.
        "ms": total("ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": "operations" if t_ops >= total("bound_ms") / 2
        else "bytes",
        "library_ms": total("library_ms"),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
