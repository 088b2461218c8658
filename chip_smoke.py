#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (it builds the three kernels of
``exaspim_tpu_torch/csrc/`` for ``sm_90a`` into
``exaspim_tpu_torch/build/``, one nvcc process each, in parallel) and
exits non-zero without a card. Phases, each announced by a ``# phase:``
line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile all kernels, print the conv's seconds and ptxas report;
3. kernel vs plain: the Hopper conv against its plain PyTorch version on
   the card, at the inference path's conv shapes (batch 2), with and
   without the GroupNorm-statistics epilogue, plus its time beside the
   plain version's, cuDNN's (a yardstick only) and the card's bound;
4. main path: the shipped checkpoint denoises the 256³ bench block
   (``neurite_phantom(n_tubes=24, seed=0)``, ``noisy_observation(seed=1)``)
   through ``predict(..., patch_size="auto")``; the launch count shows
   every 3³ conv went through the kernel; then timed runs, a profile and
   a small-input check against the f32 CPU path;
5. quality: PSNR, SSIM and the blosc-zstd chunked ratio gain against the
   clean phantom, held to the repository's quality guard;
6. build (training kernels): the dL/dW and byte-histogram ptxas reports;
   then the synthetic caches of phase 10 (128 train + 32 val 64³ patches,
   seed 42, Gaussian teacher) are written under ``chip_smoke_work/``;
7. training-step kernels vs plain: one cached training step of the
   default configuration (batch 32 of 64³) is run once to record every
   kernel launch's shape; each conv shape (forward with statistics, and
   the backward's dL/dx in plain mode) and each dL/dW shape is then held
   against its plain version at batch 32 and timed beside it, cuDNN (a
   yardstick only) and the card's bound;
8. byte-histogram kernel vs plain on the byte planes of a validation
   batch (counts equal), beside one ``torch.bincount``;
9. gradient check, full-width bf16 UNet at 32³, batch 2: (a) each conv's
   backward against an independent f32 reference on the same saved
   inputs and cotangents; (b) whole-model gradients against the plain
   path on the CPU; (c) three planted backward faults, each of which (a)
   must catch;
10. training path: the port's ``train()`` at the default configuration
    (width 1.0, bf16, batch 32 of 64³, AdamW 1e-3, card-resident cache)
    for 12 steps with validations at 6 and 12 and the loss read every
    step; launch counts, loss trend, peak memory, a profile of two steps,
    the best checkpoint reloaded through ``restore_pipeline`` to denoise a
    48³ block; then the step time over a window: two ``train()`` runs of
    8 and 40 steps at the default ``log_every`` and ``val_every``, their
    wall-time difference over the 32 steps between them.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
WORK = os.path.join(ROOT, "chip_smoke_work")  # caches + runs, removed after
KERNELS = ("nb_conv3d", "nb_conv3d_dw", "byte_histogram")
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
# the largest value. The stats are f32 sums of the kernel's own rounded
# output, taken in another order than torch's.
OUT_RTOL = 2.0 ** -7
STATS_RTOL = 1e-3
# dL/dW kernel vs plain: both sum exact bf16 products in f32, in different
# orders; elementwise |Δ| must stay within 1e-3 of the same contraction
# taken over |x| and |g| (the sum's own rounding scale).
DW_RTOL = 1e-3
# Rounding of a bf16 result: at most half an ulp, 2^-8 of its value.
BF16_HALF_ULP = 2.0 ** -8
# Whole-model gradients (phase 9b): per-parameter relative L2 of the card's
# bf16 kernel path against the plain path on the CPU, with the same bf16
# roundings and in f32. These limits are not derived: they were set above
# the sound readings on an H100 (worst 0.073 against bf16, 0.108 against
# f32; PERF.md) after a first limit of 0.1 failed against f32. Sums taken
# in another order round to other bf16 values, and the differences grow
# through 18 layers. The per-conv check (9a), which needs no such margin,
# is what holds each backward to its reference; 9c reads both measures
# with faults planted.
GRAD_REL_L2_BF16 = 0.15
GRAD_REL_L2_F32 = 0.2
FAULTS = ("no stats fold", "dL/dx taps not flipped", "dL/dW tap 0 zeroed")
TRAIN_STEPS, VAL_EVERY, N_TRAIN, N_VAL, PATCH = 12, 6, 128, 32, 64
WINDOW_EPOCHS = (2, 10)  # of 4 steps: the step-time window is 32 steps

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


def shape_name(n, segs, cout):
    cin = "(" + "|".join(map(str, segs)) + ")" if len(segs) > 1 else segs[0]
    return f"{n}^3 {cin}->{cout}"


def bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_kernel(b, n, segs, cout, seed, stats=True):
    """Conv kernel vs plain version at one shape; the time is that of the
    mode the path runs (``stats``: a forward with GroupNorm statistics;
    else plain mode, as the backward's dL/dx runs it). Returns its record."""
    import torch
    import torch.nn.functional as F

    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_plain

    name = ("" if stats else "dx ") + shape_name(n, segs, cout)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cin = sum(segs)
    xs = tuple(torch.randn((b, n, n, n, c), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for c in segs)
    k = (torch.randn((27, cin, cout), generator=gen, device="cuda")
         / np.sqrt(27 * cin)).to(torch.bfloat16)
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
    # The statistics are the f32 sums of the kernel's own rounded output
    # (held to the plain version above). Against the plain version's
    # statistics they also carry the elements that rounded to the other
    # bf16 neighbour: shown, not held (64 voxels per (b, c) at 4³).
    own2 = (yf * yf).sum(dim=(1, 2, 3))
    e1 = float(((s1 - yf.sum(dim=(1, 2, 3))).abs()
                / yf.abs().sum(dim=(1, 2, 3)).clamp(min=1e-30)).max())
    e2 = float(((s2 - own2).abs() / own2.clamp(min=1e-30)).max())
    vs_plain = (float(((s1 - p1).abs() / pf.abs().sum(dim=(1, 2, 3))).max()),
                float(((s2 - p2).abs() / p2).max()))
    del yf, pf, py, y, y_plain_mode
    if e1 > STATS_RTOL or e2 > STATS_RTOL:
        fail(f"{name}: stats off (Σy {e1:.2e} of Σ|y|, Σy² {e2:.2e})")

    # Times: the kernel, the plain version, and one cuDNN call on the
    # pre-concatenated input.
    reps = 20 if n <= 48 else 10
    kernel_ms = cuda_ms(lambda: nb_conv3d(xs, k, with_stats=stats), reps)
    plain_ms = cuda_ms(lambda: nb_conv3d_plain(xs, k, with_stats=stats), 3)
    xcat = torch.cat(xs, -1).permute(0, 4, 1, 2, 3)  # channels_last_3d view
    wlib = k.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    library_ms = cuda_ms(lambda: F.conv3d(xcat, wlib, padding=1), reps)

    vox = b * n ** 3
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout
    nbytes += 8 * b * cout if stats else 0
    rec = {
        "shape": name, "batch": b, "max_abs_err": err,
        "rel_err": err / scale, "stats_err_s1": e1, "stats_err_s2": e2,
        "stats_vs_plain": vs_plain,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(flops, nbytes), "tflops": flops / kernel_ms / 1e9,
    }
    print(
        f"{name} B={b}: max|d|={err:.3e} (rel {err / scale:.2e} <= "
        f"{OUT_RTOL:.2e}) stats {e1:.1e}/{e2:.1e} <= {STATS_RTOL:.0e} "
        f"(vs plain's {vs_plain[0]:.1e}/{vs_plain[1]:.1e})  "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) {rec['tflops']:.1f} TFLOP/s",
        flush=True,
    )
    return rec


def check_dw(b, n, segs, cout, seed):
    """dL/dW kernel vs plain at one training shape; returns its record."""
    import torch

    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw, nb_conv3d_dw_plain

    name = "dw " + shape_name(n, segs, cout)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cin = sum(segs)
    xs = tuple(torch.randn((b, n, n, n, c), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for c in segs)
    g = torch.randn((b, n, n, n, cout), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.1
    got = nb_conv3d_dw(xs, g)
    again = nb_conv3d_dw(xs, g)
    plain = nb_conv3d_dw_plain(xs, g)
    scale = nb_conv3d_dw_plain(tuple(x.abs() for x in xs), g.abs())
    torch.cuda.synchronize()
    d = (got - plain).abs()
    err = float(d.max())
    rel = float((d / scale.clamp(min=1e-30)).max())
    if not torch.isfinite(got).all() or bool((d > DW_RTOL * scale).any()):
        fail(f"{name}: off by {err} (max |d|/scale {rel:.3e})")
    if not torch.equal(got, again):
        fail(f"{name}: two launches on the same inputs differ")
    reps = 20 if n <= 32 else 10
    kernel_ms = cuda_ms(lambda: nb_conv3d_dw(xs, g), reps)
    plain_ms = cuda_ms(lambda: nb_conv3d_dw_plain(xs, g), 3)
    xcl = torch.cat(xs, -1).permute(0, 4, 1, 2, 3)  # channels_last_3d views
    gcl = g.permute(0, 4, 1, 2, 3)
    w = torch.empty((cout, cin, 3, 3, 3), device="cuda", dtype=torch.bfloat16)
    library_ms = cuda_ms(lambda: torch.ops.aten.convolution_backward(
        gcl, xcl, w, None, [1, 1, 1], [1, 1, 1], [1, 1, 1], False,
        [0, 0, 0], 1, [False, True, False]), reps)
    vox = b * n ** 3
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2 * vox * (cin + cout) + 4 * 27 * cin * cout
    rec = {
        "shape": name, "batch": b, "max_abs_err": err, "rel_to_abs": rel,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(flops, nbytes), "tflops": flops / kernel_ms / 1e9,
    }
    print(f"{name} B={b}: max|d|={err:.3e} (max |d|/|x||g| {rel:.2e} <= "
          f"{DW_RTOL:.0e}, repeat bit-equal) kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"{rec['tflops']:.1f} TFLOP/s", flush=True)
    return rec


def check_histogram(vols):
    """Byte-histogram kernel vs plain on the byte planes of a batch of
    64³ count volumes (the rows one validation batch gives it)."""
    import torch

    from exaspim_tpu_torch.compression.proxy import (
        _byte_planes,
        _chunks,
        byte_histogram,
        byte_histogram_plain,
    )

    ch = _chunks(vols.to(torch.int32), 64)
    lo, hi = _byte_planes(ch)
    rows = torch.stack([lo, hi], dim=2).reshape(-1, lo[0, 0].numel())
    got = byte_histogram(rows)
    ref = byte_histogram_plain(rows)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        fail(f"byte_histogram: counts differ ({int((got != ref).sum())} bins)")
    n, length = rows.shape
    offs = rows.to(torch.int64) + 256 * torch.arange(
        n, device="cuda")[:, None]
    kernel_ms = cuda_ms(lambda: byte_histogram(rows), 50)
    plain_ms = cuda_ms(lambda: byte_histogram_plain(rows), 3)
    library_ms = cuda_ms(
        lambda: torch.bincount(offs.reshape(-1), minlength=256 * n), 20)
    nbytes = n * length + 4 * 256 * n
    rec = {"rows": n, "row_bytes": length, "max_abs_err": 0.0,
           "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": 1e3 * nbytes / PEAK_BYTES, "bound_by": "bytes"}
    print(f"byte_histogram {n} rows x {length} B: counts equal; "
          f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={library_ms:.4f} (one torch.bincount) "
          f"bound_ms={rec['bound_ms']:.4f} (bytes)", flush=True)
    return rec


@contextlib.contextmanager
def patched(**attrs):
    """Replace attributes of ``exaspim_tpu_torch.ops.nb_conv`` for the
    duration (the harness's shape recorder and planted faults)."""
    from exaspim_tpu_torch.ops import nb_conv

    old = {k: getattr(nb_conv, k) for k in attrs}
    for k, v in attrs.items():
        setattr(nb_conv, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(nb_conv, k, v)


def launch_shapes(run):
    """Run ``run()`` once; return how often it launched each conv and
    dL/dW shape: ``{(kind, batch, n, segs, cout): count}``, kind ``fwd``
    (stats mode), ``dx`` (plain mode: the backward's dL/dx) or ``dw``."""
    from exaspim_tpu_torch.ops import nb_conv

    seen = Counter()
    conv, launch_dw = nb_conv._conv, nb_conv._launch_dw

    def key(kind, xs, cout):
        b, n = xs[0].shape[:2]
        return kind, b, n, tuple(x.shape[-1] for x in xs), cout

    def spy_conv(xs, k, with_stats):
        seen[key("fwd" if with_stats else "dx", xs, k.shape[-1])] += 1
        return conv(xs, k, with_stats)

    def spy_dw(xs, g):
        seen[key("dw", xs, g.shape[-1])] += 1
        return launch_dw(xs, g)

    with patched(_conv=spy_conv, _launch_dw=spy_dw):
        run()
    return seen


@contextlib.contextmanager
def recorded_backward(records, fault=None):
    """Record every conv backward (saved tensors, cotangents, results)
    into ``records``, with ``fault`` (one of ``FAULTS``, or None) planted
    in the port's backward for the duration."""
    import torch

    from exaspim_tpu_torch.ops import nb_conv

    fn = nb_conv._Conv3d
    orig = fn.__dict__["backward"]
    backward = orig.__func__
    attrs = {}
    if fault == "dL/dx taps not flipped":
        conv = nb_conv._conv
        attrs["_conv"] = lambda xs, k, with_stats: conv(
            xs, k if with_stats else k.flip(0).contiguous(), with_stats)
    elif fault == "dL/dW tap 0 zeroed":
        launch_dw = nb_conv._launch_dw

        def zero_tap0(xs, g):
            out = launch_dw(xs, g)
            out[0] = 0.0
            return out
        attrs["_launch_dw"] = zero_tap0
    elif fault not in (None, "no stats fold"):
        raise ValueError(f"unknown fault {fault!r}")

    def spy(ctx, g_y, g_s1=None, g_s2=None):
        saved = ctx.saved_tensors
        grads = (g_y, g_s1, g_s2)
        if fault == "no stats fold" and ctx.with_stats:
            g_s1, g_s2 = torch.zeros_like(g_s1), torch.zeros_like(g_s2)
        out = backward(ctx, g_y, g_s1, g_s2)
        records.append((ctx.with_stats, saved, grads, out))
        return out

    fn.backward = staticmethod(spy)
    try:
        with patched(**attrs):
            yield
    finally:
        fn.backward = orig


def conv_vjp(x, k, g):
    """``(dL/dx, dL/dW)`` of the 3³ SAME conv in f32 by autograd of
    ``F.conv3d``: x ``(B, D, H, W, Cin)``, taps ``(27, Cin, Cout)``, g
    ``(B, D, H, W, Cout)``."""
    import torch
    import torch.nn.functional as F

    cin, cout = k.shape[1:]
    xt = x.permute(0, 4, 1, 2, 3).detach().requires_grad_()
    w = k.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2)
    w = w.detach().requires_grad_()
    with torch.enable_grad():
        out = F.conv3d(xt, w, padding=1)
        dx, dw = torch.autograd.grad(out, (xt, w), g.permute(0, 4, 1, 2, 3))
    return dx.permute(0, 2, 3, 4, 1), dw.permute(2, 3, 4, 1, 0).reshape(
        27, cin, cout)


def conv_backward_errors(records):
    """Each recorded conv backward against an independent f32 reference on
    the same saved inputs and cotangents: the stats cotangents folded into
    g and g rounded to the compute dtype, as the algorithm specifies, then
    autograd of ``F.conv3d``. Elementwise allowance: the result's own bf16
    rounding (half an ulp) plus ``DW_RTOL`` of the same contraction over
    |·| (f32 sums in another order). Returns, per conv, the largest
    |Δ| / allowance of dL/dx and of dL/dW (≤ 1 passes) and their relative
    L2 errors."""
    import torch

    rows = []
    for with_stats, saved, (g_y, g_s1, g_s2), out in records:
        k, *xs = saved
        g = g_y.float()
        if with_stats:
            y = xs.pop()
            g = (g + g_s1.float()[:, None, None, None, :]
                 + 2.0 * y.float() * g_s2.float()[:, None, None, None, :])
        g = g.to(xs[0].dtype).float()
        x = torch.cat([t.float() for t in xs], -1)
        ref = conv_vjp(x, k.float(), g)
        mag = conv_vjp(x.abs(), k.float().abs(), g.abs())

        def reading(got, r, m):
            d = (got.float() - r).abs()
            allow = (BF16_HALF_ULP * r.abs() + DW_RTOL * m).clamp(min=1e-30)
            return (float((d / allow).max()),
                    float(d.norm() / r.norm().clamp(min=1e-30)))

        row = {"shape": shape_name(x.shape[1], [t.shape[-1] for t in xs],
                                   k.shape[-1]),
               "dx": None, "dx_rel_l2": None, "dw": None, "dw_rel_l2": None}
        if out[1] is not None:
            row["dw"], row["dw_rel_l2"] = reading(out[1], ref[1], mag[1])
        o = 0
        for i, t in enumerate(xs):
            c = t.shape[-1]
            if out[2 + i] is not None:
                r, l2 = reading(out[2 + i], ref[0][..., o:o + c],
                                mag[0][..., o:o + c])
                row["dx"] = max(r, row["dx"] or 0.0)
                row["dx_rel_l2"] = max(l2, row["dx_rel_l2"] or 0.0)
            o += c
        rows.append(row)
    return rows


def worst(rows, key):
    vals = [(r[key], r["shape"]) for r in rows if r[key] is not None]
    return max(vals)


def grad_check():
    """Phase 9 (see the module docstring)."""
    import torch

    from exaspim_tpu_torch.losses import signal_preserving_loss
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw

    rng = np.random.default_rng(9)
    x = rng.normal(0.3, 0.1, (2, 32, 32, 32, 1)).astype(np.float32)
    y = (0.9 * x + rng.normal(0.0, 0.02, x.shape)).astype(np.float32)
    kw = dict(width_multiplier=1.0, head_init="normal")
    card = UNet(dtype=torch.bfloat16, **kw).init_weights(7).cuda()

    def grads(model, dev, fault=None, records=None):
        model.zero_grad(set_to_none=True)
        ctx = (recorded_backward(records, fault) if records is not None
               else contextlib.nullcontext())
        with ctx:
            loss = signal_preserving_loss(
                model(torch.from_numpy(x).to(dev)),
                torch.from_numpy(y).to(dev), 0.0, fg_weight=0.0)
            loss.backward()
        return loss.item(), {k: p.grad.float().cpu()
                             for k, p in model.named_parameters()}

    def rel_l2(g_got, g_ref):
        return {k: float((g_got[k] - g_ref[k]).norm()
                         / g_ref[k].norm().clamp(min=1e-30)) for k in g_ref}

    # (a) the sound backward, conv by conv.
    records = []
    c0, d0 = nb_conv3d.launches, nb_conv3d_dw.launches
    loss_card, g_card = grads(card, "cuda", records=records)
    launches = (nb_conv3d.launches - c0, nb_conv3d_dw.launches - d0)
    if launches != (35, 18):
        fail(f"one training step launched {launches}, expected (35, 18)")
    rows = conv_backward_errors(records)
    del records
    wdx, wdw = worst(rows, "dx"), worst(rows, "dw")
    print(f"(a) {len(rows)} conv backwards vs f32 reference on the same "
          f"inputs and cotangents: worst |d|/allowance dL/dx {wdx[0]:.3f} "
          f"({wdx[1]}), dL/dW {wdw[0]:.3f} ({wdw[1]}) (limit 1); worst rel "
          f"L2 dL/dx {worst(rows, 'dx_rel_l2')[0]:.2e}, dL/dW "
          f"{worst(rows, 'dw_rel_l2')[0]:.2e}", flush=True)
    if max(wdx[0], wdw[0]) > 1.0:
        fail(f"a conv backward strays from its reference: {rows}")
    out = {"loss_card": loss_card, "launches": launches, "per_conv": rows}

    # (b) whole-model gradients against the plain path on the CPU.
    refs = {}
    for name, dtype, limit in (("bf16", torch.bfloat16, GRAD_REL_L2_BF16),
                               ("f32", torch.float32, GRAD_REL_L2_F32)):
        cpu = UNet(dtype=dtype, **kw)
        cpu.load_state_dict(card.state_dict())
        loss_cpu, refs[name] = grads(cpu, "cpu")
        rel = rel_l2(g_card, refs[name])
        top = sorted(rel.items(), key=lambda kv: -kv[1])
        print(f"(b) vs CPU plain {name}: loss card {loss_card:.6f} cpu "
              f"{loss_cpu:.6f}; per-parameter rel L2: median "
              f"{float(np.median(list(rel.values()))):.3e}, worst "
              + ", ".join(f"{k} {v:.3e}" for k, v in top[:3])
              + f" (limit {limit})", flush=True)
        if top[0][1] > limit:
            fail(f"gradient {top[0][0]} off by rel L2 {top[0][1]:.3e} "
                 f"against the {name} plain path")
        out[name] = {"loss_cpu": loss_cpu, "rel_l2": rel}

    # (c) planted faults: (a) must catch each; (b)'s readings are shown.
    out["faults"] = {}
    for fault in FAULTS:
        records = []
        _, g_bad = grads(card, "cuda", fault, records)
        rows = conv_backward_errors(records)
        del records
        wdx, wdw = worst(rows, "dx"), worst(rows, "dw")
        whole = {name: max(rel_l2(g_bad, refs[name]).items(),
                           key=lambda kv: kv[1]) for name in refs}
        caught = max(wdx[0], wdw[0]) > 1.0
        print(f"(c) planted '{fault}': (a) worst |d|/allowance dL/dx "
              f"{wdx[0]:.3g} ({wdx[1]}), dL/dW {wdw[0]:.3g} ({wdw[1]}) -> "
              f"{'caught' if caught else 'MISSED'}; (b) worst rel L2 vs "
              f"bf16 {whole['bf16'][1]:.3f} ({whole['bf16'][0]}; "
              f"{'above' if whole['bf16'][1] > GRAD_REL_L2_BF16 else 'below'}"
              f" {GRAD_REL_L2_BF16}), vs f32 {whole['f32'][1]:.3f} "
              f"({whole['f32'][0]}; "
              f"{'above' if whole['f32'][1] > GRAD_REL_L2_F32 else 'below'} "
              f"{GRAD_REL_L2_F32})", flush=True)
        out["faults"][fault] = {"dx": wdx, "dw": wdw, "whole": whole}
        if not caught:
            fail(f"the per-conv check missed the planted fault '{fault}'")
    print(f"launches of one step {launches} (expected (35, 18))", flush=True)
    return out


def make_caches(transform_cfg):
    from exaspim_tpu_torch.data.synthetic import make_synthetic_cache

    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.time()
    dirs = []
    for split, n, seed in (("train", N_TRAIN, 42), ("val", N_VAL, 43)):
        d = os.path.join(WORK, split)
        make_synthetic_cache(d, n, (PATCH,) * 3, transform_cfg, seed=seed)
        dirs.append(d)
    print(f"caches: {N_TRAIN} train + {N_VAL} val {PATCH}^3 patches in "
          f"{time.time() - t0:.1f} s", flush=True)
    return dirs


def cached_step(train_dir, state, transform):
    """One cached training step (the first 32 patches of the train cache)
    of the default configuration, as ``Trainer.run`` makes it."""
    import torch

    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.data.loader import to_tensor
    from exaspim_tpu_torch.train.state import make_cached_train_step

    ds = CachedPatchDataset(train_dir)
    raw = to_tensor(np.asarray(ds._raw[0]), "cuda")
    teacher = to_tensor(np.asarray(ds._teacher[0]), "cuda")
    step_fn = make_cached_train_step(0.0, transform=transform,
                                     patch_shape=(PATCH,) * 3)
    idx = torch.arange(32, device="cuda")
    return lambda: step_fn(state, raw, teacher, None, idx)


def per_step(recs, counts):
    """Sums over one run of the path: each shape's record weighted by its
    launches in that run."""
    tot = {k: sum(c * r[k] for c, r in zip(counts, recs))
           for k in ("ms", "plain_ms", "bound_ms", "library_ms")}
    ops = sum(c * r["bound_ms"] for c, r in zip(counts, recs)
              if r["bound_by"] == "operations")
    return {"max_abs_err": max(r["max_abs_err"] for r in recs), **tot,
            "bound_by": "operations" if ops >= tot["bound_ms"] / 2
            else "bytes"}


def training_step_kernels(train_dir, transform):
    """Phase 7: record one training step's launch shapes, then check and
    time each. Returns the conv and dL/dW records with their launches per
    step."""
    import torch

    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.state import create_train_state

    state = create_train_state(
        UNet(width_multiplier=1.0, dtype=torch.bfloat16).cuda(), lr=1e-3,
        total_steps=TRAIN_STEPS, seed=42)
    run = cached_step(train_dir, state, transform)
    shapes = launch_shapes(lambda: (run(), torch.cuda.synchronize()))
    del run, state
    kinds = Counter()
    for (kind, *_), c in shapes.items():
        kinds[kind] += c
    print(f"one step launched fwd {kinds['fwd']}, dL/dx {kinds['dx']}, "
          f"dL/dW {kinds['dw']} times at {len(shapes)} shapes", flush=True)
    if (kinds["fwd"], kinds["dx"], kinds["dw"]) != (18, 17, 18):
        fail(f"one training step launched {dict(kinds)}, expected fwd 18, "
             "dx 17, dw 18")
    conv, dw = {"recs": [], "counts": []}, {"recs": [], "counts": []}
    with torch.no_grad():
        for i, ((kind, b, n, segs, cout), c) in enumerate(
                sorted(shapes.items())):
            if kind == "dw":
                dw["recs"].append(check_dw(b, n, segs, cout, seed=i))
                dw["counts"].append(c)
            else:
                conv["recs"].append(check_kernel(b, n, segs, cout, seed=i,
                                                 stats=kind == "fwd"))
                conv["counts"].append(c)
            torch.cuda.empty_cache()
    for name, d in (("nb_conv3d", conv), ("nb_conv3d_dw", dw)):
        s = per_step(d["recs"], d["counts"])
        print(f"{name} per training step ({sum(d['counts'])} launches): "
              f"kernel {s['ms']:.3f} ms, plain {s['plain_ms']:.3f} ms, "
              f"library {s['library_ms']:.3f} ms, bound {s['bound_ms']:.3f} "
              f"ms ({s['bound_by']})", flush=True)
    return conv, dw


def training_path(train_dir, val_dir):
    """The port's train() at the default configuration; returns the
    record and the launch counts of the counted run."""
    import torch

    from exaspim_tpu_torch.compression import best_codec
    from exaspim_tpu_torch.compression.proxy import byte_histogram
    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train.checkpoint import (
        find_best_checkpoint,
        restore_pipeline,
    )
    from exaspim_tpu_torch.train.train_bm4dnet import train

    try:
        best_codec()
        n_exact = 16
    except RuntimeError as exc:
        n_exact = 0
        print(f"exact cratio: not measured ({exc})", flush=True)
    cfg = dict(batch_size=32, lr=1e-3, fg_weight=0.0, seed=42,
               width_multiplier=1.0, bf16=True, device_cache=True,
               exact_cratio_examples=n_exact, device="cuda")
    epochs = TRAIN_STEPS // (N_TRAIN // 32)
    torch.cuda.reset_peak_memory_stats()
    nb_conv3d.launches = nb_conv3d_dw.launches = byte_histogram.launches = 0
    t0 = time.perf_counter()
    trainer = train([train_dir], [val_dir], os.path.join(WORK, "run"),
                    epochs=epochs, val_every=VAL_EVERY, log_every=1, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nb_conv3d": nb_conv3d.launches,
                "nb_conv3d_dw": nb_conv3d_dw.launches,
                "byte_histogram": byte_histogram.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_val = 2 * (-(-N_VAL // 32))  # validations x batches
    want = {"nb_conv3d": 35 * TRAIN_STEPS + 18 * n_val,
            "nb_conv3d_dw": 18 * TRAIN_STEPS, "byte_histogram": n_val}
    print(f"train(): {TRAIN_STEPS} steps + 2 validations in {wall:.2f} s; "
          f"launches {launches} (expected {want}); peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)
    if launches != want:
        fail(f"training launches {launches}, expected {want}")

    with open(trainer._log_path) as f:
        events = [json.loads(line) for line in f]
    train_ev = [e for e in events if e["event"] == "train"]
    losses = [e["loss"] for e in train_ev]
    step_s = [e["step_time_s"] for e in train_ev if "step_time_s" in e]
    vals = [e for e in events if e["event"] == "val"]
    med = float(np.median(step_s))
    print(f"losses {losses}", flush=True)
    print(f"median gap between steps {med:.4f} s (host clock, the loss read "
          f"every step: a per-layer figure); validations "
          + "; ".join(f"step {v['step']} loss {v['val_loss']:.5f} score "
                      f"{v['val_score']:.4f} proxy "
                      f"{v['val_cratio_proxy']:.4f} cratio {v['val_cratio']}"
                      for v in vals), flush=True)
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        fail(f"training losses not finite: {losses}")
    if not np.mean(losses[-3:]) < losses[0]:
        fail(f"the loss did not fall: {losses}")
    if len(vals) != 2 or not all(np.isfinite(v["val_score"]) for v in vals):
        fail(f"validations: {vals}")

    phase("training path: profile of two steps")
    run = cached_step(train_dir, trainer.state, trainer.transform)
    run()
    prof = profile_once(lambda: [run() for _ in range(2)], key="nb_conv3d")
    del run

    phase("training path: best checkpoint -> restore_pipeline -> predict")
    best = find_best_checkpoint(trainer.ckpt_dir)
    del trainer
    model, transform = restore_pipeline(best, dtype=torch.bfloat16,
                                        device="cuda")
    block = np.asarray(CachedPatchDataset(train_dir)._raw[0][0][:48, :48, :48])
    out = predict(block, model, transform, patch_size="auto", overlap=OVERLAP,
                  trim=TRIM)
    dev = np.abs(out.astype(np.float64) - block.astype(np.float64))
    print(f"{os.path.basename(best)}: 48^3 denoised, mean |out - raw| "
          f"{dev.mean():.3f} counts", flush=True)
    if out.shape != block.shape or out.dtype != np.uint16 or not out.any():
        fail(f"restored checkpoint output {out.shape} {out.dtype}")
    del model

    phase("training path: step time over a window (default log_every)")
    # Two train() runs at the default log_every (50: the loss is read once,
    # at the last step) and val_every (1000: one validation, after the last
    # step). Set-up, the validation and the checkpoint are the same in both,
    # so the wall-time difference is that of the extra steps, each dispatched
    # without a host sync as the default configuration runs them.
    walls = []
    for e in WINDOW_EPOCHS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        train([train_dir], [val_dir], os.path.join(WORK, f"window{e}"),
              epochs=e, **cfg)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    steps = (N_TRAIN // 32) * (WINDOW_EPOCHS[1] - WINDOW_EPOCHS[0])
    window_s = (walls[1] - walls[0]) / steps
    print(f"train() walls {walls[0]:.4f} s ({WINDOW_EPOCHS[0]} epochs) and "
          f"{walls[1]:.4f} s ({WINDOW_EPOCHS[1]} epochs): {window_s:.4f} s "
          f"per step over the {steps} steps between them, "
          f"{32 * PATCH ** 3 / window_s:.1f} voxels/s", flush=True)
    if not 0 < window_s < 10 * med:
        fail(f"window step time {window_s} s against gaps of {med} s")
    return {
        "wall_s": wall, "launches": launches, "peak_mem_gb": peak_gb,
        "losses": losses, "step_gap_s": step_s, "median_step_gap_s": med,
        "window_walls_s": walls, "window_steps": steps,
        "step_s": window_s, "voxels_per_s": 32 * PATCH ** 3 / window_s,
        "validations": vals, "profile": prof,
        "best_checkpoint": os.path.basename(best),
        "restored_mean_abs_change": dev.mean(),
    }


def print_ptxas(build, name):
    for line in build.build_log(name).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())


def profile_once(run, key="nb_conv3d_kernel"):
    """Device time by kernel over one run of ``run`` (torch.profiler);
    ``key`` names the kernels whose share is printed."""
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
    conv_s = sum(r[0] for r in rows if key in r[1]) / 1e6
    print(f"profile: wall {wall:.4f} s, device busy {busy_s:.4f} s "
          f"(idle share {max(0.0, 1 - busy_s / wall):.3f}), of which "
          f"{key} kernels {conv_s:.4f} s")
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
    build_s = _build.build_all(KERNELS)
    record["build_s"] = time.time() - t0
    print(f"build_s={record['build_s']:.2f} (all three kernels, in parallel; "
          f"nb_conv3d {build_s['nb_conv3d']:.2f})", flush=True)
    print_ptxas(_build, "nb_conv3d")

    phase("kernel vs plain")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [
        (2, 96, (1,), 32),
        (2, 96, (32,), 32),
        (2, 96, (32, 32), 32),
        (2, 48, (64, 64), 64),
        (2, 12, (256, 256), 256),
        (2, 6, (256,), 256),
    ]
    with torch.no_grad():
        checks = [check_kernel(*s, seed=i) for i, s in enumerate(shapes)]
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
    del model, cpu_model, clean_d, noisy_d, out_d
    torch.cuda.empty_cache()

    phase("build (training kernels)")
    for name in KERNELS[1:]:
        print(f"{name}: built in {build_s[name]:.2f} s (with phase 2)")
        print_ptxas(_build, name)
    from exaspim_tpu_torch.train.checkpoint import load_checkpoint
    from exaspim_tpu_torch.transforms import build_transform

    transform_cfg = load_checkpoint(CKPT)["transform"]
    train_dir, val_dir = make_caches(transform_cfg)

    phase("training-step kernels vs plain (batch 32, 64^3)")
    conv_train, dw_train = training_step_kernels(
        train_dir, build_transform(transform_cfg))
    record["train_conv_checks"] = conv_train
    record["dw_checks"] = dw_train

    phase("histogram kernel vs plain")
    from exaspim_tpu_torch.data.cache import CachedValidateDataset
    from exaspim_tpu_torch.data.loader import counts_f32, to_tensor

    val_raw = to_tensor(np.asarray(CachedValidateDataset(val_dir)._raw[0]),
                        "cuda")
    hist = check_histogram(counts_f32(val_raw).to(torch.int32))
    record["histogram_check"] = hist
    del val_raw

    phase("gradient check: full-width UNet 32^3 B=2")
    record["grad_check"] = grad_check()

    phase("training path: train() at the default configuration")
    record["train"] = training_path(train_dir, val_dir)
    shutil.rmtree(WORK, ignore_errors=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_record.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)

    # Each record reads one path. Training: launches of the counted train()
    # run; ms and bounds summed over one training step's launches (phase 7).
    # Inference: launches of one 256³ block; ms and bounds summed over the
    # six conv shapes of phase 3, each once.
    runs = record["train"]["launches"]
    kernels = [{
        "name": "nb_conv3d",
        "path": "training",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:358",
        "launches": runs["nb_conv3d"],
        **per_step(conv_train["recs"], conv_train["counts"]),
    }, {
        "name": "nb_conv3d_dw",
        "path": "training",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d_dw.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:448",
        "launches": runs["nb_conv3d_dw"],
        **per_step(dw_train["recs"], dw_train["counts"]),
    }, {
        "name": "byte_histogram",
        "path": "training",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/byte_histogram.cu",
        "replaces": "exaspim_tpu/compression/proxy.py:58",
        "launches": runs["byte_histogram"],
        **per_step([hist], [1]),
    }, {
        "name": "nb_conv3d (inference path)",
        "path": "inference",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:358",
        "launches": record["launches_per_block"],
        **per_step(checks, [1] * len(checks)),
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
