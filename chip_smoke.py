#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card and ``nvcc`` (it builds the seven kernel sources of
``exaspim_tpu_torch/csrc/`` for ``sm_90a`` into
``exaspim_tpu_torch/build/``, one nvcc process each, in parallel) and
exits non-zero without a card. Phases, each announced by a ``# phase:``
line:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: compile all kernels, print the conv's seconds and ptxas report
   (no register spills allowed in the three conv sources: ``nb_conv3d``,
   ``nb_conv3d_dw``, ``blocked_conv3d``);
3. kernel vs plain: the Hopper conv against its plain PyTorch version on
   the card, at every conv shape of phase 4's path at its own batch (9)
   and at six of its shapes at batch 2, the fixed comparison set
   (``nb_bench.INFERENCE_SHAPES``), with and without the
   GroupNorm-statistics epilogue: two launches bit-equal, two elements
   launched alone as a smaller batch bit-equal to their slots, a planted
   descriptor fault caught, plus its time beside the plain version's,
   cuDNN's (a yardstick only) and the card's bound, and the wrapper's host
   time per launch; then edge shapes (extents no multiple of the tile,
   narrow and odd widths, Cout = 8), checked, not timed;
4. main path: the shipped checkpoint denoises the 256³ bench block
   (``neurite_phantom(n_tubes=24, seed=0)``, ``noisy_observation(seed=1)``)
   through ``predict(..., patch_size="auto")``; the launch counts (conv and
   its statistics' reduce) show every 3³ conv went through the kernel, and
   the tile plans it ran are exactly those phase 3 checked; then timed
   runs, a profile and a small-input check against the f32 CPU path;
5. quality: PSNR, SSIM and the blosc-zstd chunked ratio gain against the
   clean phantom, scored through the port's quality check
   (``ckpt_quality.score``) and held to the repository's quality guard
   (no exact codec on the card's machine: PSNR and SSIM); beside it, not in
   it, the entropy-proxy ratio of noisy and denoised and their gain from
   one ``chunk_byte_histograms`` launch on the pair;
6. build (training kernels): the dL/dW and byte-histogram ptxas reports;
   then the synthetic caches of phase 10 (128 train + 32 val 64³ patches,
   seed 42, Gaussian teacher) are written under ``chip_smoke_work/``;
7. training-step kernels vs plain: one cached training step of the
   default configuration (batch 32 of 64³) is run once to record every
   kernel launch's shape; each conv shape (forward with statistics, and
   the backward's dL/dx in plain mode) and each dL/dW shape is then held
   against its plain version at batch 32 (two launches bit-equal, a
   planted dL/dW tap fault caught) and timed beside it, cuDNN's
   ``convolution_backward`` (a yardstick only) and the card's bound;
8. byte-histogram kernel vs plain: both entries (``byte_histogram`` on
   rows, ``chunk_byte_histograms`` on count volumes) at every case of
   ``ops/hist_bench.edge_cases`` (one repeated byte, uniform bytes, the hi
   and lo planes of a noisy phantom, the uint16 wrap, lengths no multiple
   of 16, a 27³ chunk, more than 65,535 rows, a misaligned base), on a
   validation batch and on phase 4's 256³ pair: counts equal, two launches
   bit-equal, one call one kernel (the call captured in a CUDA graph holds
   one kernel node: no memset, no conversion, no copy); graph and wrapper
   times beside the plain version's, one ``torch.bincount`` and the bound;
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
    wall-time difference over the 32 steps between them;
10b. width 0.3 (conv widths 9, 19, 38, 76): phase 9's per-conv and
    whole-model gradient checks at that width (no planted faults), one
    cached training step (35 conv + 18 dL/dW launches, every parameter
    updated) and ``predict`` of a 48³ phantom block (linear transform)
    against the plain path on the card in bf16 and the f32 CPU path, every
    conv counted on the kernels;
11. BM4D matching vs plain at the default parameters (block 4, step 3,
    search 9, group 16): the fused kernel's starts (``match_topk``, one
    launch) equal to the plain version's, member 0 the reference, on a
    64³ raw patch, on its stage-1 estimate, on a 128³ volume (padded to
    130³) and on a batch of three 64³ patches; on the three volumes also
    its two halves alone, the distance table (bit-equal) and the
    selection over it; each timed beside its plain version and the
    card's bound, the selection also beside one ``torch.topk``; then the
    fused kernel's ms per patch in the teacher path's batches of 8;
12. teacher path: ``precompute(split="val", n=16)`` at its defaults writes
    a cache of 64³ patches with BM4D teachers; launches counted (one
    fused launch per stage of a batch of 8: 4), the cache reopened,
    teachers held against the clean phantoms and against per-volume
    ``bm4d`` of each patch, two card runs (a batch, and patch 0 alone)
    bit-equal, patch 0 against the CPU path, then ``bm4d_batch`` seconds
    per patch in batches of 8 and a profile of one such call (its idle
    share);
13. asinh kernels vs plain on the 256³ block of phase 4 (uint16 → f32 and
    back), beside ``AsinhTransform`` and the bytes bound;
14. blocked conv vs plain: ``blocked_conv3d`` (the shared-memory halo-tile
    kernel) against its plain version at the conv bench's three shapes,
    32→64 and 64→32 at 32³, a small plane and a volume that is no multiple
    of the kernel's tile (batch 2); dL/dx and dL/dW against an f32
    reference; one planted fault (unflipped dL/dx taps) that the check must
    catch; then, at batch 32 (the conv bench's grid), the output held
    against the plain version again and its time beside the plain
    version's, cuDNN's and the bound;
15. conv bench: ``nb_bench.main`` at batch 32 (cuDNN, ``blocked_conv3d``,
    ``nb_conv3d``; 16 chained applications, CUDA events), launches counted;
16. pipeline: a 512³ uint16 volume (phase 4's noisy block mirror-tiled)
    through ``denoise_volume`` at the defaults (two z slabs) and with
    ``max_block_voxels`` forcing y/x super-tiles, each held against one
    direct ``predict`` of the whole volume: bit-equal, with a pointwise
    model and with the shipped checkpoint, and two direct runs bit-equal;
    seconds, voxels/s, the device-only block rate, conv and reduce
    launches, the idle share of one streamed run, peak device memory;
17. evaluation: with an exact codec, ``SupervisedEvaluator.run`` on two
    128³ crops and ``UnsupervisedEvaluator.run`` on four 64³ voxels;
    without one, the codec-free half on the same four voxels (BM4D ground
    truth, ``predict_patch``, SSIM, MAE, L∞); fused matcher launches
    counted (two per ground truth);
18. demo: ``demo_end_to_end.main`` at its defaults (256 train and 16 val
    64³ patches with BM4D teachers, 8 epochs at batch 16, width 1.0, bf16,
    the held-out 128³ block), the loss read every step for the trend
    guard; stage seconds, the summary, the counted launches of
    ``match_topk``, ``nb_conv3d`` (and its reduce), ``nb_conv3d_dw`` and
    ``chunk_byte_histograms`` during the run, peak device memory. Fails
    unless the losses are finite and fall, PSNR and SSIM are finite, the
    proxy gain is finite and above 1, and each of the four kernels
    launched; the guard's thresholds are not claimed at this size;
19. resume and augmentation on phase 18's caches: ``train()`` for 2
    epochs straight (twice: the card's own run-to-run spread), against 1
    epoch that writes ``latest_state.ckpt`` and is stopped there, then
    ``Trainer.run(resume_state=)`` for the second epoch: final params within
    ``RESUME_ATOL`` (the max |Δ| and whether bit-equal printed); one
    ``augment=True`` run of an epoch whose applied orientation codes
    equal ``orientation_code(seed, step)`` and whose losses are finite;
20. reference checkpoints: four files in the upstream reference's torch
    format written with ``torch.save`` (the shipped weights with zero conv
    biases as a dict and as a legacy bare state dict, the same with
    seeded conv biases, and a width-1.0 transposed-conv UNet with seeded
    weights and biases) go through ``import_torch_checkpoint``; the dict
    and legacy files import to equal parameters; every conv shape of the
    four models at the 256³ block's tile plan is recorded and each shape
    phase 3 did not hold is held as phase 3 holds its own; the biased and
    the transposed-conv model ``predict`` the block (54 conv and 54
    reduce launches each, the median of three calls, peak memory) and a
    48³ crop against the plain path on the card and the f32 CPU path
    (phase 10b's limits); the shipped net under the reference's
    ``align_corners=True`` grid is scored beside phase 5, not gated;
21. N2V: one ``make_n2v_train_step`` step (batch 4 of 64³, width-0.5
    N2V2UNet) on the card against the same step on the CPU in f32 from
    the same parameters and key, plain and σ-aware: blind spots bit-equal,
    loss, whole gradient and updated parameters within the stated limits;
    every conv and dL/dW shape of one step at the script's batch (16 of
    64³) held and timed as phase 7 holds its own; then ``train_n2v.main`` for 300 steps on 128 patches (its other flags
    at the JAX script's defaults), counted: 35 conv and 18 dL/dW launches
    a step, 72 conv launches of the held-out predict, one histogram
    launch; losses finite and falling, scores finite, ``step_s``.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Any failure exits non-zero before it.
"""

import contextlib
import glob
import json
import os
import re
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
KERNELS = ("nb_conv3d", "nb_conv3d_dw", "byte_histogram", "bm4d_match",
           "bm4d_select", "asinh_transform", "blocked_conv3d")
BLOCK, OVERLAP, TRIM = 256, 12, 5

# The quality guard of bench.py (quality_ok), with the same limits.
MIN_CRATIO_GAIN = 1.9
MIN_PSNR_GAIN_DB = 8.0
# The JAX package's record on the same block (BENCH_r05.json), shown as
# information beside this run's numbers.
REF_R05 = {"cratio_gain": 2.025, "psnr_gain_db": 9.72, "ssim_denoised": 0.9999}

# H100 SXM published dense peaks (NVIDIA data sheet) for the bound.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# Kernel vs plain: both round one f32 sum to bf16, in different orders, so
# an element may differ by one bf16 ulp (2^-8 relative): allow two ulps of
# the largest value. The stats are f32 sums of the kernel's own rounded
# output, taken in another order than torch's.
OUT_RTOL = 2.0 ** -7
STATS_RTOL = 1e-3
# dL/dW kernel vs plain: both sum exact bf16 products in f32, in different
# orders; elementwise |Δ| must stay within DW_RTOL of the same contraction
# taken over |x| and |g| (the sum's own rounding scale). Set between the
# readings on an H100 (PERF.md): sound launches at most 4.8e-7 at a
# training step's shapes, the weakest planted fault (tap 0 reads tap 1's
# view) 1.9e-3.
DW_RTOL = 1e-5
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
# Width-0.3 predict (phase 10c): relative L2 of the model's change to its
# input, the card's kernel path against the plain path on the card in bf16
# (the same roundings, sums in other orders) and against the f32 CPU path.
# About three times the readings on an H100 (5.7e-3 and 7.9e-3; PERF.md).
WIDTH_PREDICT_REL_BF16 = 0.018
WIDTH_PREDICT_REL_F32 = 0.024
FAULTS = ("no stats fold", "dL/dx taps not flipped", "dL/dW tap 0 zeroed")
TRAIN_STEPS, VAL_EVERY, N_TRAIN, N_VAL, PATCH = 12, 6, 128, 32, 64
# BM4D at the defaults of precompute(): block, group, step, search, sigma.
BM_B, BM_K, BM_STEP, BM_W, BM_SIGMA = 4, 16, 3, 9, 24.0
N_TEACHERS, TEACHER_SEED = 16, 42
# The match kernel and its plain version do the same f32 operations in the
# same order, so the tables are expected bit-equal; an entry may differ by
# one bf16 ulp only where a compiler reorders an f32 sum across a rounding
# boundary. The fused kernel's starts must equal the plain version's.
TABLE_MAX_ULPS = 1
# Card vs CPU teacher, and batched vs per-volume teachers on the card: the
# groups are equal; f32 sums in another order (the CPU's, or a library
# call's at another batch size) may flip a coefficient at the 2.7 sigma
# threshold or a count at a .5 boundary.
TEACHER_MAX_COUNTS, TEACHER_MAX_SHARE = 1, 1e-3
# asinh forward vs the plain log form: logf and sqrtf against torch's, a
# few f32 ulps; against AsinhTransform (true asinh) the log-form identity.
ASINH_MAX_ULPS, ASINH_ATOL, ASINH_INV_SHARE = 4, 1e-6, 1e-3
WINDOW_EPOCHS = (2, 10)  # of 4 steps: the step-time window is 32 steps
# Blocked conv check (phase 14), (B, D, H, W, Cin, Cout): the bench's three
# shapes, the two channel changes, a plane with H/2·W/2 < 256, and a volume
# whose extents are even but no multiple of the kernel's 4 x 4 x 8 tile.
BLOCKED_SHAPES = ((2, 64, 64, 64, 32, 32), (2, 32, 32, 32, 64, 64),
                  (2, 16, 16, 16, 128, 128), (2, 32, 32, 32, 32, 64),
                  (2, 32, 32, 32, 64, 32), (2, 8, 12, 20, 32, 32),
                  (2, 6, 10, 12, 64, 64))
BENCH_BATCH = 32
# Conv edge shapes of phase 3, (B, (D, H, W) or edge, segments, Cout).
CONV_EDGE_SHAPES = ((2, (10, 12, 20), (32,), 32), (2, 8, (16,), 16),
                    (2, 8, (8, 8), 8), (2, 8, (32,), 8),
                    (2, 6, (64, 64), 64), (2, (5, 7, 9), (3,), 16),
                    (2, 4, (64,), 64))
# Pipeline (phase 16): the volume, and the block bound that forces y/x
# super-tiles (cores (96, 176, 512) at patch 96: 18 tiles).
PIPE_N, PIPE_MAX_BLOCK = 512, 87_000_000
# Streamed vs direct predict with the UNet: bit-equal. The streamed volume
# puts each patch in other batches and slots (a slab's last batch is short),
# and the conv kernel picks its tile plan by the batch size. Its output
# and GroupNorm sums do not depend on either: every plan accumulates the
# taps in one order, and the sums are taken per unit (a z plane of an 8 x 8
# tile) in one fixed tree, then over the units in order, with no atomics
# (csrc/nb_conv3d.cu). On an H100 the ops around the kernel (the 1x1 head,
# resize, GroupNorm's finalize) gave the same bits in every batch as well.
EVAL_VOXELS = ((0, 0, 0), (64, 96, 128), (192, 64, 32), (128, 192, 192))
# Resume (phase 19): final params of 1 epoch + resume + 1 epoch against 2
# epochs straight, absolute. A tenth of the learning rate, the most one
# Adam step moves a parameter: a resume that lost the moments, the step
# (the schedule, the epoch's permutation) or a batch moves params by about
# one step's size or more; the same updates rounded otherwise on the card
# stay orders below it.
RESUME_ATOL = 1e-4
DEMO_BATCH = 16  # demo_end_to_end's --batch-size
# Reference checkpoints (phase 20): the spread of the seeded conv biases.
REF_BIAS_SIGMA = 0.05
# N2V (phase 21): the short run of train_n2v (its other flags at the
# defaults), and the card-vs-CPU step at a batch the CPU takes in seconds:
# bf16 on the card against f32 on the CPU, from one random init. Adam's
# first update is about lr · sign(g) for every element, so the updated
# parameters differ by at most two steps where a gradient's sign flips
# between the two (2 · lr), and the share of elements apart counts those
# flips. The limits on the loss (per loss), the whole gradient's relative
# L2 and that share were set at about twice the readings of the first run
# on an H100 (PERF.md): loss 2.0e-3 plain, 6.3e-2 sigma-aware (a random
# head's prediction through the exponential asinh inverse multiplies bf16's
# rounding), gradients 0.106 / 0.082 (phase 9b's f32 limit, 0.2, kept),
# share 0.075 / 0.024. The per-parameter gradients are printed, not held:
# the entry conv's (27 values, ahead of a GroupNorm that cancels most of
# them) reads 0.34.
N2V_STEPS, N2V_PATCHES, N2V_CHECK_BATCH = 300, 128, 4
N2V_LOSS_RTOL = {None: 0.005, 1.0: 0.15}
N2V_PARAM_ATOL = 2e-3 * 1.001
N2V_GRAD_REL_L2 = GRAD_REL_L2_F32
N2V_FLIP_SHARE = 0.15

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
    ext = f"{n}^3" if isinstance(n, int) else "x".join(map(str, n))
    return f"{ext} {cin}->{cout}"


def bound(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def check_kernel(b, n, segs, cout, seed, stats=True, time_it=True):
    """Conv kernel vs plain version at one shape (``n``: an edge or
    ``(D, H, W)``): within OUT_RTOL and STATS_RTOL, two launches bit-equal,
    the planted descriptor fault caught, and two of the elements launched
    alone as a smaller batch bit-equal to their slots. The time is that of
    the mode the path runs (``stats``: a forward with GroupNorm statistics;
    else plain mode, as the backward's dL/dx runs it). Returns its
    record."""
    import torch
    import torch.nn.functional as F

    from exaspim_tpu_torch.ops import nb_conv as nc
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_plain

    name = ("" if stats else "dx ") + shape_name(n, segs, cout)
    ext = (n,) * 3 if isinstance(n, int) else tuple(n)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cin = sum(segs)
    xs = tuple(torch.randn((b, *ext, c), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for c in segs)
    k = (torch.randn((27, cin, cout), generator=gen, device="cuda")
         / np.sqrt(27 * cin)).to(torch.bfloat16)
    plan = nc._plan(b, *ext, segs, cout)
    y, s1, s2 = nb_conv3d(xs, k, with_stats=True)
    y2, t1, t2 = nb_conv3d(xs, k, with_stats=True)
    y_plain_mode = nb_conv3d(xs, k)
    # Planted fault: tap 0 reads tap 1's view of the A operand (a debug
    # argument of the C entry point; the wrappers never pass it).
    y_fault = nc._launch(xs, k, False, debug=1)
    py, p1, p2 = nb_conv3d_plain(xs, k, with_stats=True)
    torch.cuda.synchronize()
    yf, pf = y.float(), py.float()
    err = float((yf - pf).abs().max())
    scale = float(pf.abs().max())
    fault_err = float((y_fault.float() - pf).abs().max())
    if not torch.isfinite(yf).all() or err > OUT_RTOL * scale:
        fail(f"{name}: kernel output off by {err} (max |plain| {scale})")
    if not (torch.equal(y, y2) and torch.equal(s1, t1)
            and torch.equal(s2, t2)):
        fail(f"{name}: two launches on the same inputs differ")
    if not torch.equal(y_plain_mode, y):
        fail(f"{name}: the plain mode differs from the stats mode")
    if not fault_err > OUT_RTOL * scale:
        fail(f"{name}: the planted descriptor fault was not caught "
             f"(|d| {fault_err})")
    del y2, t1, t2, y_fault
    # Batch-slot independence: elements lo..hi-1 alone, as a smaller batch
    # (another plan at the deep levels, other slots), give the same bits.
    lo, hi = (1, 3) if b > 2 else (b - 1, b)
    slot_plan = None
    if b > 1:
        sub = tuple(x[lo:hi].clone() for x in xs)
        slot_plan = nc._plan(hi - lo, *ext, segs, cout)
        ys, u1, u2 = nb_conv3d(sub, k, with_stats=True)
        if not (torch.equal(ys, y[lo:hi]) and torch.equal(u1, s1[lo:hi])
                and torch.equal(u2, s2[lo:hi])):
            fail(f"{name}: elements {lo}..{hi - 1} differ between batch {b} "
                 f"({dict(plan)}) and batch {hi - lo} ({dict(slot_plan)})")
        del sub, ys, u1, u2
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

    rec = {"shape": name, "batch": b, "key": (b, *ext, tuple(segs), cout),
           "plan": dict(plan), "max_abs_err": err,
           "rel_err": err / scale, "stats_err_s1": e1, "stats_err_s2": e2,
           "stats_vs_plain": vs_plain, "bit_equal_repeat": True,
           "fault_rel_err": fault_err / scale,
           "slot_check": None if slot_plan is None else [
               lo, hi, dict(slot_plan)]}
    slot = ("" if slot_plan is None else
            f", elements {lo}..{hi - 1} equal alone (B={hi - lo} "
            f"{slot_plan['mode']} wg={slot_plan['wg']} bn={slot_plan['bn']})")
    if not time_it:
        print(f"{name} B={b} {plan['mode']} wg={plan['wg']} bn={plan['bn']}:"
              f" rel {err / scale:.2e} <= {OUT_RTOL:.2e}, stats "
              f"{e1:.1e}/{e2:.1e}, repeat bit-equal, planted fault "
              f"{fault_err / scale:.2e} caught{slot}", flush=True)
        return rec
    # Times: the kernel, the plain version, and one cuDNN call on the
    # pre-concatenated input; and the wrapper's host time per launch.
    reps = 50 if max(ext) <= 16 else 20 if max(ext) <= 48 else 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        nb_conv3d(xs, k, with_stats=stats)
    host_us = (time.perf_counter() - t0) / reps * 1e6
    kernel_ms = cuda_ms(lambda: nb_conv3d(xs, k, with_stats=stats), reps)
    plain_ms = cuda_ms(lambda: nb_conv3d_plain(xs, k, with_stats=stats), 3)
    xcat = torch.cat(xs, -1).permute(0, 4, 1, 2, 3)  # channels_last_3d view
    wlib = k.reshape(3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous(
        memory_format=torch.channels_last_3d)
    library_ms = cuda_ms(lambda: F.conv3d(xcat, wlib, padding=1), reps)

    vox = b * int(np.prod(ext))
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout
    nbytes += 8 * b * cout if stats else 0
    rec.update({
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "host_us_per_launch": host_us,
        **bound(flops, nbytes), "tflops": flops / kernel_ms / 1e9,
    })
    rec["bound_share"] = rec["bound_ms"] / kernel_ms
    print(
        f"{name} B={b} {plan['mode']} wg={plan['wg']} bn={plan['bn']}: "
        f"max|d|={err:.3e} (rel {err / scale:.2e} <= "
        f"{OUT_RTOL:.2e}) stats {e1:.1e}/{e2:.1e} <= {STATS_RTOL:.0e} "
        f"(vs plain's {vs_plain[0]:.1e}/{vs_plain[1]:.1e}), repeat "
        f"bit-equal, planted fault {fault_err / scale:.2e} caught{slot}  "
        f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
        f"library_ms={library_ms:.4f} bound_ms={rec['bound_ms']:.4f} "
        f"({rec['bound_by']}) {rec['tflops']:.1f} TFLOP/s "
        f"({100 * rec['bound_share']:.1f} % of the bound); host "
        f"{host_us:.1f} us per launch",
        flush=True,
    )
    return rec


def check_dw(b, n, segs, cout, seed):
    """dL/dW kernel vs plain at one training shape: within DW_RTOL of the
    |x|·|g| contraction, two launches bit-equal, the planted fault (tap 0
    reads tap 1's view) caught; timed beside the plain version, one
    ``convolution_backward`` (a yardstick only) and the card's bound.
    Returns its record."""
    import torch

    from exaspim_tpu_torch.ops import nb_conv as nc
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d_dw, nb_conv3d_dw_plain

    name = "dw " + shape_name(n, segs, cout)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cin = sum(segs)
    xs = tuple(torch.randn((b, n, n, n, c), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for c in segs)
    g = torch.randn((b, n, n, n, cout), generator=gen, device="cuda",
                    dtype=torch.bfloat16) * 0.1
    plan = nc._dw_plan(b, n, n, n, tuple(segs), cout)
    got = nb_conv3d_dw(xs, g)
    again = nb_conv3d_dw(xs, g)
    bad = nc._launch_dw(xs, g, debug=1)
    plain = nb_conv3d_dw_plain(xs, g)
    scale = nb_conv3d_dw_plain(tuple(x.abs() for x in xs), g.abs())
    torch.cuda.synchronize()
    d = (got - plain).abs()
    err = float(d.max())
    rel = float((d / scale.clamp(min=1e-30)).max())
    fault = float(((bad - plain).abs() / scale.clamp(min=1e-30)).max())
    if not torch.isfinite(got).all() or bool((d > DW_RTOL * scale).any()):
        fail(f"{name}: off by {err} (max |d|/scale {rel:.3e})")
    if not torch.equal(got, again):
        fail(f"{name}: two launches on the same inputs differ")
    if not fault > DW_RTOL:
        fail(f"{name}: the planted fault was not caught ({fault:.3e})")
    del again, bad
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
        "shape": name, "batch": b, "plan": dict(plan), "max_abs_err": err,
        "rel_to_abs": rel, "fault_rel": fault,
        "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        **bound(flops, nbytes), "tflops": flops / kernel_ms / 1e9,
    }
    print(f"{name} B={b} {plan['mode']} splits={plan['splits']} "
          f"blocks={plan['blocks']}: max|d|={err:.3e} (max |d|/|x||g| "
          f"{rel:.2e} <= {DW_RTOL:.0e}, repeat bit-equal, planted fault "
          f"{fault:.2e} caught) kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"{rec['tflops']:.1f} TFLOP/s", flush=True)
    return rec


def check_histogram(val_vols, pair):
    """Phase 8: both entries of the byte-histogram kernel against their
    plain versions at every edge case of ``hist_bench.edge_cases``, on a
    validation batch (``val_vols``, 32 x 64^3 int32 counts) and on the 256^3
    pair of phase 4 (noisy and denoised, int32); two launches bit-equal;
    one call one kernel on the device; times on the batch and the pair."""
    import torch

    from exaspim_tpu_torch.compression import proxy as P
    from exaspim_tpu_torch.ops import hist_bench as hb

    def check(name, rows, vols, chunk):
        got = P.byte_histogram(rows)
        got_c = P.chunk_byte_histograms(vols, chunk)
        ref = P.byte_histogram_plain(rows)
        ref_c = P.chunk_byte_histograms_plain(vols, chunk)
        again = (P.byte_histogram(rows), P.chunk_byte_histograms(vols, chunk))
        torch.cuda.synchronize()
        for label, a, b in (("byte_histogram", got, ref),
                            ("chunk_byte_histograms", got_c, ref_c)):
            if not torch.equal(a, b):
                fail(f"{label} on {name}: counts differ in "
                     f"{int((a != b).sum())} bins")
        if not (torch.equal(again[0], got) and torch.equal(again[1], got_c)):
            fail(f"byte histogram on {name}: two launches differ")
        print(f"{name}: rows {tuple(rows.shape)}, volumes "
              f"{tuple(vols.shape)} chunk {chunk}: both entries equal to "
              "plain, repeat bit-equal", flush=True)

    for name, (rows, vols, chunk) in hb.edge_cases("cuda").items():
        check(name, rows, vols, chunk)
    work = {"validation batch": val_vols, "256^3 pair": pair}
    rows = {k: hb._rows(v, 64) for k, v in work.items()}
    for k in work:
        check(k, rows[k], work[k], 64)
    # One call, one kernel: the call captured in a CUDA graph holds one
    # kernel node and nothing else (no memset, no conversion, no copy).
    for label, fn in (
            ("byte_histogram", lambda: P.byte_histogram(rows["256^3 pair"])),
            ("chunk_byte_histograms",
             lambda: P.chunk_byte_histograms(work["256^3 pair"], 64))):
        ops = hb.device_ops(fn)
        if len(ops) != 1 or ops[0][0] != "kernel" \
                or "byte_histogram" not in ops[0][1]:
            fail(f"one {label} call enqueued {ops}, not one kernel")
        print(f"one {label} call: one kernel node ({ops[0][1]})")

    graph_ms, wrapper_ms = hb._timers("cuda", 50)
    recs = {}
    for k, vols in work.items():
        r = rows[k]
        n_out = 4 * 256 * r.shape[0]
        recs[k] = {
            "rows": list(r.shape), "volumes": list(vols.shape),
            "max_abs_err": 0.0,
            "ms": graph_ms(lambda: P.byte_histogram(r)),
            "wrapper_ms": wrapper_ms(lambda: P.byte_histogram(r)),
            "plain_ms": wrapper_ms(lambda: P.byte_histogram_plain(r)),
            "library_ms": wrapper_ms(hb._bincount(r)),
            "bound_ms": 1e3 * (r.numel() + n_out) / PEAK_BYTES,
            "bound_by": "bytes",
            "chunk_entry": {
                "max_abs_err": 0.0,
                "ms": graph_ms(lambda: P.chunk_byte_histograms(vols, 64)),
                "wrapper_ms": wrapper_ms(
                    lambda: P.chunk_byte_histograms(vols, 64)),
                "plain_ms": wrapper_ms(
                    lambda: P.chunk_byte_histograms_plain(vols, 64)),
                "library_ms": None,
                "bound_ms": 1e3 * (4 * vols.numel() + n_out) / PEAK_BYTES,
                "bound_by": "bytes"},
            "cratio_proxy_batch_ms": graph_ms(
                lambda: P.cratio_proxy_batch(vols, 64)),
            "cratio_proxy_batch_wrapper_ms": wrapper_ms(
                lambda: P.cratio_proxy_batch(vols, 64)),
        }
        h, c = recs[k], recs[k]["chunk_entry"]
        print(f"{k}: byte_histogram {r.shape[0]} rows x {r.shape[1]} B: "
              f"graph {h['ms']:.4f} ms, wrapper {h['wrapper_ms']:.4f}, plain "
              f"{h['plain_ms']:.4f}, bincount {h['library_ms']:.4f}, bound "
              f"{h['bound_ms']:.4f} (bytes); chunk_byte_histograms graph "
              f"{c['ms']:.4f} ms, wrapper {c['wrapper_ms']:.4f}, plain "
              f"{c['plain_ms']:.4f}, bound {c['bound_ms']:.4f} (bytes); "
              f"cratio_proxy_batch graph {h['cratio_proxy_batch_ms']:.4f} "
              f"ms, wrapper {h['cratio_proxy_batch_wrapper_ms']:.4f}",
              flush=True)
    return recs


@contextlib.contextmanager
def swapped(obj, **attrs):
    """Replace attributes of ``obj`` for the duration."""
    old = {k: getattr(obj, k) for k in attrs}
    for k, v in attrs.items():
        setattr(obj, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(obj, k, v)


def patched(**attrs):
    """Replace attributes of ``exaspim_tpu_torch.ops.nb_conv`` for the
    duration (the harness's shape recorder and planted faults)."""
    from exaspim_tpu_torch.ops import nb_conv

    return swapped(nb_conv, **attrs)


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


def grad_check(width=1.0, faults=FAULTS):
    """Phase 9 (see the module docstring) for a UNet of ``width``; the
    planted ``faults`` of (c) (phase 10b passes none)."""
    import torch

    from exaspim_tpu_torch.losses import signal_preserving_loss
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw

    rng = np.random.default_rng(9)
    x = rng.normal(0.3, 0.1, (2, 32, 32, 32, 1)).astype(np.float32)
    y = (0.9 * x + rng.normal(0.0, 0.02, x.shape)).astype(np.float32)
    kw = dict(width_multiplier=width, head_init="normal")
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
    for fault in faults:
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
    launches in that run (``library_ms`` stays None for a kernel without
    a library call)."""
    tot = {k: sum(c * r[k] for c, r in zip(counts, recs))
           for k in ("ms", "plain_ms", "bound_ms")}
    lib = [r["library_ms"] for r in recs]
    tot["library_ms"] = None if None in lib else sum(
        c * v for c, v in zip(counts, lib))
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
    from exaspim_tpu_torch.compression.proxy import (
        byte_histogram,
        chunk_byte_histograms,
    )
    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.nb_bench import unet_conv_shapes
    from exaspim_tpu_torch.ops.nb_conv import _plan, nb_conv3d, nb_conv3d_dw
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
    nb_conv3d.reduce_launches = chunk_byte_histograms.launches = 0
    t0 = time.perf_counter()
    trainer = train([train_dir], [val_dir], os.path.join(WORK, "run"),
                    epochs=epochs, val_every=VAL_EVERY, log_every=1, **cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"nb_conv3d": nb_conv3d.launches,
                "nb_conv3d_reduce": nb_conv3d.reduce_launches,
                "nb_conv3d_dw": nb_conv3d_dw.launches,
                # Row 6: both entries of csrc/byte_histogram.cu; validation
                # takes the byte planes from the volumes (the chunk entry).
                "byte_histogram": byte_histogram.launches
                + chunk_byte_histograms.launches,
                "chunk_byte_histograms": chunk_byte_histograms.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_val = 2 * (-(-N_VAL // 32))  # validations x batches
    # The statistics' reduce runs for every forward conv with more than one
    # unit (the 4^3 bottleneck convs have one: 64 FLAT voxels).
    reduced = sum(1 for kind, n, segs, cout in unet_conv_shapes(PATCH)
                  if kind == "fwd"
                  and _plan(32, n, n, n, segs, cout)["ws_rows"] > 1)
    want = {"nb_conv3d": 35 * TRAIN_STEPS + 18 * n_val,
            "nb_conv3d_reduce": reduced * (TRAIN_STEPS + n_val),
            "nb_conv3d_dw": 18 * TRAIN_STEPS, "byte_histogram": n_val,
            "chunk_byte_histograms": n_val}
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
    prof = profile_once(lambda: [run() for _ in range(2)], key=(
        "nb_conv3d_kernel", "nb_stats_reduce", "dw_"))
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


def width_path(train_dir, transform_cfg):
    """Phase 10b: ``width_multiplier=0.3`` (stages 9, 19, 38, 76, no width a
    multiple of 8 but 76's input) on the kernels. (a) phase 9's gradient
    check at this width: each conv's backward against its f32 reference,
    whole-model gradients against the plain path on the CPU; (b) one cached
    training step of the default configuration, counted; (c) ``predict``
    of a 48³ block of the phantom (through a linear transform) against the
    plain path on the card in bf16 and the f32 CPU path. Returns its
    record."""
    import torch

    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.ops.nb_conv import (
        nb_conv3d,
        nb_conv3d_dw,
        nb_conv3d_plain,
    )
    from exaspim_tpu_torch.train.state import create_train_state
    from exaspim_tpu_torch.transforms import build_transform

    widths = sorted({m.kernel.shape[-1] for m in UNet(
        width_multiplier=0.3).modules() if hasattr(m, "kernel")
        and m.kernel.dim() == 3})
    print(f"width 0.3: conv widths {widths}", flush=True)
    rec = {"conv_widths": widths, "grad_check": grad_check(0.3, faults=())}

    transform = build_transform(transform_cfg)
    # A head drawn from a normal (training starts from zeros, which leaves
    # every gradient but the head's zero in the first step), so that the
    # step moves every parameter through the kernels' gradients.
    state = create_train_state(
        UNet(width_multiplier=0.3, head_init="normal",
             dtype=torch.bfloat16).cuda(), lr=1e-3, total_steps=TRAIN_STEPS,
        seed=42)
    before = [p.detach().clone() for p in state.model.parameters()]
    run = cached_step(train_dir, state, transform)
    c0 = nb_conv3d.launches, nb_conv3d_dw.launches
    _, loss = run()
    torch.cuda.synchronize()
    launches = (nb_conv3d.launches - c0[0], nb_conv3d_dw.launches - c0[1])
    moved = sum(not torch.equal(a, p.detach()) for a, p in
                zip(before, state.model.parameters()))
    print(f"(b) one cached training step at width 0.3, batch 32 of "
          f"{PATCH}^3: loss {float(loss):.6f}, {moved} of {len(before)} "
          f"parameters updated, launches conv {launches[0]}, dL/dW "
          f"{launches[1]} (expected 35, 18)", flush=True)
    if launches != (35, 18) or not np.isfinite(float(loss)) \
            or moved != len(before):
        fail(f"width 0.3 step: launches {launches}, loss {float(loss)}, "
             f"{moved} parameters moved")
    rec["step"] = {"loss": float(loss), "launches": launches}
    del run, before

    del state
    clean, _ = neurite_phantom((48,) * 3, n_tubes=6, seed=0)
    img = noisy_observation(clean, seed=1)
    # A normal head again, so that the model changes its input and the
    # check reads the convs; and a linear transform, so that the counts
    # are linear in the model's output (the asinh inverse is exponential
    # and turns a random head's logits into ~1e14 counts, where bf16's
    # relative error is multiplied by the logit).
    model = UNet(width_multiplier=0.3, head_init="normal",
                 dtype=torch.bfloat16).init_weights(7).cuda().eval()
    transform = build_transform({"kind": "linear", "params": {
        "mn": 0.0, "mx": float(img.max()), "clip": 8.0}})
    c0 = nb_conv3d.launches, nb_conv3d_dw.launches
    with torch.no_grad():
        got = predict(img, model, transform, patch_size=32, overlap=OVERLAP,
                      trim=TRIM, batch_size=8, return_float=True)
    launches = (nb_conv3d.launches - c0[0], nb_conv3d_dw.launches - c0[1])
    # The same model on the card with every conv on its plain version (the
    # same bf16 roundings, other sums), and the f32 model on the CPU.
    with torch.no_grad(), patched(
            _conv=lambda xs, k, with_stats: nb_conv3d_plain(xs, k,
                                                            with_stats)):
        plain = predict(img, model, transform, patch_size=32,
                        overlap=OVERLAP, trim=TRIM, batch_size=8,
                        return_float=True)
    cpu = UNet(width_multiplier=0.3, dtype=torch.float32)
    cpu.load_state_dict(model.state_dict())
    with torch.no_grad():
        ref = predict(img, cpu, transform, patch_size=32, overlap=OVERLAP,
                      trim=TRIM, batch_size=8, return_float=True,
                      device="cpu")
    # Relative L2 of the model's change to its input.
    change = np.linalg.norm(ref - img)
    rel_b = float(np.linalg.norm(got - plain)
                  / max(np.linalg.norm(plain - img), 1e-30))
    rel = float(np.linalg.norm(got - ref) / max(change, 1e-30))
    n_patches = launches[0] // 18
    print(f"(c) predict 48^3 at width 0.3: {launches[0]} conv launches "
          f"({n_patches} batches x 18), {launches[1]} dL/dW; rel L2 of the "
          f"change: vs the plain path on the card in bf16 {rel_b:.3e} "
          f"(limit {WIDTH_PREDICT_REL_BF16}), vs CPU f32 {rel:.3e} (limit "
          f"{WIDTH_PREDICT_REL_F32}); |change| {change:.1f}", flush=True)
    if launches[1] != 0 or launches[0] == 0 or launches[0] % 18 \
            or not np.isfinite(got).all() \
            or rel_b > WIDTH_PREDICT_REL_BF16 or rel > WIDTH_PREDICT_REL_F32:
        fail(f"width 0.3 predict: launches {launches}, rel {rel_b}, {rel}")
    rec["predict"] = {"launches": launches, "rel_l2_vs_plain_bf16": rel_b,
                      "rel_l2_vs_cpu_f32": rel}
    return rec


def check_matching(name, vol):
    """Phase 11 on one volume: the fused kernel's starts against the plain
    version's, then its two halves (the table instance, the selection over
    that table) against theirs, each timed beside its plain version, the
    bound and, for the selection, one ``torch.topk``. Returns the fused
    and the selection records."""
    import torch

    from exaspim_tpu_torch.ops import bm4d_match as tm
    from exaspim_tpu_torch.ops.match_bench import bound_ms

    g = torch.as_tensor(vol, dtype=torch.float32, device="cuda")
    grid = tm.grid_shape(g.shape, BM_B, BM_STEP)
    refs = grid[0] * grid[1] * grid[2]
    kw = dict(block=BM_B, step=BM_STEP, search=BM_W)
    fused_err = check_fused(name, g)
    table = tm.match_distances(g, **kw)
    plain = tm.match_distances_plain(g, **kw)
    torch.cuda.synchronize()
    # Non-negative bf16 values order as their bits: the gap in ulps.
    ulps = (table.view(torch.int16).int() - plain.view(torch.int16).int()).abs()
    share, worst = float((ulps > 0).float().mean()), int(ulps.max())
    err = float((table.float() - plain.float()).abs().max())
    if not torch.isfinite(table.float()).all() or worst > TABLE_MAX_ULPS:
        fail(f"bm4d_match {name}: table off by {worst} bf16 ulps "
             f"(share {share:.3e}, limit {TABLE_MAX_ULPS})")
    del plain, ulps
    sel = (grid, BM_K, BM_STEP, BM_W)
    starts = tm.select_topk(table, *sel)
    want = tm.select_topk_plain(table, *sel)
    torch.cuda.synchronize()
    sel_err = max(int((a - b).abs().max()) for a, b in zip(starts, want))
    if sel_err:
        fail(f"bm4d_select {name}: starts differ from the plain version on "
             f"the kernel's own table (max {sel_err})")
    del starts, want

    w3 = BM_W ** 3
    f_ms = cuda_ms(lambda: tm.match_topk(g, BM_B, BM_K, BM_STEP, BM_W), 20)
    f_plain = cuda_ms(lambda: tm.match_topk_plain(
        g, BM_B, BM_K, BM_STEP, BM_W), 2)
    m_ms = cuda_ms(lambda: tm.match_distances(g, **kw), 20)
    m_plain = cuda_ms(lambda: tm.match_distances_plain(g, **kw), 2)
    s_ms = cuda_ms(lambda: tm.select_topk(table, *sel), 20)
    s_plain = cuda_ms(lambda: tm.select_topk_plain(table, *sel), 3)
    keys = tm._keys(table, BM_W)
    s_lib = cuda_ms(lambda: torch.topk(keys, BM_K, dim=1, largest=False), 5)
    del keys, table
    # No matrix product is in the function: the FP32 vector peak applies,
    # to the operations of the separable evaluation (match_bench.
    # match_operations); the bytes are the guide read once and the starts
    # written once.
    b_ms, b_by = bound_ms(tuple(g.shape), grid, BM_K)
    fused = {"shape": name, "refs": refs, "max_abs_err": float(fused_err),
             "ms": f_ms, "plain_ms": f_plain, "library_ms": None,
             "bound_ms": b_ms, "bound_by": b_by,
             "table_ms": m_ms, "table_plain_ms": m_plain,
             "table_max_abs_err": err, "table_differ_share": share,
             "table_max_ulps": worst}
    select = {"shape": name, "refs": refs, "max_abs_err": float(sel_err),
              "ms": s_ms, "plain_ms": s_plain, "library_ms": s_lib,
              **bound(0.0, 2 * refs * w3 + 3 * 4 * refs * BM_K)}
    print(f"{name}: {refs} refs x {w3} offsets\n  fused (match_topk, one "
          f"launch) kernel_ms={f_ms:.4f} plain_ms={f_plain:.4f} bound_ms="
          f"{b_ms:.4f} ({b_by})\n  table instance: differs from plain on "
          f"share {share:.3e} of entries, worst {worst} bf16 ulps (limit "
          f"{TABLE_MAX_ULPS}), max|d|={err:.3e}; kernel_ms={m_ms:.4f} "
          f"plain_ms={m_plain:.4f}\n  selection (bm4d_select on that "
          f"table): starts equal; kernel_ms={s_ms:.4f} plain_ms="
          f"{s_plain:.4f} library_ms={s_lib:.4f} (one torch.topk) bound_ms="
          f"{select['bound_ms']:.4f} ({select['bound_by']})", flush=True)
    return fused, select


def check_fused(name, g):
    """The fused kernel on a guide or a batch of guides against
    select_topk_plain(match_distances_plain(.)) on the card: the starts
    must be equal, member 0 the reference itself. Returns max |Δ|."""
    import torch

    from exaspim_tpu_torch.ops import bm4d_match as tm

    starts = tm.match_topk(g, BM_B, BM_K, BM_STEP, BM_W)
    want = tm.match_topk_plain(g, BM_B, BM_K, BM_STEP, BM_W)
    torch.cuda.synchronize()
    err = max(int((a - b).abs().max()) for a, b in zip(starts, want))
    if err or any(a.shape != b.shape for a, b in zip(starts, want)):
        fail(f"fused matcher {name}: starts differ from the plain version "
             f"(max {err})")
    grid = tm.grid_shape(g.shape[-3:], BM_B, BM_STEP)
    r = torch.arange(grid[0] * grid[1] * grid[2], device="cuda",
                     dtype=torch.int32)
    ref_grid = (BM_STEP * (r // (grid[1] * grid[2])),
                BM_STEP * ((r // grid[2]) % grid[1]), BM_STEP * (r % grid[2]))
    if not all(torch.equal(s[..., 0], w.expand_as(s[..., 0]))
               for s, w in zip(starts, ref_grid)):
        fail(f"fused matcher {name}: member 0 is not the reference itself")
    print(f"{name}: fused starts {tuple(starts[0].shape)} x 3 equal the "
          f"plain version's (max |d| {err}); member 0 = reference",
          flush=True)
    return err


def matching_kernels():
    """Phase 11: three volumes and a batch of three 64³ patches; then the
    fused kernel's time per patch on the teacher path's batches (eight 64³
    patches, each stage one launch). Returns the records."""
    import torch

    from exaspim_tpu_torch.data.precompute import TEACHER_BATCH
    from exaspim_tpu_torch.data.synthetic import (
        SyntheticPatchDataset,
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.ops import bm4d_match as tm
    from exaspim_tpu_torch.ops.bm4d import bm4d_batch

    ds = SyntheticPatchDataset(n=TEACHER_BATCH, seed=TEACHER_SEED)
    raws = np.stack([ds.raw_and_fg(i)[0] for i in range(TEACHER_BATCH)])
    raws = torch.from_numpy(raws.astype(np.float32)).cuda()
    # Stage-1 estimates: smooth, ties everywhere.
    basics = bm4d_batch(raws, BM_SIGMA, two_stage=False)
    big = noisy_observation(neurite_phantom((128,) * 3, seed=0)[0], seed=1)
    big = np.pad(big.astype(np.float32), [(0, 2)] * 3, mode="reflect")
    recs = [check_matching("64^3 raw patch", raws[0]),
            check_matching("64^3 stage-1 estimate", basics[0]),
            check_matching("130^3 volume", big)]
    batch_err = check_fused("batch of three 64^3 patches", raws[:3])
    # The path's shape: a stage of TEACHER_BATCH patches is one launch.
    path = [cuda_ms(lambda v=v: tm.match_topk(v, BM_B, BM_K, BM_STEP, BM_W),
                    20) / TEACHER_BATCH for v in (raws, basics)]
    print(f"fused kernel in batches of {TEACHER_BATCH} (the teacher path): "
          f"{path[0]:.4f} ms per raw patch, {path[1]:.4f} per stage-1 "
          f"estimate, {sum(path):.4f} per patch (two stages); one guide at "
          f"a time {recs[0][0]['ms'] + recs[1][0]['ms']:.4f}", flush=True)
    del raws, basics
    torch.cuda.empty_cache()
    return {"fused": [r[0] for r in recs], "select": [r[1] for r in recs],
            "batch_max_abs_err": batch_err, "path_ms": path}


def teacher_path():
    """Phase 12: precompute() at its defaults on the card; returns the
    record and the launch counts of the counted run."""
    import torch
    from scipy import ndimage

    from exaspim_tpu_torch.data.cache import CachedValidateDataset
    from exaspim_tpu_torch.data.precompute import (
        SEED_STREAMS,
        TEACHER_BATCH,
        precompute,
    )
    from exaspim_tpu_torch.data.synthetic import neurite_phantom
    from exaspim_tpu_torch.ops import bm4d_match as tm
    from exaspim_tpu_torch.ops.bm4d import bm4d, bm4d_batch

    out = os.path.join(WORK, "teachers")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (tm.match_topk, tm.match_distances, tm.select_topk)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    precompute(out, split="val", source="synthetic", n=N_TEACHERS,
               seed=TEACHER_SEED, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    # Two stages per bm4d_batch call, one call per TEACHER_BATCH patches.
    want = {"match_topk": 2 * -(-N_TEACHERS // TEACHER_BATCH),
            "match_distances": 0, "select_topk": 0}
    print(f"precompute(): {N_TEACHERS} patches of {PATCH}^3 in {wall:.3f} s "
          f"({wall / N_TEACHERS:.4f} s per patch, phantom synthesis on the "
          f"host included); launches {launches} (expected {want}); peak "
          f"device memory {peak_gb:.3f} GiB", flush=True)
    if launches != want:
        fail(f"teacher launches {launches}, expected {want}")

    ds = CachedValidateDataset(out)
    if len(ds) != N_TEACHERS or ds.patch_shape != (PATCH,) * 3:
        fail(f"cache: {len(ds)} items of {ds.patch_shape}")
    raws = np.stack([ds[i][0] for i in range(N_TEACHERS)])
    teachers = np.stack([ds[i][1] for i in range(N_TEACHERS)])
    if raws.dtype != np.uint16 or teachers.dtype != np.uint16:
        fail(f"cache dtypes {raws.dtype} {teachers.dtype}")

    # The clean phantoms, from the seeds precompute() gave the dataset.
    def rmse(a, b):
        return float(np.sqrt(np.mean((a.astype(np.float64) - b) ** 2)))

    seed = TEACHER_SEED + SEED_STREAMS["val"]
    e_raw, e_teacher, e_gauss = [], [], []
    for i in range(N_TEACHERS):
        s1, _ = np.random.SeedSequence([seed, i]).spawn(2)
        clean, _ = neurite_phantom((PATCH,) * 3, n_tubes=4,
                                   seed=int(s1.generate_state(1)[0]))
        e_raw.append(rmse(raws[i], clean))
        e_teacher.append(rmse(teachers[i], clean))
        e_gauss.append(rmse(np.round(ndimage.gaussian_filter(
            raws[i].astype(np.float32), 1.0)), clean))
    e_raw, e_teacher, e_gauss = (float(np.mean(e))
                                 for e in (e_raw, e_teacher, e_gauss))
    print(f"mean RMSE against the clean phantoms: raw {e_raw:.4f}, BM4D "
          f"teacher {e_teacher:.4f}, Gaussian teacher {e_gauss:.4f} counts",
          flush=True)
    if not np.isfinite(e_teacher) or not e_teacher < e_raw:
        fail(f"the teachers ({e_teacher}) do not beat the raw patches "
             f"({e_raw}) against the clean phantoms")

    def counts(t):
        return np.clip(np.round(t.cpu().numpy()), 0, 65535)

    # Batched (the cache) vs per-volume teachers: the volumes share no
    # rows, but the batched patch conv may sum in another order.
    f32 = raws.astype(np.float32)
    single = np.stack([counts(bm4d(v, BM_SIGMA)) for v in f32])
    d = np.abs(single - teachers)
    bit_equal = int(sum(np.array_equal(a, b)
                        for a, b in zip(single, teachers)))
    vs_single = {"max": float(d.max()), "share": float((d > 0).mean()),
                 "bit_equal_patches": bit_equal}
    print(f"batched vs per-volume teachers: {bit_equal} of {N_TEACHERS} "
          f"patches bit-equal; max {d.max():.0f} count(s) on share "
          f"{vs_single['share']:.3e} of voxels (limits "
          f"{TEACHER_MAX_COUNTS}, {TEACHER_MAX_SHARE})", flush=True)
    if d.max() > TEACHER_MAX_COUNTS or vs_single["share"] > TEACHER_MAX_SHARE:
        fail("the batched teachers stray from the per-volume ones")

    # Two card runs of a batch, and of patch 0 alone, bit-equal; patch 0
    # against the CPU path (plain versions).
    first = bm4d_batch(f32[:TEACHER_BATCH], BM_SIGMA)
    again = bm4d_batch(f32[:TEACHER_BATCH], BM_SIGMA)
    one, one_again = bm4d(f32[0], BM_SIGMA), bm4d(f32[0], BM_SIGMA)
    torch.cuda.synchronize()
    if not torch.equal(first, again) or not torch.equal(one, one_again) \
            or not np.array_equal(counts(first), teachers[:TEACHER_BATCH]):
        fail("two card runs differ: the teacher depends on scheduling")
    t0 = time.perf_counter()
    cpu = bm4d(f32[0], BM_SIGMA, device="cpu").numpy()
    cpu_s = time.perf_counter() - t0
    d = np.abs(np.round(one.cpu().numpy()) - np.round(cpu))
    share = float((d > 0).mean())
    print(f"two card runs bit-equal (a batch of {TEACHER_BATCH}, and patch 0 "
          f"alone); patch 0 card vs CPU (plain versions, {cpu_s:.2f} s): "
          f"max {d.max():.0f} count(s) on share {share:.3e} of voxels "
          f"(limits {TEACHER_MAX_COUNTS}, {TEACHER_MAX_SHARE})", flush=True)
    if d.max() > TEACHER_MAX_COUNTS or share > TEACHER_MAX_SHARE:
        fail("the card's teacher strays from the CPU path")

    # The teachers alone (no phantom synthesis, no cache writes), in the
    # path's batches.
    def run_all():
        for lo in range(0, N_TEACHERS, TEACHER_BATCH):
            bm4d_batch(f32[lo:lo + TEACHER_BATCH], BM_SIGMA,
                       step=BM_STEP).cpu()

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_all()
        times.append((time.perf_counter() - t0) / N_TEACHERS)
    sec = float(np.median(times))
    print(f"bm4d_batch in batches of {TEACHER_BATCH}: seconds per patch "
          f"{times} (median {sec:.5f}); {1 / sec:.2f} patches/s, "
          f"{PATCH ** 3 / sec:.1f} voxels/s", flush=True)

    phase(f"teacher path: profile of one bm4d_batch call ({TEACHER_BATCH} "
          "patches)")
    prof = profile_once(lambda: bm4d_batch(f32[:TEACHER_BATCH], BM_SIGMA),
                        key="bm4d_match_kernel", warm=True)
    # Two stages: the profile must hold what the counters saw, 1 + 1.
    if prof is not None and prof["key_launches"] != 2:
        fail(f"the profile of one bm4d_batch call lists "
             f"{prof['key_launches']} launches of the matching kernel, the "
             "call makes 2")
    return {"wall_s": wall, "launches": launches, "peak_mem_gb": peak_gb,
            "rmse_raw": e_raw, "rmse_teacher": e_teacher,
            "rmse_gauss": e_gauss, "batched_vs_single": vs_single,
            "card_vs_cpu_max": float(d.max()), "card_vs_cpu_share": share,
            "cpu_s": cpu_s, "seconds_per_patch": sec, "patch_s": times,
            "voxels_per_s": PATCH ** 3 / sec, "profile": prof}


def asinh_kernels(img, transform):
    """Phase 13: the elementwise path on the 256³ block, counted, then the
    two kernels against their plain versions. Returns their records and
    the launch counts."""
    import torch

    from exaspim_tpu_torch.ops.elementwise import (
        asinh_forward,
        asinh_forward_plain,
        asinh_inverse,
        asinh_inverse_plain,
    )

    kw = dict(offset=transform.offset, scale=transform.scale,
              norm=transform._norm)
    x = torch.from_numpy(img).cuda()
    asinh_forward.launches = asinh_inverse.launches = 0
    y = asinh_forward(x, **kw)
    back = asinh_inverse(y, max_count=transform.max_count, **kw)
    torch.cuda.synchronize()
    launches = {"asinh_forward": asinh_forward.launches,
                "asinh_inverse": asinh_inverse.launches}
    if launches != {"asinh_forward": 1, "asinh_inverse": 1}:
        fail(f"elementwise launches {launches}, expected one each")
    if y.dtype != torch.float32 or back.dtype != torch.uint16 or \
            not torch.equal(back, x):
        fail("asinh forward then inverse does not return the input counts")

    yp = asinh_forward_plain(x, **kw)
    ulp = torch.nextafter(yp.abs(), torch.full_like(yp, float("inf"))) \
        - yp.abs()
    f_err = float((y - yp).abs().max())
    f_ulps = float(((y - yp).abs() / ulp).max())
    f_true = float((y - transform.forward(x.to(torch.float32))).abs().max())
    del ulp
    if not torch.isfinite(y).all() or f_ulps > ASINH_MAX_ULPS \
            or f_true > ASINH_ATOL:
        fail(f"asinh_forward: {f_ulps} ulps from the plain version, "
             f"{f_true} from AsinhTransform.forward")
    # The inverse on off-lattice values, as a network's output is.
    gen = torch.Generator(device="cuda").manual_seed(13)
    yn = yp + 0.01 * torch.randn(yp.shape, generator=gen, device="cuda")
    del yp
    got = asinh_inverse(yn, **kw).to(torch.int32)
    d = (got - asinh_inverse_plain(yn, **kw).to(torch.int32)).abs()
    i_err, i_share = int(d.max()), float((d > 0).float().mean())
    d = (got - transform.inverse_counts(yn)).abs()
    t_err, t_share = int(d.max()), float((d > 0).float().mean())
    del got, d
    if max(i_err, t_err) > 1 or max(i_share, t_share) > ASINH_INV_SHARE:
        fail(f"asinh_inverse: counts off by {i_err} on share {i_share} "
             f"(plain), {t_err} on {t_share} (AsinhTransform)")
    n = x.numel()
    # AsinhTransform computes the same functions in several PyTorch calls
    # each (cast, affine, asinh or sinh, scale, round, clamp): a yardstick
    # beside the plain versions, not one library call, so library_ms is None.
    xf = x.to(torch.float32)
    f_tr = cuda_ms(lambda: transform.forward(xf), 5)
    i_tr = cuda_ms(lambda: transform.inverse_counts(yn), 5)
    del xf
    recs = {
        "asinh_forward": {
            "max_abs_err": f_err, "max_ulps": f_ulps,
            "ms": cuda_ms(lambda: asinh_forward(x, **kw), 50),
            "plain_ms": cuda_ms(lambda: asinh_forward_plain(x, **kw), 5),
            "transform_ms": f_tr, "library_ms": None,
            **bound(0.0, (2 + 4) * n)},
        "asinh_inverse": {
            "max_abs_err": float(i_err), "differ_share": i_share,
            "ms": cuda_ms(lambda: asinh_inverse(yn, **kw), 50),
            "plain_ms": cuda_ms(lambda: asinh_inverse_plain(yn, **kw), 5),
            "transform_ms": i_tr, "library_ms": None,
            **bound(0.0, (4 + 2) * n)},
    }
    f, i = recs["asinh_forward"], recs["asinh_inverse"]
    print(f"{n} voxels: forward then inverse returns the input counts\n"
          f"  asinh_forward max|d|={f_err:.3e} ({f_ulps:.2f} ulps of the "
          f"plain log form, limit {ASINH_MAX_ULPS}; {f_true:.3e} from "
          f"AsinhTransform.forward, limit {ASINH_ATOL}) "
          f"kernel_ms={f['ms']:.4f} plain_ms={f['plain_ms']:.4f} "
          f"AsinhTransform.forward_ms={f_tr:.4f} (several calls, f32 in) "
          f"bound_ms={f['bound_ms']:.4f} (bytes)\n"
          f"  asinh_inverse counts differ from plain by {i_err} on share "
          f"{i_share:.3e}, from AsinhTransform by {t_err} on {t_share:.3e} "
          f"(limits 1, {ASINH_INV_SHARE}) kernel_ms={i['ms']:.4f} "
          f"plain_ms={i['plain_ms']:.4f} "
          f"AsinhTransform.inverse_counts_ms={i_tr:.4f} (several calls) "
          f"bound_ms={i['bound_ms']:.4f} (bytes)", flush=True)
    return recs, launches


def vjp_reading(got, ref, mag):
    """Largest |Δ| / allowance of a bf16 gradient against its f32
    reference (phase 9's per-conv allowance: the result's own bf16 rounding
    plus ``DW_RTOL`` of the same contraction over |·|)."""
    d = (got.float() - ref).abs()
    allow = (BF16_HALF_ULP * ref.abs() + DW_RTOL * mag).clamp(min=1e-30)
    return float((d / allow).max())


def check_blocked(b, d, h, w, cin, cout, seed):
    """Phase 14 at one shape: ``blocked_conv3d`` against its plain version,
    its two gradients against an f32 reference, and the planted fault."""
    import torch

    from exaspim_tpu_torch.ops import blocked_conv as bc

    name = f"{d}x{h}x{w} {cin}->{cout}"
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, d, h, w, cin), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = (torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda")
         / np.sqrt(27 * cin)).to(torch.bfloat16)
    g = (torch.randn((b, d, h, w, cout), generator=gen, device="cuda")
         * 0.1).to(torch.bfloat16)
    before = bc.blocked_conv3d.launches
    with torch.no_grad():
        y = bc.blocked_conv3d(x, k)
        plain = bc.blocked_conv3d_plain(x, k)
    torch.cuda.synchronize()
    if bc.blocked_conv3d.launches != before + 1:
        fail(f"blocked {name}: one call counted "
             f"{bc.blocked_conv3d.launches - before} launches")
    yf, pf = y.float(), plain.float()
    err, scale = float((yf - pf).abs().max()), float(pf.abs().max())
    if y.shape != plain.shape or not torch.isfinite(yf).all() \
            or err > OUT_RTOL * scale:
        fail(f"blocked {name}: output off by {err} (max |plain| {scale})")
    del yf, pf, plain

    k27 = k.reshape(27, cin, cout).float()
    ref = conv_vjp(x.float(), k27, g.float())
    mag = conv_vjp(x.float().abs(), k27.abs(), g.float().abs())

    def grads():
        xr, kr = x.clone().requires_grad_(), k.clone().requires_grad_()
        bc.blocked_conv3d(xr, kr).backward(g)
        return (vjp_reading(xr.grad, ref[0], mag[0]),
                vjp_reading(kr.grad.reshape(27, cin, cout), ref[1], mag[1]))

    before = bc.blocked_conv3d.launches
    dx, dw = grads()
    if bc.blocked_conv3d.launches != before + 2:
        fail(f"blocked {name}: forward + dL/dx counted "
             f"{bc.blocked_conv3d.launches - before} launches, expected 2")
    if max(dx, dw) > 1.0:
        fail(f"blocked {name}: gradients stray from the f32 reference "
             f"(|d|/allowance dL/dx {dx:.3f}, dL/dW {dw:.3f})")
    # Planted fault: dL/dx on channel-swapped but unflipped taps.
    flip = bc._flip_taps
    bc._flip_taps = lambda k3: k3.transpose(3, 4).contiguous()
    try:
        bad_dx, _ = grads()
    finally:
        bc._flip_taps = flip
    if bad_dx <= 1.0:
        fail(f"blocked {name}: the check missed unflipped dL/dx taps "
             f"(|d|/allowance {bad_dx:.3f})")
    print(f"blocked {name} B={b}: max|d|={err:.3e} (rel {err / scale:.2e} <= "
          f"{OUT_RTOL:.2e}); |d|/allowance dL/dx {dx:.3f}, dL/dW {dw:.3f} "
          f"(limit 1); planted unflipped taps read {bad_dx:.3g}: caught",
          flush=True)
    return {"shape": name, "batch": b, "max_abs_err": err,
            "rel_err": err / scale, "dx": dx, "dw": dw, "fault_dx": bad_dx}


def time_blocked(b, d, h, w, cin, cout):
    """``blocked_conv3d`` at one bench shape and batch, where the conv bench
    runs it: held element-wise against its plain version there (another
    grid and 64-bit offsets than the batch-2 check), then device ms beside
    the plain version's, cuDNN's (a yardstick only) and the card's bound."""
    import torch
    import torch.nn.functional as F

    from exaspim_tpu_torch.ops.blocked_conv import (
        blocked_conv3d,
        blocked_conv3d_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(d)
    x = torch.randn((b, d, h, w, cin), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    k = (torch.randn((3, 3, 3, cin, cout), generator=gen, device="cuda")
         / np.sqrt(27 * cin)).to(torch.bfloat16)
    name = f"{d}x{h}x{w} {cin}->{cout}"
    with torch.no_grad():
        y, plain = blocked_conv3d(x, k), blocked_conv3d_plain(x, k)
        # In bf16, chunked: the difference of two bf16 values is exact in f32
        # and the full f32 copies of a batch-32 output are not needed.
        err = max(float((a.float() - p.float()).abs().max())
                  for a, p in zip(y.split(4), plain.split(4)))
        scale = float(plain.abs().max())
        if y.shape != plain.shape or not torch.isfinite(y).all() \
                or err > OUT_RTOL * scale:
            fail(f"blocked {name} B={b}: output off by {err} "
                 f"(max |plain| {scale})")
        del y, plain
        ms = cuda_ms(lambda: blocked_conv3d(x, k), 10)
        plain_ms = cuda_ms(lambda: blocked_conv3d_plain(x, k), 2)
        xcl = x.permute(0, 4, 1, 2, 3)  # a channels_last_3d view
        wlib = k.permute(4, 3, 0, 1, 2).contiguous(
            memory_format=torch.channels_last_3d)
        library_ms = cuda_ms(lambda: F.conv3d(xcl, wlib, padding=1), 10)
    vox = b * d * h * w
    flops = 2.0 * 27 * cin * cout * vox
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout
    rec = {"shape": name, "batch": b, "max_abs_err": err,
           "rel_err": err / scale, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, **bound(flops, nbytes),
           "tflops": flops / ms / 1e9}
    print(f"blocked {name} B={b}: max|d|={err:.3e} (rel {err / scale:.2e} "
          f"<= {OUT_RTOL:.2e}) kernel_ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} (cuDNN) "
          f"bound_ms={rec['bound_ms']:.4f} ({rec['bound_by']}) "
          f"{rec['tflops']:.1f} TFLOP/s", flush=True)
    return rec


def blocked_kernel():
    """Phase 14; returns the check records and the batch-32 time records
    of the three bench shapes."""
    import torch

    from exaspim_tpu_torch.ops.nb_bench import SHAPES

    checks = [check_blocked(*s, seed=40 + i)
              for i, s in enumerate(BLOCKED_SHAPES)]
    torch.cuda.empty_cache()
    times = []
    for d, h, w, cin, cout in SHAPES:
        times.append(time_blocked(BENCH_BATCH, d, h, w, cin, cout))
        torch.cuda.empty_cache()
    return checks, times


def conv_bench():
    """Phase 15: the conv bench entry point at batch 32, counted."""
    import torch

    from exaspim_tpu_torch.ops import nb_bench
    from exaspim_tpu_torch.ops.blocked_conv import blocked_conv3d
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d

    blocked_conv3d.launches = nb_conv3d.launches = 0
    out = nb_bench.main(["--batch", str(BENCH_BATCH)])
    torch.cuda.synchronize()
    launches = {"blocked_conv3d": blocked_conv3d.launches,
                "nb_conv3d": nb_conv3d.launches}
    # Per shape and kernel: one warm-up chain and TIMED_CHAINS timed chains
    # of REPS applications each.
    each = len(nb_bench.SHAPES) * nb_bench.REPS * (1 + nb_bench.TIMED_CHAINS)
    print(f"conv bench launches {launches} (expected {each} each: "
          f"{len(nb_bench.SHAPES)} shapes x {nb_bench.REPS} applications x "
          f"(1 warm-up + {nb_bench.TIMED_CHAINS} timed chains))", flush=True)
    if launches != {"blocked_conv3d": each, "nb_conv3d": each}:
        fail(f"conv bench launches {launches}, expected {each} each")
    for row in out["shapes"]:
        sums = [row[f"{c}_checksum"] for c in ("library", "blocked", "nb")]
        # Three bf16 chains of 16 convs: the checksums agree loosely.
        if not np.all(np.isfinite(sums)) or \
                max(sums) - min(sums) > 0.02 * max(abs(v) for v in sums) + 1:
            fail(f"conv bench {row['label']}: checksums {sums}")
    torch.cuda.empty_cache()
    return {"launches": launches, **out}


def count_diff(a, b):
    """Of ``a`` against the reference ``b``, in counts: the largest |a − b|
    and the share of voxels that differ."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()), float((d > 0).mean())


def pipeline_path(img, ckpt):
    """Phase 16 (see the module docstring); ``img`` is phase 4's noisy
    block, mirror-tiled here to ``PIPE_N``³."""
    import torch

    from exaspim_tpu_torch.inference import (
        build_tiled_program,
        count_patches,
        plan_stream_cores,
        plan_tiling,
        predict,
    )
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
    from exaspim_tpu_torch.pipeline import _tile_plan, denoise_volume
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline
    from exaspim_tpu_torch.transforms import build_transform

    n, max_block, slab_z = PIPE_N, PIPE_MAX_BLOCK, 256
    pad = [(0, max(0, n - s)) for s in img.shape]
    vol = np.pad(img, pad, mode="symmetric")[:n, :n, :n]
    patch, batch = plan_tiling((min(n, slab_z),) + vol.shape[1:], OVERLAP)
    kw = dict(patch_size=patch, overlap=OVERLAP, trim=TRIM, batch_size=batch)
    cores = plan_stream_cores(vol.shape, patch, OVERLAP, max_block)
    cores = (min(cores[0], max(slab_z, patch)),) + tuple(cores[1:])
    plans = {
        "default_slabs": _tile_plan(vol.shape, (max(slab_z, patch),)
                                    + vol.shape[1:], patch, patch - OVERLAP),
        "forced_3axis": _tile_plan(vol.shape, cores, patch, patch - OVERLAP),
    }
    if cores[1] >= vol.shape[1] and cores[2] >= vol.shape[2]:
        fail(f"max_block_voxels={max_block} forces no y/x super-tiles "
             f"(cores {cores})")
    want = {name: sum(
        18 * -(-count_patches([hi - lo for _, _, lo, hi in tile], patch,
                              OVERLAP) // batch) for tile in plan)
        for name, plan in plans.items()}
    print(f"volume {vol.shape} {vol.dtype} (the 256^3 block mirror-tiled); "
          f"patch {patch}, batch {batch}; default plan "
          f"{len(plans['default_slabs'])} tiles, forced plan cores {cores} "
          f"{len(plans['forced_3axis'])} tiles", flush=True)
    runs = {"default_slabs": dict(slab_z=slab_z, patch_size="auto"),
            "forced_3axis": dict(slab_z=slab_z, patch_size="auto",
                                 max_block_voxels=max_block)}

    sync = torch.cuda.synchronize

    # (1) A pointwise model: nothing depends on a summation order, so the
    # streamed volumes must equal the direct one exactly.
    class DoublePlusOne(torch.nn.Module):
        def forward(self, x):
            return x * 2.0 + 0.01

    lin = build_transform({"kind": "linear", "params": {
        "mn": 0.0, "mx": 1000.0, "clip": 8.0}})
    direct = predict(vol, DoublePlusOne(), lin, **kw)
    for name, rkw in runs.items():
        got = denoise_volume(vol, DoublePlusOne(), lin, overlap=OVERLAP,
                             trim=TRIM, **rkw)
        if got.dtype != np.uint16 or not np.array_equal(got, direct):
            fail(f"pipeline {name}: the pointwise model's streamed volume "
                 "differs from the direct predict")
        print(f"pointwise model, {name}: equal to the direct predict",
              flush=True)
    del direct, got

    # (2) The shipped checkpoint.
    model, transform = restore_pipeline(ckpt, dtype=torch.bfloat16)
    rec = {"shape": list(vol.shape), "patch": patch, "batch": batch,
           "cores_forced": list(cores)}
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    direct = predict(vol, model, transform, **kw)
    sync()
    rec["direct_s"] = time.perf_counter() - t0
    again = predict(vol, model, transform, **kw)
    rec["direct_vs_direct"] = count_diff(again, direct)
    if not np.array_equal(again, direct):
        fail(f"two direct predicts of the same volume differ: "
             f"{rec['direct_vs_direct']}")
    del again
    rec["peak_mem_direct_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"direct predict {rec['direct_s']:.3f} s "
          f"({vol.size / rec['direct_s']:.1f} voxels/s), peak device memory "
          f"{rec['peak_mem_direct_gb']} GiB; a second direct run is "
          "bit-equal", flush=True)
    order = (("default_slabs", "cold"), ("default_slabs", "warm"),
             ("forced_3axis", "once"))
    for name, tag in order:
        torch.cuda.reset_peak_memory_stats()
        nb_conv3d.launches = nb_conv3d.reduce_launches = 0
        sync()
        t0 = time.perf_counter()
        out = denoise_volume(vol, model, transform, overlap=OVERLAP,
                             trim=TRIM, **runs[name])
        sync()
        wall = time.perf_counter() - t0
        mx, share = count_diff(out, direct)
        r = {"wall_s": wall, "voxels_per_s": vol.size / wall,
             "launches": nb_conv3d.launches,
             "reduce_launches": nb_conv3d.reduce_launches, "max_counts": mx,
             "share_differ": share,
             "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
        rec[f"{name}_{tag}"] = r
        print(f"{name} ({tag}): {wall:.3f} s, {vol.size / wall:.1f} voxels/s "
              f"(host clock, reader thread and copies included); nb_conv3d "
              f"launches {r['launches']}, reduce {r['reduce_launches']} "
              f"(expected {want[name]} each); vs direct: max {mx} "
              f"count(s), share differing {share:.3e} (both must be 0); "
              f"peak device memory {r['peak_mem_gb']} GiB",
              flush=True)
        if out.shape != vol.shape or out.dtype != np.uint16:
            fail(f"pipeline {name}: output {out.shape} {out.dtype}")
        if r["launches"] != want[name] or r["reduce_launches"] != want[name]:
            fail(f"pipeline {name}: {r['launches']} conv launches and "
                 f"{r['reduce_launches']} reduce launches, expected "
                 f"{want[name]} each")
        if not np.array_equal(out, direct):
            fail(f"pipeline {name}: the streamed volume differs from the "
                 f"direct predict (max {mx} counts on a share {share:.3e})")
    del out, direct

    phase("pipeline: profile of one default streamed run")
    rec["profile"] = profile_once(lambda: denoise_volume(
        vol, model, transform, overlap=OVERLAP, trim=TRIM,
        **runs["default_slabs"]))

    # The device-only rate of the default plan's first block: the same
    # tiled program on a device-resident block, synchronized.
    (_, _, lo, hi), _, _ = plans["default_slabs"][0]
    block = vol[lo:hi]
    program, starts = build_tiled_program(
        model, transform, block.shape, patch, OVERLAP, TRIM, batch,
        return_float=True)
    dblock = torch.from_numpy(block.astype(np.float32)).cuda()

    def device_run():
        with torch.inference_mode():
            s = program(dblock, starts).sum()
        sync()
        return float(s)

    device_run()
    t0 = time.perf_counter()
    for _ in range(2):
        device_run()
    dt = (time.perf_counter() - t0) / 2
    rec["device_only_block"] = {"block": list(block.shape), "s": dt,
                                "voxels_per_s": block.size / dt}
    print(f"device-only block {block.shape}: {dt:.3f} s, "
          f"{block.size / dt:.1f} voxels/s (device-resident input, result "
          "left on the device)", flush=True)
    return rec


def evaluation_path(img, clean, ckpt):
    """Phase 17 (see the module docstring) on phase 4's block."""
    import importlib.util

    import torch

    from exaspim_tpu_torch import evaluate as ev
    from exaspim_tpu_torch.compression import best_codec
    from exaspim_tpu_torch.inference import predict_patch
    from exaspim_tpu_torch.ops import bm4d_match as tm
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    voxels, side, crop, dtype = EVAL_VOXELS, PATCH, 128, torch.bfloat16
    out_dir = os.path.join(WORK, "evaluate")

    def read_patch(brain_id, voxel):
        z, y, x = voxel
        return img[z:z + side, y:y + side, x:x + side]

    def rmse(a, b):
        return float(np.sqrt(np.mean(
            (a.astype(np.float64) - b.astype(np.float64)) ** 2)))

    try:
        best_codec()
        codec = True
    except RuntimeError as exc:
        codec = False
        print(f"no exact codec ({exc}): the codec-free half runs",
              flush=True)
    rec = {"codec": codec}
    counters = (tm.match_topk, tm.match_distances, tm.select_topk)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    if codec:
        mips = importlib.util.find_spec("matplotlib") is not None
        blocks = {f"crop{i}": img[o:o + crop, o:o + crop, o:o + crop]
                  for i, o in enumerate((0, img.shape[0] - crop))}
        sup = ev.SupervisedEvaluator(
            blocks, os.path.join(out_dir, "supervised"), save_mips=mips,
            patch_size="auto", dtype=dtype)
        df = sup.run(ckpt)
        print(df.to_string(index=False), flush=True)
        if len(df) != 2 or not np.isfinite(df["ssim"]).all() \
                or not (df["cratio_gain"] > 1.0).all():
            fail(f"supervised evaluation: {df.to_dict('records')}")
        rec["supervised"] = df.to_dict("records")
        uns = ev.UnsupervisedEvaluator(
            read_patch, os.path.join(out_dir, "unsupervised"),
            sigma_gt=BM_SIGMA, dtype=dtype)
        uns.ingest_model(ckpt)
        key = ("val", "foreground", "phantom")
        df = uns.run({key: list(voxels)})[key]
        print(df.to_string(index=False), flush=True)
        rows = df.to_dict("records")
    else:
        model, transform = restore_pipeline(ckpt, dtype=dtype)
        rows = []
        for v in voxels:
            noise = read_patch("phantom", v)
            gt = ev.bm4d_ground_truth(noise, BM_SIGMA)
            pred = predict_patch(noise, model, transform)
            z, y, x = v
            ref = clean[z:z + side, y:y + side, x:x + side]
            rows.append({"voxel": str(v),
                         **ev.quality_metrics(noise, gt, pred),
                         "rmse_noise": rmse(noise, ref),
                         "rmse_gt": rmse(gt, ref),
                         "rmse_pred": rmse(pred, ref)})
            print(rows[-1], flush=True)
            if pred.shape != noise.shape or pred.dtype != np.uint16 \
                    or not rows[-1]["rmse_gt"] < rows[-1]["rmse_noise"] \
                    or not rows[-1]["rmse_pred"] < rows[-1]["rmse_noise"]:
                fail(f"evaluation at {v}: {rows[-1]}")
    rec["seconds"] = time.perf_counter() - t0
    rec["unsupervised"] = rows
    launches = {fn.__name__: fn.launches for fn in counters}
    want = {"match_topk": 2 * len(voxels), "match_distances": 0,
            "select_topk": 0}
    print(f"evaluation of {len(voxels)} voxels of {side}^3 in "
          f"{rec['seconds']:.2f} s; matcher launches {launches} (expected "
          f"{want}: one fused launch per stage, 2 stages per ground truth)",
          flush=True)
    if launches != want:
        fail(f"evaluation launches {launches}, expected {want}")
    for r in rows:
        # SSIM lies in [-1, 1]; a patch of background only (the first voxel)
        # has nothing but noise for structure, so its SSIM against the noisy
        # patch may be negative. The model must stand nearer its ground
        # truth than the noisy patch it was given.
        vals = [r[c] for c in ("ssim_noise", "ssim_gt", "l1_gt", "lmax_gt")]
        if not np.all(np.isfinite(vals)) or not -1 <= r["ssim_noise"] <= 1 \
                or not r["ssim_noise"] < r["ssim_gt"] <= 1 \
                or r["l1_gt"] < 0 or r["lmax_gt"] < r["l1_gt"]:
            fail(f"evaluation metrics: {r}")
    rec["launches"] = launches
    return rec


def run_events(out):
    """The events of the one training session under ``out``."""
    (log,) = glob.glob(os.path.join(out, "session-*", "log.jsonl"))
    with open(log) as f:
        return [json.loads(line) for line in f]


def demo_path():
    """Phase 18 (see the module docstring). Returns the record and the
    caches' directories."""
    import functools

    import torch

    from exaspim_tpu_torch import demo_end_to_end as demo
    from exaspim_tpu_torch.compression.proxy import chunk_byte_histograms
    from exaspim_tpu_torch.ops.bm4d_match import match_topk
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train import train_bm4dnet

    out = os.path.join(WORK, "demo")
    shutil.rmtree(out, ignore_errors=True)
    counters = (match_topk, nb_conv3d, nb_conv3d_dw, chunk_byte_histograms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    nb_conv3d.reduce_launches = 0
    # The demo's flags at their defaults; the loss read at every step
    # (log_every=1, not the default 50) so that the trend has 128 points.
    every_step = functools.partial(train_bm4dnet.train, log_every=1)
    t0 = time.perf_counter()
    with swapped(train_bm4dnet, train=every_step):
        summary = demo.main(["--out", out])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    launches["nb_conv3d_reduce"] = nb_conv3d.reduce_launches
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [e["loss"] for e in run_events(os.path.join(out, "run"))
              if e["event"] == "train"]
    stages = {k: summary[k] for k in ("cache_build_s", "train_s",
                                      "predict_128c_s")}
    print(f"demo in {wall:.1f} s; stages {stages}", flush=True)
    print(json.dumps(summary), flush=True)
    print(f"launches during the demo {launches}; peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)
    print(f"losses: first {losses[:3]}, last {losses[-3:]} "
          f"({len(losses)} steps)", flush=True)
    scores = [summary[k] for k in (
        "psnr_vs_clean_raw", "psnr_vs_clean_denoised", "ssim_vs_clean_raw",
        "ssim_vs_clean_denoised")]
    gain = summary["cratio_proxy_gain"]
    if not losses or not np.all(np.isfinite(losses)) \
            or not np.mean(losses[-3:]) < losses[0]:
        fail(f"demo losses: {losses}")
    if not np.all(np.isfinite(scores)):
        fail(f"demo PSNR / SSIM not finite: {scores}")
    if not (np.isfinite(gain) and gain > 1.0):
        fail(f"demo proxy gain {gain}")
    idle = [k for k, v in launches.items() if k != "nb_conv3d_reduce"
            and v < 1]
    if idle:
        fail(f"the demo never launched {idle}")
    return {"wall_s": wall, "summary": summary, "launches": launches,
            "peak_mem_gb": peak_gb, "losses": losses}, (
        os.path.join(out, "cache_train"), os.path.join(out, "cache_val"))


def resume_path(train_dir, val_dir):
    """Phase 19 (see the module docstring) on phase 18's caches."""
    import torch

    from exaspim_tpu_torch.data.cache import (
        CachedPatchDataset,
        CachedValidateDataset,
        load_cache_transform,
    )
    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train import state as ts
    from exaspim_tpu_torch.train.train_bm4dnet import (
        CHECKPOINT_WEIGHTS,
        train,
    )
    from exaspim_tpu_torch.train.trainer import Trainer
    from exaspim_tpu_torch.transforms import build_transform

    steps = len(CachedPatchDataset([train_dir])) // DEMO_BATCH
    cfg = dict(batch_size=DEMO_BATCH, val_every=steps, seed=42,
               max_val_examples=8, exact_cratio_examples=0, device="cuda")

    def params(trainer):
        return {k: v.detach().float().cpu().clone()
                for k, v in trainer.state.params.items()}

    def gap(a, b):
        return max(float((a[k] - b[k]).abs().max()) for k in a)

    t0 = time.perf_counter()
    straight = [params(train([train_dir], [val_dir], os.path.join(
        WORK, f"straight{i}"), epochs=2, **cfg)) for i in range(2)]

    class Preempted(Exception):
        pass

    save = Trainer.validate_and_checkpoint

    def preempt(self, *args):
        save(self, *args)
        raise Preempted

    cut = os.path.join(WORK, "cut")
    with swapped(Trainer, validate_and_checkpoint=preempt):
        try:
            train([train_dir], [val_dir], cut, epochs=2, **cfg)
        except Preempted:
            pass
        else:
            fail("the preempted run did not stop at its first validation")
    (latest,) = glob.glob(os.path.join(cut, "session-*", "checkpoints",
                                       "latest_state.ckpt"))
    transform = build_transform(load_cache_transform([train_dir, val_dir]))
    resumed = Trainer(os.path.join(WORK, "resumed"),
                      UNet(width_multiplier=1.0, dtype=torch.bfloat16),
                      transform, epochs=2, lr=1e-3,
                      checkpoint_weights=CHECKPOINT_WEIGHTS, **cfg)
    resumed.state = resumed.run(CachedPatchDataset([train_dir]),
                                CachedValidateDataset([val_dir]),
                                resume_state=latest)
    got = params(resumed)
    d_runs, d_resume = gap(straight[0], straight[1]), gap(straight[0], got)
    bit_equal = all(torch.equal(straight[0][k], got[k]) for k in got)
    print(f"2 epochs ({2 * steps} steps) straight vs 1 + resume + 1: max "
          f"|d| {d_resume:.3e} (bit-equal: {bit_equal}); two straight runs "
          f"max |d| {d_runs:.3e}; limit {RESUME_ATOL}", flush=True)
    if resumed.state.step != 2 * steps or not d_resume <= RESUME_ATOL:
        fail(f"resume: step {resumed.state.step}, max |d| {d_resume}")
    resume_s = time.perf_counter() - t0

    codes, orient = [], ts.orient_batch

    def spy(batch, code):
        codes.append(code)
        return orient(batch, code)

    with swapped(ts, orient_batch=spy):
        t = train([train_dir], [val_dir], os.path.join(WORK, "augment"),
                  epochs=1, augment=True, log_every=1, **cfg)
    want = [ts.orientation_code(42, i) for i in range(steps)]
    losses = [e["loss"] for e in run_events(t.output_dir)
              if e["event"] == "train"]
    print(f"augment=True: {steps} steps, codes {codes}, losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    if codes != want:
        fail(f"augment applied the codes {codes}, expected {want}")
    if len(losses) != steps or not np.all(np.isfinite(losses)):
        fail(f"augmented losses {losses}")
    return {"steps_per_epoch": steps, "resume_max_abs": d_resume,
            "resume_bit_equal": bit_equal, "runs_max_abs": d_runs,
            "resume_s": resume_s, "augment_codes": codes,
            "augment_losses": losses}


def reference_state_dict(sd, trilinear=True):
    """The port's state dict (f32 CPU tensors) in the upstream reference's
    torch key layout (``inc``, ``down{i}.maxpool_conv.1``, ``up{i}.conv``,
    ``up{i}.up``, ``outc.conv``): what ``import_torch_checkpoint`` reads.
    Convs without a bias get zero biases, as the reference's all have."""
    import torch

    out = {}

    def double_conv(prefix, name):
        for i, (ci, gi) in enumerate(((0, 1), (3, 4))):
            k = sd[f"{name}.Conv_{i}.kernel"]
            cin, cout = k.shape[1:]
            out[f"{prefix}.{ci}.weight"] = k.reshape(
                3, 3, 3, cin, cout).permute(4, 3, 0, 1, 2).contiguous()
            out[f"{prefix}.{ci}.bias"] = sd.get(f"{name}.Conv_{i}.bias",
                                                torch.zeros(cout))
            out[f"{prefix}.{gi}.weight"] = sd[f"{name}.GroupNorm_{i}.scale"]
            out[f"{prefix}.{gi}.bias"] = sd[f"{name}.GroupNorm_{i}.bias"]

    double_conv("inc.double_conv", "DoubleConv_0")
    for i in range(1, 5):
        double_conv(f"down{i}.maxpool_conv.1.double_conv", f"DoubleConv_{i}")
        double_conv(f"up{i}.conv.double_conv", f"Up_{i - 1}.DoubleConv_0")
        if not trilinear:
            ct = f"Up_{i - 1}.ConvTranspose_0"
            out[f"up{i}.up.weight"] = sd[f"{ct}.kernel"].flip(
                0, 1, 2).permute(3, 4, 0, 1, 2).contiguous()
            out[f"up{i}.up.bias"] = sd[f"{ct}.bias"]
    head = sd["Conv_0.kernel"]
    out["outc.conv.weight"] = head.t().reshape(1, -1, 1, 1, 1).contiguous()
    out["outc.conv.bias"] = sd["Conv_0.bias"]
    return {k: v.detach().float().cpu().clone() for k, v in out.items()}


def reference_files(transform_cfg):
    """Phase 20's four reference-format checkpoints under ``WORK``:
    ``{name: (path, note)}``."""
    import torch

    from exaspim_tpu_torch.models import UNet
    from exaspim_tpu_torch.train.checkpoint import (
        load_checkpoint,
        params_from_flax,
    )

    out = os.path.join(WORK, "reference")
    os.makedirs(out, exist_ok=True)
    shipped = reference_state_dict(params_from_flax(
        load_checkpoint(CKPT)["params"]))
    cfg = {"model": "UNet", "width_multiplier": 1.0, "trilinear": True}
    gen = torch.Generator().manual_seed(0)
    biased = {k: v + REF_BIAS_SIGMA * torch.randn(v.shape, generator=gen)
              if k.endswith(("0.bias", "3.bias")) and "double_conv" in k
              else v for k, v in shipped.items()}
    # (d): seeded weights, a head drawn from a normal (the reference's
    # torch head is no identity), conv biases of the same spread, and a
    # linear transform (a random model's logits through the asinh
    # inverse would reach ~1e14 counts).
    tconv = UNet(trilinear=False, conv_bias=True,
                 head_init="normal").init_weights(1)
    gen = torch.Generator().manual_seed(1)
    tsd = {k: v + REF_BIAS_SIGMA * torch.randn(v.shape, generator=gen)
           if k.endswith("bias") else v
           for k, v in tconv.state_dict().items()}
    linear = {"kind": "linear", "params": {"mn": 0.0, "mx": 8000.0,
                                           "clip": 8.0}}
    files = {
        "a": ({"model": shipped, "transform": transform_cfg,
               "model_config": cfg}, "shipped weights, zero conv biases, "
              "dict format"),
        "b": (shipped, "the same weights, a legacy bare state dict"),
        "c": ({"model": biased, "transform": transform_cfg,
               "model_config": cfg}, f"conv biases ~ N(0, "
              f"{REF_BIAS_SIGMA}) from seed 0"),
        "d": ({"model": reference_state_dict(tsd, trilinear=False),
               "transform": linear}, "width-1.0 trilinear=False UNet, "
              "seeded weights and biases, config inferred"),
    }
    paths = {}
    for name, (obj, note) in files.items():
        paths[name] = (os.path.join(out, f"{name}.pth"), note)
        torch.save(obj, paths[name][0])
    return paths


def reference_path(img, clean, checked, patch, batch, quality,
                   transform_cfg):
    """Phase 20 (see the module docstring). ``checked``: the conv keys
    ``(batch, n, segs, cout)`` phase 3 held; ``quality``: phase 5's
    record. Returns the record."""
    import torch

    from exaspim_tpu_torch.ckpt_quality import proxy_ratios
    from exaspim_tpu_torch.ckpt_quality import score as quality_score
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_plain
    from exaspim_tpu_torch.train.checkpoint import import_torch_checkpoint

    paths = reference_files(transform_cfg)
    rec = {"models": {}, "new_shapes": [], "conv_checks": []}
    models = {}
    for name, (path, note) in paths.items():
        model, transform = import_torch_checkpoint(path, device="cuda")
        models[name] = (model, transform)
        print(f"({name}) {note}: imported as {model.config}; transform "
              f"{transform.cfg}", flush=True)
        rec["models"][name] = {"config": model.config,
                               "transform": transform.cfg}
    sa, sb = (models[k][0].state_dict() for k in "ab")
    if sa.keys() != sb.keys() or not all(torch.equal(sa[k], sb[k])
                                         for k in sa):
        fail("the dict and the legacy file imported to other parameters")
    print("(a) and (b): equal parameters", flush=True)

    # Every conv shape at the block's tile plan; the shapes phase 3 did
    # not hold are held here.
    x = torch.zeros((batch, patch, patch, patch, 1), device="cuda")
    seen = Counter()
    for name, (model, _) in models.items():
        with torch.no_grad():
            shapes = launch_shapes(lambda: model(x))
        rec["models"][name]["conv_shapes"] = sorted(
            [list(k[1:3]) + [list(k[3]), k[4]] for k in shapes])
        seen.update({k[1:]: v for k, v in shapes.items()})
    new = sorted(k for k in seen if k not in checked)
    print(f"{len(seen)} conv shapes at B={batch}, {patch}^3 patches; new "
          f"to phase 3: {[shape_name(*k[1:]) for k in new]}", flush=True)
    with torch.no_grad():
        rec["conv_checks"] = [check_kernel(*k, seed=300 + i)
                              for i, k in enumerate(new)]
    rec["new_shapes"] = [list(k) for k in new]
    rec["conv_counts"] = [seen[k] for k in new]

    n_batches = -(-27 // batch)
    crop = img[:48, :48, :48]
    for name in "cd":
        model, transform = models[name]

        def run():
            with torch.no_grad():
                return predict(img, model, transform, patch_size="auto",
                               overlap=OVERLAP, trim=TRIM)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        nb_conv3d.launches = nb_conv3d.reduce_launches = 0
        out = run()
        launches = (nb_conv3d.launches, nb_conv3d.reduce_launches)
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        want = 18 * n_batches
        print(f"({name}) predict 256^3: conv launches {launches[0]}, reduce "
              f"{launches[1]} (expected {want} each); seconds {times} "
              f"(median {np.median(times):.4f}); peak device memory "
              f"{peak:.2f} GiB", flush=True)
        if launches != (want, want) or out.shape != img.shape \
                or out.dtype != np.uint16:
            fail(f"({name}) predict: launches {launches}, output "
                 f"{out.shape} {out.dtype}")
        # Phase 10b's check on a 48^3 crop: the card's kernel path against
        # the plain path on the card (bf16) and the f32 CPU path.
        kw = dict(patch_size=32, overlap=OVERLAP, trim=TRIM, batch_size=8,
                  return_float=True)
        with torch.no_grad():
            got = predict(crop, model, transform, **kw)
            with patched(_conv=lambda xs, k, with_stats: nb_conv3d_plain(
                    xs, k, with_stats)):
                plain = predict(crop, model, transform, **kw)
            cpu, _ = import_torch_checkpoint(paths[name][0], device="cpu")
            ref = predict(crop, cpu, transform, device="cpu", **kw)
        change = np.linalg.norm(ref - crop)
        rel_b = float(np.linalg.norm(got - plain)
                      / max(np.linalg.norm(plain - crop), 1e-30))
        rel = float(np.linalg.norm(got - ref) / max(change, 1e-30))
        print(f"({name}) 48^3 crop: rel L2 of the change vs the plain path "
              f"on the card {rel_b:.3e} (limit {WIDTH_PREDICT_REL_BF16}), "
              f"vs CPU f32 {rel:.3e} (limit {WIDTH_PREDICT_REL_F32}); "
              f"|change| {change:.1f}", flush=True)
        if not np.isfinite(got).all() or rel_b > WIDTH_PREDICT_REL_BF16 \
                or rel > WIDTH_PREDICT_REL_F32:
            fail(f"({name}) crop strays: {rel_b}, {rel}")
        rec["models"][name].update({
            "launches": launches[0], "reduce_launches": launches[1],
            "block_s": times, "seconds_per_block": float(np.median(times)),
            "peak_mem_gb": peak, "crop_rel_l2_vs_plain_bf16": rel_b,
            "crop_rel_l2_vs_cpu_f32": rel})
        del cpu

    # (a): the shipped net under the reference's align_corners=True grid,
    # scored beside phase 5 (information, not gated).
    model, transform = models["a"]
    with torch.no_grad():
        out = predict(img, model, transform, patch_size="auto",
                      overlap=OVERLAP, trim=TRIM)
    s = quality_score(out, clean, None, device="cuda")
    p_noisy, p_out = proxy_ratios([img, out], "cuda")
    a = {"psnr_denoised_db": s["psnr_db"], "ssim_denoised": s["ssim"],
         "proxy_gain": p_out / p_noisy}
    rec["models"]["a"]["quality"] = a
    print(f"(a) align_corners=True: PSNR {a['psnr_denoised_db']:.4f} dB "
          f"(phase 5: {quality['psnr_denoised_db']:.4f}), SSIM "
          f"{a['ssim_denoised']:.6f} ({quality['ssim_denoised']:.6f}), "
          f"proxy gain {a['proxy_gain']:.4f} ({quality['proxy_gain']:.4f}); "
          "not gated", flush=True)
    return rec


def n2v_step_check():
    """Phase 21 (a): one ``make_n2v_train_step`` step on the card against
    the same step on the CPU (f32) from the same parameters, batch and
    key, plain and σ-aware. Returns the record."""
    import torch

    from exaspim_tpu_torch.data.loader import to_tensor
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.models import N2V2UNet
    from exaspim_tpu_torch.train import prng
    from exaspim_tpu_torch.train.n2v import (
        make_blind_spots,
        make_n2v_train_step,
    )
    from exaspim_tpu_torch.train.checkpoint import params_to_flax
    from exaspim_tpu_torch.train.state import create_train_state
    from exaspim_tpu_torch.train.train_n2v import TRANSFORM
    from exaspim_tpu_torch.transforms import build_transform

    batch = np.stack([noisy_observation(neurite_phantom(
        (PATCH,) * 3, n_tubes=6, seed=i)[0], seed=7 * i)
        for i in range(N2V_CHECK_BATCH)])[..., None]
    key = prng.fold_in(prng.key(0), 3)
    shape = (N2V_CHECK_BATCH,) + (PATCH,) * 3
    m_card, s_card = make_blind_spots(key, shape, device="cuda")
    m_cpu, s_cpu = make_blind_spots(key, shape, device="cpu")
    same = torch.equal(m_card.cpu(), m_cpu) and torch.equal(s_card, s_cpu)
    print(f"blind spots at {shape}: {int(m_cpu.sum())} masked, shifts "
          f"{s_cpu.tolist()}; card and CPU bit-equal: {same}", flush=True)
    if not same:
        fail("the card's blind-spot draw differs from the CPU's")
    kw = dict(width_multiplier=0.5, head_init="normal", residual=False)
    init = params_to_flax(N2V2UNet(**kw).init_weights(0).state_dict())
    rec = {"masked": int(m_cpu.sum())}
    for sigma_gain in (None, 1.0):
        states, grads, losses = {}, {}, {}
        for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
            model = N2V2UNet(dtype=dtype, **kw).to(dev)
            state = create_train_state(model, lr=1e-3, total_steps=10,
                                       params=init)
            step = make_n2v_train_step(build_transform(TRANSFORM),
                                       sigma_gain=sigma_gain)
            apply = state.apply_gradients

            def snapshot(apply=apply, dev=dev, model=model):
                grads[dev] = {n: p.grad.detach().float().cpu().clone()
                              for n, p in model.named_parameters()}
                return apply()

            state.apply_gradients = snapshot
            _, loss = step(state, to_tensor(batch, dev), key)
            losses[dev] = float(loss)
            states[dev] = {n: p.detach().float().cpu()
                           for n, p in model.named_parameters()}
        loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
        grad_rel = {n: float((grads["cuda"][n] - grads["cpu"][n]).norm()
                             / grads["cpu"][n].norm().clamp(min=1e-30))
                    for n in grads["cpu"]}
        worst_n = max(grad_rel, key=grad_rel.get)
        flat = {d: torch.cat([g.reshape(-1) for g in grads[d].values()])
                for d in grads}
        whole = float((flat["cuda"] - flat["cpu"]).norm()
                      / flat["cpu"].norm())
        diff = torch.cat([(states["cuda"][n] - states["cpu"][n]).reshape(-1)
                          for n in states["cpu"]]).abs()
        moved, flipped = float(diff.max()), float((diff > 1e-6).float().mean())
        label = "plain" if sigma_gain is None else f"sigma_gain={sigma_gain}"
        print(f"N2V step ({label}), batch {N2V_CHECK_BATCH} of {PATCH}^3, "
              f"width 0.5: loss card {losses['cuda']:.6f} CPU "
              f"{losses['cpu']:.6f} (rel {loss_rel:.2e} <= "
              f"{N2V_LOSS_RTOL[sigma_gain]}); gradients: whole rel L2 {whole:.3e} (<= "
              f"{N2V_GRAD_REL_L2}), per parameter median "
              f"{float(np.median(list(grad_rel.values()))):.3e}, worst "
              f"{grad_rel[worst_n]:.3e} ({worst_n}); updated params max "
              f"|d| {moved:.3e} (<= {N2V_PARAM_ATOL}), share apart by more "
              f"than 1e-6 {flipped:.4f} (<= {N2V_FLIP_SHARE})", flush=True)
        if not np.isfinite(losses["cuda"]) \
                or loss_rel > N2V_LOSS_RTOL[sigma_gain] \
                or whole > N2V_GRAD_REL_L2 or moved > N2V_PARAM_ATOL \
                or flipped > N2V_FLIP_SHARE:
            fail(f"N2V step ({label}) on the card strays from the CPU's")
        rec[label] = {"loss_card": losses["cuda"], "loss_cpu": losses["cpu"],
                      "loss_rel": loss_rel, "grad_rel_l2": grad_rel,
                      "grad_rel_l2_whole": whole, "param_max_abs": moved,
                      "param_share_apart": flipped}
    return rec


def n2v_step_kernels():
    """Phase 21 (b): record the launch shapes of one N2V step at the
    script's defaults (batch 16 of 64³, width 0.5), then hold and time each
    as phase 7 does. Returns the conv and dL/dW records with their launches
    per step."""
    import torch

    from exaspim_tpu_torch.models import N2V2UNet
    from exaspim_tpu_torch.train import prng
    from exaspim_tpu_torch.train.n2v import make_n2v_train_step
    from exaspim_tpu_torch.train.state import create_train_state
    from exaspim_tpu_torch.train.train_n2v import TRANSFORM
    from exaspim_tpu_torch.transforms import build_transform

    state = create_train_state(N2V2UNet(
        width_multiplier=0.5, head_init="normal", residual=False,
        dtype=torch.bfloat16).cuda(), lr=1e-3, total_steps=10)
    step = make_n2v_train_step(build_transform(TRANSFORM))
    x = torch.full((16,) + (PATCH,) * 3 + (1,), 300, dtype=torch.int16,
                   device="cuda")
    shapes = launch_shapes(lambda: (step(state, x, prng.key(0)),
                                    torch.cuda.synchronize()))
    del state, x
    kinds = Counter()
    for (kind, *_), c in shapes.items():
        kinds[kind] += c
    if (kinds["fwd"], kinds["dx"], kinds["dw"]) != (18, 17, 18):
        fail(f"one N2V step launched {dict(kinds)}, expected fwd 18, dx 17, "
             "dw 18")
    conv, dw = {"recs": [], "counts": []}, {"recs": [], "counts": []}
    with torch.no_grad():
        for i, ((kind, b, n, segs, cout), c) in enumerate(
                sorted(shapes.items())):
            if kind == "dw":
                dw["recs"].append(check_dw(b, n, segs, cout, seed=400 + i))
                dw["counts"].append(c)
            else:
                conv["recs"].append(check_kernel(
                    b, n, segs, cout, seed=400 + i, stats=kind == "fwd"))
                conv["counts"].append(c)
            torch.cuda.empty_cache()
    for name, d in (("nb_conv3d", conv), ("nb_conv3d_dw", dw)):
        t = per_step(d["recs"], d["counts"])
        print(f"{name} per N2V step ({sum(d['counts'])} launches): kernel "
              f"{t['ms']:.3f} ms, plain {t['plain_ms']:.3f} ms, library "
              f"{t['library_ms']:.3f} ms, bound {t['bound_ms']:.3f} ms "
              f"({t['bound_by']})", flush=True)
    return conv, dw


def n2v_path():
    """Phase 21 (see the module docstring). Returns the record."""
    import torch

    from exaspim_tpu_torch.compression.proxy import chunk_byte_histograms
    from exaspim_tpu_torch.ops import nb_conv as nc
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train import n2v, train_n2v

    rec = {"step_check": n2v_step_check()}
    rec["conv"], rec["dw"] = n2v_step_kernels()
    out = os.path.join(WORK, "n2v")
    shutil.rmtree(out, ignore_errors=True)
    losses = []
    make = n2v.make_n2v_train_step

    def recording(*args, **kw):
        step = make(*args, **kw)

        def run(state, x, key):
            state, loss = step(state, x, key)
            losses.append(loss)  # read after the run: no sync per step
            return state, loss

        return run

    counters = (nb_conv3d, nb_conv3d_dw, chunk_byte_histograms)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    nb_conv3d.reduce_launches = 0
    t0 = time.perf_counter()
    with swapped(n2v, make_n2v_train_step=recording):
        shapes, conv = Counter(), nc._conv

        def spy(xs, k, with_stats):
            shapes["fwd" if with_stats else "dx"] += 1
            return conv(xs, k, with_stats)

        with patched(_conv=spy):
            summary = train_n2v.main(["--out", out, "--steps",
                                      str(N2V_STEPS), "--n-patches",
                                      str(N2V_PATCHES)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    launches["nb_conv3d_reduce"] = nb_conv3d.reduce_launches
    launches.update({f"nb_conv3d_{k}": v for k, v in shapes.items()})
    losses = [float(v) for v in losses]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_n2v in {wall:.1f} s; step_s {summary['step_s']} (the "
          f"window from step 200 to {N2V_STEPS - 1}); peak device memory "
          f"{peak:.2f} GiB", flush=True)
    print(json.dumps({k: v for k, v in summary.items() if k != "train_log"}),
          flush=True)
    print(f"launches {launches}; losses: first {losses[:3]}, mean of the "
          f"first 20 {np.mean(losses[:20]):.5f}, of the last 50 "
          f"{np.mean(losses[-50:]):.5f}", flush=True)
    want = {"nb_conv3d_fwd": 18 * N2V_STEPS + 18 * 4,
            "nb_conv3d_dx": 17 * N2V_STEPS,
            "nb_conv3d_dw": 18 * N2V_STEPS, "chunk_byte_histograms": 1}
    scores = [summary[k] for k in ("psnr_noisy_db", "psnr_denoised_db",
                                   "ssim_noisy", "ssim_denoised",
                                   "cratio_proxy_gain")]
    if not np.all(np.isfinite(losses)) \
            or not np.mean(losses[-50:]) < np.mean(losses[:20]):
        fail(f"N2V losses do not fall: {losses[:20]} ... {losses[-50:]}")
    if not np.all(np.isfinite(scores)):
        fail(f"N2V scores not finite: {scores}")
    if any(launches[k] != v for k, v in want.items()):
        fail(f"N2V launches {launches}, expected {want}")
    rec.update({"wall_s": wall, "summary": summary, "launches": launches,
                "peak_mem_gb": peak, "losses": losses})
    return rec


def print_ptxas(build, name):
    for line in build.build_log(name).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())


def profile_once(run, key=("nb_conv3d_kernel", "nb_stats_reduce"),
                 warm=False):
    """Device time by kernel over one run of ``run`` (torch.profiler);
    ``key`` (a name fragment, or a tuple of them) names the kernels whose
    time and launch count are reported, each fragment on its own and
    summed. ``warm`` first makes one discarded run inside the profiler's
    warm-up step, so that a short run's first launches are traced too."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    keys = (key,) if isinstance(key, str) else tuple(key)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)
                 if warm else None) as prof:
        if warm:
            run()
            torch.cuda.synchronize()
            prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        # Device-side events only (kernels, memcpy, memset): the CPU-side
        # aten ops would count their kernels' time a second time.
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith("ProfilerStep"):  # the step's own span
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
    by_key = {k: [sum(r[0] for r in rows if k in r[1]) / 1e6,
                  sum(r[2] for r in rows if k in r[1])] for k in keys}
    conv_s = sum(v[0] for v in by_key.values())
    key_launches = sum(v[1] for v in by_key.values())
    print(f"profile: wall {wall:.4f} s, device busy {busy_s:.4f} s "
          f"(idle share {max(0.0, 1 - busy_s / wall):.3f}), of which "
          + " + ".join(f"{k} kernels {v[0]:.4f} s in {v[1]} launches"
                       for k, v in by_key.items())
          + (f" = {conv_s:.4f} s" if len(keys) > 1 else ""))
    for dev_us, name, count in rows[:10]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_s": wall, "device_busy_s": busy_s, "conv_s": conv_s,
            "key_launches": key_launches, "by_key": by_key,
            "top": [[name, dev_us / 1e3, count]
                    for dev_us, name, count in rows[:15]]}


def main():
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs one GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.inference import plan_tiling, predict
    from exaspim_tpu_torch.ops import _build
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
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
    if set(KERNELS) != set(_build.KERNELS):
        fail(f"the package lists the kernel sources {_build.KERNELS}")
    build_s = _build.build_all(KERNELS)
    record["build_s"] = time.time() - t0
    print(f"build_s={record['build_s']:.2f} (all seven sources, in parallel; "
          f"nb_conv3d {build_s['nb_conv3d']:.2f})", flush=True)
    print_ptxas(_build, "nb_conv3d")
    for name in ("nb_conv3d", "nb_conv3d_dw", "blocked_conv3d"):
        spills = [ln for ln in _build.build_log(name).splitlines()
                  if re.search(r"[1-9][0-9]* bytes spill", ln)]
        if spills:
            fail(f"{name} spills registers: {spills}")

    phase("kernel vs plain")
    from exaspim_tpu_torch.ops import nb_conv as nc
    from exaspim_tpu_torch.ops.nb_bench import (
        INFERENCE_SHAPES,
        unet_conv_shapes,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # The main path's own convs: the 18 forwards of one batch of patches of
    # the 256^3 block (phase 4), at its batch; phase 4 asserts that the
    # block ran exactly these plans. Then six of its shapes at batch 2
    # (nb_bench.INFERENCE_SHAPES), a fixed set to compare versions on.
    patch, batch = plan_tiling((BLOCK,) * 3, OVERLAP)
    n_batches = -(-27 // batch)
    path_shapes = Counter((batch, n, segs, cout) for kind, n, segs, cout
                          in unet_conv_shapes(patch) if kind == "fwd")
    with torch.no_grad():
        path_checks = [check_kernel(*s, seed=200 + i)
                       for i, s in enumerate(sorted(path_shapes))]
        path_counts = [n_batches * path_shapes[s]
                       for s in sorted(path_shapes)]
        checks = [check_kernel(*s, seed=i)
                  for i, s in enumerate(INFERENCE_SHAPES)]
        # Edge shapes, checked and not timed: extents that are no multiple
        # of the tile, the narrow widths, Cout = 8, two segments at 6^3, an
        # odd width (element loads), a deep-level volume (FLAT tiles).
        record["kernel_edge_checks"] = [
            check_kernel(*s, seed=100 + i, time_it=False)
            for i, s in enumerate(CONV_EDGE_SHAPES)]
    record["kernel_path_checks"] = path_checks
    record["kernel_checks"] = checks
    for label, recs, counts in (
            (f"inference path per 256^3 block ({sum(path_counts)} launches, "
             f"B={batch})", path_checks, path_counts),
            (f"six inference shapes (B={INFERENCE_SHAPES[0][0]})",
             checks, [1] * len(checks))):
        t = per_step(recs, counts)
        print(f"{label}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, library {t['library_ms']:.4f} ms, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']})", flush=True)
    modes = {r["plan"]["mode"]
             for r in path_checks + checks + record["kernel_edge_checks"]}
    if modes != {"halo", "res", "flat", "panel"}:
        fail(f"phase 3 reached the tile modes {modes}, not all four")

    phase("main path: restore + phantom")
    model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                        device="cuda")
    clean, _ = neurite_phantom((BLOCK,) * 3, n_tubes=24, seed=0)
    img = noisy_observation(clean, seed=1)
    if (patch, batch) != plan_tiling(img.shape, OVERLAP):
        fail(f"the block's tiling {plan_tiling(img.shape, OVERLAP)} is not "
             f"the ({patch}, {batch}) phase 3 checked")
    print(f"patch={patch} batch={batch} batches={n_batches}", flush=True)

    def run():
        return predict(img, model, transform, patch_size="auto",
                       overlap=OVERLAP, trim=TRIM)

    phase("main path: counted run")
    torch.cuda.reset_peak_memory_stats()
    nb_conv3d.launches = nb_conv3d.reduce_launches = 0
    plans_run, plan_fn = {}, nc._plan

    def spy_plan(*args):
        plans_run[args] = plan = plan_fn(*args)
        return plan

    t0 = time.perf_counter()
    with patched(_plan=spy_plan):
        out = run()
    first_s = time.perf_counter() - t0
    launches = nb_conv3d.launches
    reduces = nb_conv3d.reduce_launches
    want = 18 * n_batches
    print(f"first run {first_s:.4f} s, nb_conv3d launches {launches}, "
          f"reduce launches {reduces} (expected {want} each)", flush=True)
    if launches != want or reduces != want:
        fail(f"nb_conv3d launched {launches} times and its reduce {reduces},"
             f" expected {want} each")
    checked = {tuple(r["key"]): r["plan"] for r in path_checks}
    ran = {k: dict(v) for k, v in plans_run.items()}
    if ran != checked:
        fail(f"the block ran the plans {ran}; phase 3 checked {checked}")
    print(f"the block ran the {len(ran)} plans phase 3 checked", flush=True)
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
        "reduce_launches_per_block": reduces,
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
    # Scored through the port's quality check (ckpt_quality.score): PSNR,
    # SSIM and, where an exact codec is installed, the blosc-zstd ratio.
    from exaspim_tpu_torch.ckpt_quality import exact_codec, proxy_ratios
    from exaspim_tpu_torch.ckpt_quality import score as quality_score
    from exaspim_tpu_torch.compression.proxy import chunk_byte_histograms

    codec, why = exact_codec()
    s_noisy = quality_score(img, clean, codec, device="cuda")
    s_out = quality_score(out, clean, codec, device="cuda")
    q = {
        "psnr_noisy_db": s_noisy["psnr_db"],
        "psnr_denoised_db": s_out["psnr_db"],
        "ssim_noisy": s_noisy["ssim"],
        "ssim_denoised": s_out["ssim"],
    }
    q["psnr_gain_db"] = q["psnr_denoised_db"] - q["psnr_noisy_db"]
    ok = q["ssim_denoised"] >= q["ssim_noisy"] and \
        q["psnr_gain_db"] >= MIN_PSNR_GAIN_DB
    if codec is not None:
        q["cratio_noisy"] = s_noisy["cratio"]
        q["cratio_denoised"] = s_out["cratio"]
        q["cratio_gain"] = q["cratio_denoised"] / q["cratio_noisy"]
        ok = ok and q["cratio_gain"] >= MIN_CRATIO_GAIN
        print(f"cratio {q['cratio_noisy']} -> {q['cratio_denoised']} gain "
              f"{q['cratio_gain']:.4f} (>= {MIN_CRATIO_GAIN}; r05 "
              f"{REF_R05['cratio_gain']})")
    else:
        print(f"cratio: unavailable ({why})")
    print(f"psnr {q['psnr_noisy_db']:.4f} -> {q['psnr_denoised_db']:.4f} dB "
          f"gain {q['psnr_gain_db']:.4f} (>= {MIN_PSNR_GAIN_DB}; r05 "
          f"{REF_R05['psnr_gain_db']})")
    print(f"ssim {q['ssim_noisy']:.6f} -> {q['ssim_denoised']:.6f} "
          f"(not lower; r05 {REF_R05['ssim_denoised']})", flush=True)
    # The entropy proxy of the pair, from one histogram launch: printed
    # beside the guard, not part of it.
    chunk_byte_histograms.launches = 0
    q["proxy_noisy"], q["proxy_denoised"] = proxy_ratios([img, out], "cuda")
    q["proxy_gain"] = q["proxy_denoised"] / q["proxy_noisy"]
    q["proxy_launches"] = chunk_byte_histograms.launches
    print(f"entropy proxy {q['proxy_noisy']:.4f} -> "
          f"{q['proxy_denoised']:.4f} gain {q['proxy_gain']:.4f} (in "
          f"{q['proxy_launches']} chunk_byte_histograms launch; not in the "
          "guard)", flush=True)
    record["quality"] = q
    if q["proxy_launches"] != 1:
        fail(f"the proxy of the pair made {q['proxy_launches']} launches")
    if not ok:
        fail(f"quality guard: {q}")
    del model, cpu_model
    torch.cuda.empty_cache()

    phase("build (training kernels)")
    for name in KERNELS[1:3]:
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
    pair = torch.from_numpy(np.stack([img, out]).astype(np.int32)).cuda()
    hist = check_histogram(counts_f32(val_raw).to(torch.int32), pair)
    record["histogram_check"] = hist
    del val_raw, pair

    phase("gradient check: full-width UNet 32^3 B=2")
    record["grad_check"] = grad_check()

    phase("training path: train() at the default configuration")
    record["train"] = training_path(train_dir, val_dir)
    torch.cuda.empty_cache()

    phase("width 0.3 UNet on the kernels (widths no multiple of 8)")
    record["width_0_3"] = width_path(train_dir, transform_cfg)
    torch.cuda.empty_cache()

    phase("build (BM4D and asinh kernels)")
    for name in KERNELS[3:6]:
        print(f"{name}: built in {build_s[name]:.2f} s (with phase 2)")
        print_ptxas(_build, name)

    phase("fused matching kernel vs plain (block 4, step 3, search 9, "
          "group 16)")
    record["matching_checks"] = matching = matching_kernels()

    phase("teacher path: precompute() at its defaults")
    record["teachers"] = teacher_path()
    shutil.rmtree(WORK, ignore_errors=True)

    phase("asinh kernels vs plain (256^3 block)")
    asinh, asinh_launches = asinh_kernels(img, build_transform(transform_cfg))
    record["asinh_checks"] = asinh

    phase("build (blocked conv kernel)")
    print(f"blocked_conv3d: built in {build_s['blocked_conv3d']:.2f} s "
          "(with phase 2)")
    print_ptxas(_build, "blocked_conv3d")

    phase("blocked conv vs plain (halo-tile kernel, gradients, one fault)")
    record["blocked_checks"], blocked_times = blocked_kernel()
    record["blocked_times"] = blocked_times

    phase(f"conv bench: nb_bench.main at batch {BENCH_BATCH}")
    record["conv_bench"] = bench = conv_bench()

    phase(f"pipeline: denoise_volume on a {PIPE_N}^3 volume")
    record["pipeline"] = pipeline_path(img, CKPT)
    torch.cuda.empty_cache()

    phase("evaluation: BM4D ground truth and metrics on four 64^3 voxels")
    record["evaluation"] = evaluation_path(img, clean, CKPT)
    shutil.rmtree(WORK, ignore_errors=True)
    torch.cuda.empty_cache()

    phase("demo: demo_end_to_end.main at its defaults")
    record["demo"], (demo_train, demo_val) = demo_path()
    torch.cuda.empty_cache()

    phase("resume and augmentation: train() on the demo's caches")
    record["resume"] = resume_path(demo_train, demo_val)
    shutil.rmtree(WORK, ignore_errors=True)

    phase("reference checkpoints: import_torch_checkpoint -> predict")
    record["reference"] = reference_path(
        img, clean, set(path_shapes), patch, batch, record["quality"],
        transform_cfg)
    torch.cuda.empty_cache()

    phase(f"N2V: one step card vs CPU, then train_n2v for {N2V_STEPS} steps")
    record["n2v"] = n2v_path()
    shutil.rmtree(WORK, ignore_errors=True)

    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_record.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)

    # Each record reads one path. Training: launches of the counted train()
    # run; ms and bounds summed over one training step's launches (phase 7).
    # Inference: launches of one 256³ block; ms and bounds summed over the
    # block's 54 conv launches (phase 3's path shapes at the block's batch;
    # a stats launch's time includes its reduce, counted apart in
    # reduce_launches). Teachers: launches of the counted precompute()
    # run, all of the fused kernel, which carries rows 4 and 5. Row 4: the
    # fused kernel's ms per patch in the path's batches (a raw stage and a
    # stage-1 stage, per patch, phase 11), its plain version's and its
    # bound summed over the 64³ raw patch and its stage-1 estimate. Row 5:
    # the same selection routine timed alone over a table (bm4d_select.cu)
    # on those two, beside its plain version and torch.topk.
    # Row 6: the chunk entry, the one the path launches: its launches in the
    # counted train() run (one a validation batch) and, apart, the quality
    # phase's one; its ms and bound on a validation batch (32 x 64^3 int32).
    # Under "entries", each entry with its own launches and times: the row
    # entry (the TPU kernel's function, on the batch's 64 planes) makes none
    # on the path.
    # Elementwise: one launch each on the 256³ block. Conv bench: launches of
    # the counted nb_bench.main run; ms and bounds summed over its three
    # shapes at batch 32, one application each (phase 14's times).
    runs = record["train"]["launches"]
    teach = record["teachers"]["launches"]
    kernels = [{
        "name": "nb_conv3d",
        "path": "training",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:358",
        "launches": runs["nb_conv3d"],
        "reduce_launches": runs["nb_conv3d_reduce"],
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
        "name": "chunk_byte_histograms",
        "path": "training",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/byte_histogram.cu",
        "replaces": "exaspim_tpu/compression/proxy.py:58",
        "launches": runs["chunk_byte_histograms"],
        "entries": {
            "byte_histogram": {
                "launches": runs["byte_histogram"]
                - runs["chunk_byte_histograms"],
                **{k: hist["validation batch"][k] for k in (
                    "max_abs_err", "ms", "wrapper_ms", "plain_ms",
                    "library_ms", "bound_ms")}},
            "chunk_byte_histograms": {
                "launches": runs["chunk_byte_histograms"],
                "quality_launches": record["quality"]["proxy_launches"],
                **{k: hist["validation batch"]["chunk_entry"][k] for k in (
                    "max_abs_err", "ms", "wrapper_ms", "plain_ms",
                    "library_ms", "bound_ms")}}},
        **{k: hist["validation batch"]["chunk_entry"][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    }, {
        "name": "nb_conv3d (inference path)",
        "path": "inference",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/nb_conv3d.cu",
        "replaces": "exaspim_tpu/ops/nb_conv.py:358",
        "launches": record["launches_per_block"],
        "reduce_launches": record["reduce_launches_per_block"],
        **per_step(path_checks, path_counts),
    }, {
        "name": "bm4d_match_topk",
        "path": "teachers",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/bm4d_match.cu",
        "replaces": "exaspim_tpu/ops/pallas_bm4d.py:53",
        "launches": teach["match_topk"],
        **{**per_step(matching["fused"][:2], [1, 1]),
           "ms": sum(matching["path_ms"]),
           "max_abs_err": max(r["max_abs_err"] for r in matching["fused"]
                              + [{"max_abs_err": matching[
                                  "batch_max_abs_err"]}])},
    }, {
        "name": "bm4d_match_topk",
        "path": "teachers",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/bm4d_match.cu",
        "timed_as": "exaspim_tpu_torch/csrc/bm4d_select.cu (the fused "
                    "kernel's selection, bm4d_select.cuh, over a table)",
        "replaces": "exaspim_tpu/ops/pallas_bm4d.py:126",
        "launches": teach["match_topk"],
        **per_step(matching["select"][:2], [1, 1]),
    }] + [{
        "name": name,
        "path": "elementwise",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/asinh_transform.cu",
        "replaces": f"exaspim_tpu/ops/pallas_ops.py:{line}",
        "launches": asinh_launches[name],
        **{k: asinh[name][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")},
    } for name, line in (("asinh_forward", 70), ("asinh_inverse", 99))] + [{
        "name": "blocked_conv3d",
        "path": "conv bench",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/blocked_conv3d.cu",
        "replaces": "exaspim_tpu/ops/pallas_conv.py:117",
        "launches": bench["launches"]["blocked_conv3d"],
        **per_step(blocked_times, [1] * len(blocked_times)),
    }]
    # The demo's run (phase 18), counted apart: rows 1-3 and 6 in its
    # training, validation and held-out predict, rows 4-5 in its teachers.
    # Phase 20: the conv launches of the counted 256^3 predicts of the
    # imported biased (c) and transposed-conv (d) models. Phase 21: rows
    # 1-3 and 6 in the counted train_n2v run (its steps and the held-out
    # predict and summary).
    demo = record["demo"]["launches"]
    n2v = record["n2v"]["launches"]
    imported = sum(record["reference"]["models"][m]["launches"]
                   for m in "cd")
    for k in kernels:
        key = {"nb_conv3d": "nb_conv3d", "nb_conv3d_dw": "nb_conv3d_dw",
               "chunk_byte_histograms": "chunk_byte_histograms",
               "bm4d_match_topk": "match_topk"}.get(k["name"])
        if key is not None:
            k["demo_launches"] = demo[key]
        if key in n2v:
            k["n2v_launches"] = n2v[key]
        if k["name"] in ("nb_conv3d", "nb_conv3d_dw"):
            d = record["n2v"]["conv" if k["name"] == "nb_conv3d" else "dw"]
            k["n2v_step"] = per_step(d["recs"], d["counts"])
        if k["name"] == "nb_conv3d (inference path)":
            k["reference_launches"] = imported
            ref = record["reference"]
            if ref["conv_checks"]:
                # The new shapes of (d) at the block's batch, per batch.
                k["reference_new_shapes"] = per_step(ref["conv_checks"],
                                                      ref["conv_counts"])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
