#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on NVIDIA GPUs.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs a
CUDA card (phase 26 two or more) and ``nvcc`` (it builds the seven
kernel sources of ``exaspim_tpu_torch/csrc/`` for ``sm_90a`` into
``exaspim_tpu_torch/build/``, one nvcc process each, in parallel) and
exits non-zero without a card. Phases, each announced by a ``# phase:``
line:

1. device: each card's name and power limit (``nvidia-smi``);
2. build: compile all kernels, print the conv's seconds and ptxas report
   (no register spills allowed in the three conv sources: ``nb_conv3d``,
   ``nb_conv3d_dw``, ``blocked_conv3d``); beside them, in a thread, the
   port's blosc1 codec (``csrc/blosc1_zstd.cpp``, g++, links only
   ``libzstd.so.1``), and the machine's ``ZSTD_versionString()``;
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
5. quality: the exact blosc-zstd chunked ratio gain (the port's blosc1
   encoder), PSNR and SSIM against the clean phantom, scored through the
   port's quality check (``ckpt_quality.score``) and held to the
   repository's whole quality guard (cratio gain >= 1.9, SSIM not lower,
   PSNR gain >= 8 dB); beside it, not in it, the entropy-proxy ratio of
   noisy and denoised and their gain from one ``chunk_byte_histograms``
   launch on the pair;
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
    for 12 steps with validations at 6 and 12 (each with the exact
    ``val_cratio`` of 16 examples, which ``val_score`` weighs) and the loss
    read every step; launch counts, loss trend, peak memory, a profile of two steps,
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
17. evaluation: ``SupervisedEvaluator.run`` on two 128³ crops and
    ``UnsupervisedEvaluator.run`` on four 64³ voxels, with their exact
    ratios; each voxel's BM4D ground truth and prediction (kept as the
    evaluator makes them) nearer the clean phantom than the noisy patch
    and compressing better; fused matcher launches counted (two per
    ground truth);
18. demo: ``demo_end_to_end.main`` at its defaults (256 train and 16 val
    64³ patches with BM4D teachers, 8 epochs at batch 16, width 1.0, bf16,
    the held-out 128³ block), the loss read every step for the trend
    guard; stage seconds, the summary, the counted launches of
    ``match_topk``, ``nb_conv3d`` (and its reduce), ``nb_conv3d_dw`` and
    ``chunk_byte_histograms`` during the run, peak device memory; the
    validations' exact ``val_cratio`` and ``val_score``, the step the
    demo chose and that checkpoint's exact held-out gain. Fails unless
    the losses are finite and fall, PSNR and SSIM are finite, the proxy
    gain and the exact gain are above 1, every ``val_cratio`` was
    measured, and each of the four kernels launched; the guard's
    thresholds are not claimed at this size;
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
    launch; losses finite and falling, scores finite, ``step_s``; then
    the checkpoint's exact held-out gain in bf16 on the card (the
    summary's) and in f32 on the CPU (``train_n2v --score``), S2's first
    step;
22. live teachers: two brains of 384³ uint16 written as TIFF stacks (the
    card's machine has no tensorstore): phase 4's block mirror-tiled with
    a pedestal of 37 counts and a labelled segmentation of its foreground,
    and the same phantom with z and x swapped, its own noise, mirror-tiled
    with an SWC trace on its foreground;
    ``precompute(source="live", n=64)`` at its defaults (64³, σ 24,
    coherence gate on) on the card: seconds a patch after the brains are
    read, exactly two ``match_topk`` launches a patch; each teacher's RMSE
    against the clean phantom below the raw patch's; each mask the
    annotation's (on brain a the segmented foreground under the patch; on
    brain b covering every trace node inside, empty exactly when there is
    none); four of the patches,
    as a batch, through the fused matcher equal to its plain version;
23. production-scale training at phase 10's configuration (width 1.0,
    bf16, batch 32 of 64³) on phase 10's caches, three ways: resident,
    streamed (``device_cache="auto"`` with ``device_cache_budget`` below
    the cache) and sharded (a forced ``device_cache=True`` whose budget
    holds one batch: 4 shards of 32 rows); each the window step of two
    ``train()`` runs (1 and 4 epochs), the counted launches, the peak
    device memory and the per-shard upload seconds of the longer run, and
    the idle share of a third, profiled ``train()`` of 3 epochs over its
    epochs 2-3 (busy = the union of the device intervals; the trace held
    complete first); then the loader alone at 0 and 4 worker processes,
    in batches a second, on the cache and on phantoms made per item. Fails unless the losses are
    finite and fall, the shard index stream equals ``SeedSequence([seed,
    epoch, s])``'s and the sharded run's peak memory stays below the
    resident run's plus one shard (its cache footprint under two shards);
24. codecs on the card's machine, on phase 4's noisy and denoised block:
    the blosc1 codec's self-check (each block as one frame decodes back
    bit-equal, its header fields blosc's), the chunk walk's ratio equal
    at 1 and 8 threads and to the per-chunk Python loop's, its seconds per
    256³ volume at 1 and 8 threads; ``compute_cratio_2d`` with
    ``PngSliceCodec`` (lossless, so exact) and its round trip bit-equal;
    ``compress_and_decompress_2d`` of the denoised block with
    ``Jpeg2000SliceCodec`` and ``JpegSliceCodec``, each ratio with PSNR
    and SSIM against its input on the card; JPEG-XL and the libblosc walk
    only where their library loads, else one line names it and no number
    is reported (phase 25's two processes start first and run beside it);
25. multi-GPU on the one card, three ways. Two processes over gloo
    (started with ``spawn``, the backend named: NCCL refuses two ranks on
    one device), whose halos cross a process boundary: ``predict_sharded``
    of the 256³ block in both stitch branches (the parity canvas at
    phase 4's plan, each rank only its rows of the global grid; patch 64,
    overlap 36 patch by patch), each bit-equal to one ``predict`` on every
    rank, with the conv launches per rank;
    ``bm4d_sharded`` of a 132 x 64 x 64 volume (two slabs of 66, halo 30),
    bit-equal to ``bm4d`` of the reflect-extended volume cropped back,
    two fused-matcher launches a rank; one data-parallel step, 2 ranks x
    16 against one step of 32 from the shipped weights, the loss, the
    gradient's relative L2 and the parameters within the stated limits
    and the parameters bit-equal across the ranks (their times printed and
    marked as a correctness check, not a speed figure). NCCL at world
    size 1 in this process, through torchrun's environment:
    ``bm4d_sharded`` bit-equal, the step bit-equal to the single step and
    ``train(data_parallel=True)`` for one epoch (4 steps), counted, beside
    the two processes; after them the same two predicts, counted, timed
    and bit-equal;
26. multi-GPU across the machine's cards, one process a card over NCCL
    (on one card one line says that it needs two or more and is not
    run). (a) From this one process, each row of the kernel table at one
    of its path shapes on every card, bit-equal to card 0's output, held
    on card 0 against its plain version and timed beside it; then one
    process a card (``spawn``, torchrun's environment, LOCAL_RANK = rank;
    nothing built there), while this one computes the one-card
    references (its timed runs while they wait, set up and idle):
    (b) ``predict_sharded`` of the 256³ block in both
    branches (the canvas at phase 4's plan where a card's core holds a
    patch of 96, else patch 64), every rank SHA-equal to one card's
    ``predict``, conv launches per rank as planned; (c)
    ``denoise_volume(mesh=)`` of phase 16's volume at its defaults, equal
    to the one-card stream, its rate against the one-card stream's timed
    here, the forwarded voxels over the output voxels, and a profile of
    each (idle share, conv, NCCL and copy time); (d)
    ``bm4d_sharded`` of cards x 66 planes, bit-equal to ``bm4d`` of the
    reflect-extended volume, two matcher launches a rank; (e) one
    data-parallel step of 32 split over the cards against one step of 32
    on one card (phase 25's limits, parameters bit-equal across the
    cards), then 32 patches a card timed and profiled (the NCCL
    all-reduce's kernel ms a step, each rank's idle share); the halo
    exchange and ``gather_z`` timed a call; (f) ``python3 -m
    torch.distributed.run --nproc_per_node <cards>`` of the training CLI
    with ``--data-parallel`` at 32 patches a card: losses finite and
    falling, launches per rank, rank 0 alone writing. One line a card
    with its name and power limit. ``python3 chip_smoke.py --multi-card``
    runs phases 1, 2 and 26 alone (its own block and caches) and exits
    non-zero on fewer than two cards.

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
import threading
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(ROOT, "checkpoints", "bm4dnet.msgpack")
OUT_DIR = os.path.join(ROOT, "chiprun_out")
WORK = os.path.join(ROOT, "chip_smoke_work")  # caches + runs, removed after
# Phase 10's caches, kept from phase 6 to phase 23, removed after.
CACHES = os.path.join(ROOT, "chip_smoke_caches")
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
# Live teachers (phase 22): two brains of LIVE_SIDE^3, the first stored with
# a pedestal of LIVE_OFFSET counts; every LIVE_SWC_STRIDE-th foreground
# voxel of the second is a trace node; LIVE_N patches at precompute()'s
# defaults (64^3, sigma 24, coherence gate on).
LIVE_SIDE, LIVE_OFFSET, LIVE_SWC_STRIDE, LIVE_N = 384, 37, 200, 64
# Production-scale training (phase 23): the step window of each path (a
# 12-step window: phase 10's is 32); the loader alone at these worker
# counts, timed over LOADER_EPOCHS epochs of phase 10's cache after
# LOADER_WARM, and over one epoch of LOADER_PHANTOMS phantom items.
SCALE_WINDOW_EPOCHS = (1, 4)
SCALE_PROFILE_EPOCHS = 3  # the profiled train(): epochs 2-3 are its window
LOADER_WORKERS, LOADER_WARM, LOADER_EPOCHS, LOADER_PHANTOMS = (0, 4), 4, 4, 64
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
# Multi-GPU (phase 25). The scatter branch of predict_sharded (patch > 2 x
# stride): patch 64, overlap 36 on the 256^3 block. BM4D on a 2-slab volume
# at the defaults (halo 30): each core MGPU_BM4D_CORE planes (a multiple of
# the step, above the halo). The data-parallel step: 2 ranks x DP_BATCH/2
# against one step of DP_BATCH from the shipped weights on phase 10's cache;
# then train(data_parallel=True) for MGPU_TRAIN_EPOCHS epochs of it.
MGPU_SCATTER = dict(patch_size=64, overlap=36, trim=TRIM, batch_size=8)
MGPU_BM4D_CORE, MGPU_BM4D_YX, DP_BATCH, MGPU_TRAIN_EPOCHS = 66, 64, 32, 1
# The data-parallel step (2 ranks x 16, the gradients all-reduced to the
# mean) against one step of 32 on the card, both bf16 from the same
# weights: the same per-patch forward, the sums over the batch taken in
# another order (two halves' means, the dL/dW kernel's tiles over 16
# patches instead of 32). Adam's first update is about lr · sign(g), so a
# parameter moves at most 2 · lr apart where a near-zero gradient's sign
# flips, and the share apart by more than 1e-6 counts those flips. Set at
# about twice the first reading on an H100 (PERF.md): gradient relative
# L2 2.7e-3, share apart 1.13 %; loss 6.9e-8 relative (the limit 1e-6,
# about eight f32 ulps); parameters at most 5.1e-4 apart (the limit
# 2 · lr).
DP_LOSS_RTOL, DP_GRAD_REL_L2 = 1e-6, 6e-3
DP_PARAM_ATOL, DP_FLIP_SHARE = 2e-3 * 1.001, 0.025
# Multi-GPU across cards (phase 26): one process a card over NCCL. The
# timed data-parallel steps and the torch.distributed.run training run
# take CARD_BATCH patches a card (the global batch CARD_BATCH x cards):
# CARD_TIMED_STEPS timed and CARD_PROFILED_STEPS profiled steps after a
# warm one; the training run at least CARD_TRAIN_STEPS steps. The card
# processes and the training run each have CARD_DEADLINE_S seconds.
CARD_BATCH, CARD_TIMED_STEPS, CARD_PROFILED_STEPS = 32, 5, 3
CARD_TRAIN_STEPS, CARD_DEADLINE_S = 6, 240
# What a profiled stream's device time is read by (kernel names).
STREAM_KEYS = ("nb_conv3d", "nccl", "Memcpy DtoH", "Memcpy HtoD")

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


def keep(outputs, *tensors):
    """A checker's kernel outputs, copied to the host, appended to
    ``outputs`` where it is a list (phase 26 (a) holds each card's equal to
    card 0's); nothing where it is None."""
    if outputs is not None:
        outputs.extend(t.detach().cpu() for t in tensors)


def check_kernel(b, n, segs, cout, seed, stats=True, time_it=True,
                 outputs=None):
    """Conv kernel vs plain version at one shape (``n``: an edge or
    ``(D, H, W)``): within OUT_RTOL and STATS_RTOL, two launches bit-equal,
    the planted descriptor fault caught, and two of the elements launched
    alone as a smaller batch bit-equal to their slots. The time is that of
    the mode the path runs (``stats``: a forward with GroupNorm statistics;
    else plain mode, as the backward's dL/dx runs it). Returns its
    record; the kernel's output and statistics go to ``outputs``
    (:func:`keep`)."""
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
    keep(outputs, y, s1, s2)
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


def check_dw(b, n, segs, cout, seed, outputs=None):
    """dL/dW kernel vs plain at one training shape: within DW_RTOL of the
    |x|·|g| contraction, two launches bit-equal, the planted fault (tap 0
    reads tap 1's view) caught; timed beside the plain version, one
    ``convolution_backward`` (a yardstick only) and the card's bound.
    Returns its record; the kernel's output goes to ``outputs``."""
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
    keep(outputs, got)
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


def check_histogram(val_vols, pair=None, edge_cases=True, outputs=None):
    """Phase 8: both entries of the byte-histogram kernel against their
    plain versions at every edge case of ``hist_bench.edge_cases`` (unless
    ``edge_cases`` is false), on a validation batch (``val_vols``, 32 x
    64^3 int32 counts) and on the 256^3 pair of phase 4 (noisy and
    denoised, int32) where it is given; two launches bit-equal; one call
    one kernel on the device; times on the batch and the pair. Both
    entries' outputs go to ``outputs``."""
    import torch

    from exaspim_tpu_torch.compression import proxy as P
    from exaspim_tpu_torch.ops import hist_bench as hb

    def check(name, rows, vols, chunk):
        got = P.byte_histogram(rows)
        got_c = P.chunk_byte_histograms(vols, chunk)
        keep(outputs, got, got_c)
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

    if edge_cases:
        for name, (rows, vols, chunk) in hb.edge_cases("cuda").items():
            check(name, rows, vols, chunk)
    work = {"validation batch": val_vols}
    if pair is not None:
        work["256^3 pair"] = pair
    rows = {k: hb._rows(v, 64) for k, v in work.items()}
    for k in work:
        check(k, rows[k], work[k], 64)
    # One call, one kernel: the call captured in a CUDA graph holds one
    # kernel node and nothing else (no memset, no conversion, no copy).
    last = list(work)[-1]
    for label, fn in (
            ("byte_histogram", lambda: P.byte_histogram(rows[last])),
            ("chunk_byte_histograms",
             lambda: P.chunk_byte_histograms(work[last], 64))):
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

    shutil.rmtree(CACHES, ignore_errors=True)
    t0 = time.time()
    dirs = []
    for split, n, seed in (("train", N_TRAIN, 42), ("val", N_VAL, 43)):
        d = os.path.join(CACHES, split)
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

    cfg = dict(batch_size=32, lr=1e-3, fg_weight=0.0, seed=42,
               width_multiplier=1.0, bf16=True, device_cache=True,
               exact_cratio_examples=16, device="cuda")
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
    # val_cratio is the exact blosc-zstd ratio (median of 16 examples, the
    # port's blosc1 encoder), and val_score weighs it.
    if not all(v["val_cratio"] > 1.0 for v in vals):
        fail(f"val_cratio not measured: {vals}")

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


def check_matching(name, vol, outputs=None):
    """Phase 11 on one volume: the fused kernel's starts against the plain
    version's, then its two halves (the table instance, the selection over
    that table) against theirs, each timed beside its plain version, the
    bound and, for the selection, one ``torch.topk``. Returns the fused
    and the selection records; the kernels' starts and table go to
    ``outputs``."""
    import torch

    from exaspim_tpu_torch.ops import bm4d_match as tm
    from exaspim_tpu_torch.ops.match_bench import bound_ms

    g = torch.as_tensor(vol, dtype=torch.float32, device="cuda")
    grid = tm.grid_shape(g.shape, BM_B, BM_STEP)
    refs = grid[0] * grid[1] * grid[2]
    kw = dict(block=BM_B, step=BM_STEP, search=BM_W)
    fused_err = check_fused(name, g, outputs)
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
    keep(outputs, table, *starts)
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


def check_fused(name, g, outputs=None):
    """The fused kernel on a guide or a batch of guides against
    select_topk_plain(match_distances_plain(.)) on the card: the starts
    must be equal, member 0 the reference itself. Returns max |Δ|; the
    starts go to ``outputs``."""
    import torch

    from exaspim_tpu_torch.ops import bm4d_match as tm

    starts = tm.match_topk(g, BM_B, BM_K, BM_STEP, BM_W)
    keep(outputs, *starts)
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


def matching_kernels(outputs=None):
    """Phase 11: three volumes and a batch of three 64³ patches; then the
    fused kernel's time per patch on the teacher path's batches (eight 64³
    patches, each stage one launch). Returns the records; the kernels'
    outputs go to ``outputs``."""
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
    recs = [check_matching("64^3 raw patch", raws[0], outputs),
            check_matching("64^3 stage-1 estimate", basics[0], outputs),
            check_matching("130^3 volume", big, outputs)]
    batch_err = check_fused("batch of three 64^3 patches", raws[:3], outputs)
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


def asinh_kernels(img, transform, outputs=None):
    """Phase 13: the elementwise path on the 256³ block, counted, then the
    two kernels against their plain versions. Returns their records and
    the launch counts; the kernels' outputs go to ``outputs``."""
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
    keep(outputs, y, back, got)
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


def check_blocked(b, d, h, w, cin, cout, seed, outputs=None):
    """Phase 14 at one shape: ``blocked_conv3d`` against its plain version,
    its two gradients against an f32 reference, and the planted fault. The
    kernel's output goes to ``outputs``."""
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
    keep(outputs, y)
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


def time_blocked(b, d, h, w, cin, cout, outputs=None):
    """``blocked_conv3d`` at one bench shape and batch, where the conv bench
    runs it: held element-wise against its plain version there (another
    grid and 64-bit offsets than the batch-2 check), then device ms beside
    the plain version's, cuDNN's (a yardstick only) and the card's bound.
    The kernel's output goes to ``outputs``."""
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
        keep(outputs, y)
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


def blocked_kernel(outputs=None):
    """Phase 14; returns the check records and the batch-32 time records
    of the three bench shapes; the kernel's outputs go to ``outputs``."""
    import torch

    from exaspim_tpu_torch.ops.nb_bench import SHAPES

    checks = [check_blocked(*s, seed=40 + i, outputs=outputs)
              for i, s in enumerate(BLOCKED_SHAPES)]
    torch.cuda.empty_cache()
    times = []
    for d, h, w, cin, cout in SHAPES:
        times.append(time_blocked(BENCH_BATCH, d, h, w, cin, cout, outputs))
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
    vol = pipe_volume(img)
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
    from exaspim_tpu_torch.ops import bm4d_match as tm

    voxels, side, crop, dtype = EVAL_VOXELS, PATCH, 128, torch.bfloat16
    out_dir = os.path.join(WORK, "evaluate")

    def read_patch(brain_id, voxel):
        z, y, x = voxel
        return img[z:z + side, y:y + side, x:x + side]

    def rmse(a, b):
        return float(np.sqrt(np.mean(
            (a.astype(np.float64) - b.astype(np.float64)) ** 2)))

    rec = {}
    counters = (tm.match_topk, tm.match_distances, tm.select_topk)
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
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
    # Each voxel's ground truth and prediction, kept as the evaluator makes
    # them, are held against the clean phantom.
    gts, preds = [], []

    def keep(fn, into):
        def run(*args, **kw):
            into.append(fn(*args, **kw))
            return into[-1]
        return run

    with swapped(ev, bm4d_ground_truth=keep(ev.bm4d_ground_truth, gts),
                 predict_patch=keep(ev.predict_patch, preds)):
        df = uns.run({key: list(voxels)})[key]
    print(df.to_string(index=False), flush=True)
    rows = df.to_dict("records")
    if len(rows) != len(voxels) or len(gts) != len(voxels):
        fail(f"unsupervised evaluation: {rows}")
    for v, gt, pred, row in zip(voxels, gts, preds, rows):
        z, y, x = v
        ref = clean[z:z + side, y:y + side, x:x + side]
        noise = read_patch("phantom", v)
        row.update(rmse_noise=rmse(noise, ref), rmse_gt=rmse(gt, ref),
                   rmse_pred=rmse(pred, ref))
        print({k: row[k] for k in ("voxel", "rmse_noise", "rmse_gt",
                                   "rmse_pred")}, flush=True)
        # Every column finite; the ground truth and the prediction nearer
        # the clean phantom than the noisy patch, and compressing better
        # (exact ratios).
        vals = [val for k, val in row.items()
                if k not in ("brain_id", "voxel")]
        if pred.shape != noise.shape or pred.dtype != np.uint16 \
                or not np.all(np.isfinite(vals)) \
                or not row["rmse_gt"] < row["rmse_noise"] \
                or not row["rmse_pred"] < row["rmse_noise"] \
                or not row["cratio"] > row["cratio_noise"] \
                or not row["cratio_gt"] > row["cratio_noise"]:
            fail(f"evaluation at {v}: {row}")
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
    events = run_events(os.path.join(out, "run"))
    losses = [e["loss"] for e in events if e["event"] == "train"]
    vals = [e for e in events if e["event"] == "val"]
    stages = {k: summary[k] for k in ("cache_build_s", "train_s",
                                      "predict_128c_s")}
    print(f"demo in {wall:.1f} s; stages {stages}", flush=True)
    print(json.dumps(summary), flush=True)
    print(f"launches during the demo {launches}; peak device memory "
          f"{peak_gb:.2f} GiB", flush=True)
    print(f"losses: first {losses[:3]}, last {losses[-3:]} "
          f"({len(losses)} steps)", flush=True)
    # Checkpoint selection weighs the exact val_cratio (weight 10), as the
    # JAX demo's does.
    chosen = os.path.basename(summary["checkpoint"])
    step = int(re.match(r"BM4DNet-\d+-(\d+)-", chosen).group(1))
    print("validations (step, val_score, exact val_cratio, proxy): "
          + "; ".join(f"({v['step']}, {v['val_score']:.4f}, "
                      f"{v['val_cratio']}, {v['val_cratio_proxy']:.4f})"
                      for v in vals)
          + f"; the demo chose step {step} ({chosen}): exact held-out gain "
          f"{summary['cratio_gain']} ({summary['cratio_raw']} -> "
          f"{summary['cratio_denoised']}; proxy gain "
          f"{summary['cratio_proxy_gain']})", flush=True)
    if not vals or not all(v["val_cratio"] > 1.0 for v in vals) \
            or not summary["cratio_gain"] > 1.0:
        fail(f"demo exact ratios: {vals}, gain {summary['cratio_gain']}")
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
            "peak_mem_gb": peak_gb, "losses": losses, "chosen_step": step,
            "validations": vals}, (
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
    # S2's first step: the exact gain of this checkpoint's bf16 output on
    # the card (the summary's) and of its f32 output on the CPU, scored the
    # same way (train_n2v --score, the held-out block).
    t0 = time.perf_counter()
    f32 = train_n2v.main(["--out", os.path.join(out, "f32"), "--score",
                          os.path.join(out, "n2v.msgpack"),
                          "--device", "cpu"])
    gains = {}
    for name, r in (("bf16_card", summary), ("f32_cpu", f32)):
        gains[name] = {"exact": r["cratio_denoised"] / r["cratio_noisy"],
                       "proxy": r["cratio_proxy_gain"],
                       "psnr_db": r["psnr_denoised_db"],
                       "cratio": [r["cratio_noisy"], r["cratio_denoised"]]}
    rec["s2"] = gains
    print(f"S2: exact held-out gain bf16 (card) "
          f"{gains['bf16_card']['exact']:.4f} ({summary['cratio_noisy']} -> "
          f"{summary['cratio_denoised']}), f32 (CPU, "
          f"{time.perf_counter() - t0:.1f} s) {gains['f32_cpu']['exact']:.4f} "
          f"({f32['cratio_noisy']} -> {f32['cratio_denoised']}); proxy "
          f"gains {gains['bf16_card']['proxy']} / {gains['f32_cpu']['proxy']};"
          f" PSNR {gains['bf16_card']['psnr_db']} / "
          f"{gains['f32_cpu']['psnr_db']} dB", flush=True)
    if not all(np.isfinite(g["exact"]) and g["exact"] > 0
               for g in gains.values()):
        fail(f"S2 exact gains: {gains}")
    return rec


def write_tiff(path, vol):
    """A 3D uint16 volume as a multi-page TIFF (PIL), which the port's
    ``img_io.read`` opens without tensorstore (absent on the card's
    machine)."""
    from PIL import Image

    frames = [Image.fromarray(np.ascontiguousarray(s)) for s in vol]
    frames[0].save(path, save_all=True, append_images=frames[1:])


def live_brains(img, clean, fg):
    """Phase 22's two brains of ``LIVE_SIDE``³ uint16 under ``WORK/live``:
    (a) phase 4's block (``img``, ``clean``, ``fg``) mirror-tiled, stored
    with a pedestal of ``LIVE_OFFSET`` that the spec's offset subtracts,
    with a labelled segmentation of its foreground (connected tube
    components); (b) the same phantom with z and x swapped and its own
    noise (seed 6), mirror-tiled, offset 0, with an SWC trace whose nodes
    lie on its foreground. Returns the brain-spec path, the clean volumes
    by brain id, brain a's foreground (its labels > 0) and b's trace nodes
    as (z, y, x) voxels."""
    from scipy import ndimage

    from exaspim_tpu_torch.data.synthetic import noisy_observation
    from exaspim_tpu_torch.utils.swc import ANISOTROPY

    d = os.path.join(WORK, "live")
    os.makedirs(d, exist_ok=True)

    def tile(v):
        return np.pad(v, [(0, LIVE_SIDE - n) for n in v.shape],
                      mode="symmetric")

    clean_b, fg_b = clean.transpose(2, 1, 0), fg.transpose(2, 1, 0)
    noisy_b = noisy_observation(clean_b, seed=6)
    labels, n_labels = ndimage.label(tile(fg))
    write_tiff(os.path.join(d, "a.tif"), tile(img) + np.uint16(LIVE_OFFSET))
    write_tiff(os.path.join(d, "a_seg.tif"), labels.astype(
        np.uint8 if n_labels < 256 else np.uint16))
    write_tiff(os.path.join(d, "b.tif"), tile(noisy_b))
    # Trace nodes at voxel centres of b's foreground, in physical (x, y, z)
    # micrometres, one chain ordered along z.
    nodes = np.argwhere(tile(fg_b))[::LIVE_SWC_STRIDE]
    xyz = (nodes[:, ::-1] + 0.5) * np.asarray(ANISOTROPY)
    with open(os.path.join(d, "b.swc"), "w") as f:
        f.write("# nodes on brain b's foreground\n")
        for i, (x, y, z) in enumerate(xyz, 1):
            f.write(f"{i} 3 {x:.4f} {y:.4f} {z:.4f} 1.0 "
                    f"{i - 1 if i > 1 else -1}\n")
    spec = [{"brain_id": "a", "img": os.path.join(d, "a.tif"),
             "segmentation": os.path.join(d, "a_seg.tif"),
             "offset": LIVE_OFFSET},
            {"brain_id": "b", "img": os.path.join(d, "b.tif"),
             "swc": os.path.join(d, "b.swc")}]
    path = os.path.join(d, "brains.json")
    with open(path, "w") as f:
        json.dump(spec, f)
    print(f"brains: a {LIVE_SIDE}^3 (offset {LIVE_OFFSET}, {n_labels} "
          f"labelled segments), b {LIVE_SIDE}^3 ({len(nodes)} SWC nodes)",
          flush=True)
    return path, {"a": tile(clean), "b": tile(clean_b)}, tile(fg), nodes


def live_path(img, clean, fg):
    """Phase 22 (see the module docstring). Returns the record."""
    import torch

    from exaspim_tpu_torch.data import live
    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.data.precompute import precompute
    from exaspim_tpu_torch.ops.bm4d_match import match_topk
    from exaspim_tpu_torch.utils.img_io import get_patch

    t0 = time.perf_counter()
    spec, cleans, fg_a, nodes_b = live_brains(img, clean, fg)
    make_s = time.perf_counter() - t0
    drawn, init_s = [], []
    sample, init = live.TrainDataset.sample_example, live.init_datasets

    def recording(self):
        ex = sample(self)
        drawn.append(ex[3:])
        return ex

    def timed_init(*args, **kw):
        t = time.perf_counter()
        out = init(*args, **kw)
        init_s.append(time.perf_counter() - t)
        return out

    out = os.path.join(WORK, "live", "cache")
    torch.cuda.synchronize()
    match_topk.launches = 0
    t0 = time.perf_counter()
    with swapped(live.TrainDataset, sample_example=recording), \
            swapped(live, init_datasets=timed_init):
        precompute(out, split="train", source="live", config=spec, n=LIVE_N,
                   patch=(PATCH,) * 3)  # the script's default
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = match_topk.launches
    per_patch = (wall - init_s[0]) / LIVE_N
    print(f"precompute(source='live', n={LIVE_N}) in {wall:.2f} s: brains "
          f"read and ingested in {init_s[0]:.2f} s, then {per_patch:.4f} s "
          f"a patch (sampling, masks, gate, BM4D teacher); match_topk "
          f"launches {launches} (expected {2 * LIVE_N})", flush=True)
    if launches != 2 * LIVE_N:
        fail(f"live teachers launched match_topk {launches} times, expected "
             f"{2 * LIVE_N}")
    ds = CachedPatchDataset(out)
    ratios, by_brain, masked = [], Counter(), Counter()
    for i, (brain, voxel) in enumerate(drawn):
        raw, teacher, mask = ds[i]
        ref = get_patch(cleans[brain], voxel, (PATCH,) * 3).astype(np.float64)
        rmse_t = float(np.sqrt(np.mean((teacher - ref) ** 2)))
        rmse_r = float(np.sqrt(np.mean((raw - ref) ** 2)))
        ratios.append(rmse_t / rmse_r)
        by_brain[brain] += 1
        if not rmse_t < rmse_r:
            fail(f"live patch {i} ({brain} at {voxel}): teacher RMSE "
                 f"{rmse_t:.3f} not below the raw patch's {rmse_r:.3f}")
        # The masks against the annotations as written: brain a's is its
        # segmentation (labels > 0, no dilation at the defaults), so the
        # foreground under the patch; brain b's is its trace, dilated, so
        # it covers every node inside the patch and is empty exactly when
        # none is (a uniform draw far from the trace, as in the reference).
        start = np.asarray(voxel) - PATCH // 2
        if brain == "a":
            want = get_patch(fg_a, voxel, (PATCH,) * 3).astype(bool)
            ok = np.array_equal(mask, want)
        else:
            local = nodes_b - start
            local = local[np.all((local >= 0) & (local < PATCH), axis=1)]
            ok = bool(mask.any()) == bool(len(local)) and bool(
                mask[tuple(local.T)].all())
        if not ok:
            fail(f"live patch {i} ({brain} at {voxel}): its mask "
                 f"({int(mask.sum())} voxels) is not the annotation's")
        masked[brain] += bool(mask.any())
    print(f"teachers vs clean: RMSE ratio teacher/raw mean "
          f"{np.mean(ratios):.4f}, worst {max(ratios):.4f} (all < 1); "
          f"patches by brain {dict(by_brain)}, with a non-empty mask "
          f"{dict(masked)}, each mask the annotation's (a: the segmented "
          f"foreground; b: the trace nodes inside); brains made in "
          f"{make_s:.2f} s", flush=True)
    raws = torch.from_numpy(np.stack([ds[i][0] for i in range(4)]).astype(
        np.float32)).cuda()
    err = check_fused("4 live raw patches (a batch)", raws)
    return {"wall_s": wall, "init_s": init_s[0], "brains_s": make_s,
            "s_per_patch": per_patch, "launches": launches,
            "rmse_ratio_mean": float(np.mean(ratios)),
            "rmse_ratio_max": float(max(ratios)), "by_brain": dict(by_brain),
            "masked": dict(masked),
            "matcher_max_abs_err": err}


def loader_rates(train_dir):
    """Batches a second of the streaming loader alone at each of
    ``LOADER_WORKERS``: phase 10's cache (batch 32 of 64³, count collate)
    after ``LOADER_WARM`` epochs (each worker faults in the pages it reads
    once), host-only and through ``prefetch_to_device`` (pinned, copied to
    the card); then one epoch of a dataset whose items cost host work,
    phantoms with their Gaussian teacher (``LOADER_PHANTOMS`` 64³ items,
    batch 8)."""
    import torch

    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.data.loader import (
        DataLoader,
        make_count_train_collate,
        prefetch_to_device,
    )
    from exaspim_tpu_torch.data.synthetic import SyntheticPatchDataset

    def rate(loader, wrap, epochs):
        n = 0
        t0 = time.perf_counter()
        for epoch in range(epochs):
            loader.set_epoch(epoch)
            for _ in wrap(loader):
                n += 1
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    ds = CachedPatchDataset(train_dir)
    phantoms = SyntheticPatchDataset(n=LOADER_PHANTOMS, seed=3)
    out = {}
    for w in LOADER_WORKERS:
        loader = DataLoader(ds, 32, make_count_train_collate(), shuffle=True,
                            seed=42, num_workers=w)
        try:
            rate(loader, iter, LOADER_WARM)
            for name, wrap in (("host", iter),
                               ("to_card", prefetch_to_device)):
                out[f"workers{w}_{name}"] = rate(loader, wrap, LOADER_EPOCHS)
        finally:
            loader.close()
        loader = DataLoader(phantoms, 8, make_count_train_collate(),
                            num_workers=w)
        try:
            out[f"workers{w}_phantoms"] = rate(loader, iter, 1)
        finally:
            loader.close()
    print("loader alone, batches/s (cache: 32 x 64^3, count collate; "
          "phantoms: 8 x 64^3): " + ", ".join(
              f"{k} {v:.2f}" for k, v in out.items()), flush=True)
    return out


def profiled_window(run, steps, end_at, n_steps, spe, step_mark, end_mark,
                    mode):
    """Profile ``run`` (a ``train()`` of ``n_steps`` steps whose recorded
    steps carry ``step_mark`` and whose last step ends in a drain and
    ``end_mark``) and report the window from the host's end of step
    ``spe`` to the mark. The trace is held first: every step's 35 conv
    launches start in the window, and the card's last kernel ends just
    before the mark, which follows a drain (a device clock converted with
    a wrong rate breaks both). None, with the reason printed, otherwise."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    steps.clear()
    end_at[0] = n_steps
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
    finally:
        end_at[0] = 0
    marks = sorted((ev.time_range.start, ev.time_range.end, ev.name)
                   for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CPU
                   and ev.name in (step_mark, end_mark))
    step_ranges = [m for m in marks if m[2] == step_mark]
    ends = [m for m in marks if m[2] == end_mark]
    if len(step_ranges) != n_steps or len(ends) != 1:
        print(f"{mode}: profile marks {len(step_ranges)} steps, {len(ends)} "
              "ends (not measured)", flush=True)
        return None
    lo, hi = step_ranges[spe - 1][1], ends[0][0]
    dev = device_intervals(prof, (step_mark, end_mark))
    convs = sum(lo <= a < hi and "nb_conv3d_kernel" in name
                for a, _, name in dev)
    last_end = max((b for a, b, _ in dev if a < hi), default=float("-inf"))
    want = 35 * (n_steps - spe)
    if convs < want or not -500 <= hi - last_end <= 5000:
        print(f"{mode}: trace not held ({convs} conv launches in the window, "
              f"{want} expected; the card's last kernel ends "
              f"{(hi - last_end) / 1e3:.3f} ms before the drained mark, "
              "expected 0-5): not measured", flush=True)
        return None
    print(f"{mode}: profiled train() ({n_steps // spe} epochs), window of "
          f"epochs 2-{n_steps // spe}: {(hi - lo) / 1e6 / (n_steps - spe):.4f}"
          f" s a step under the profiler; {convs} conv launches start in it,"
          f" the last kernel ends {(hi - last_end) / 1e3:.3f} ms before the "
          "mark", flush=True)
    return profile_report(prof, ("nb_conv3d_kernel", "dw_", "Memcpy"),
                          (hi - lo) / 1e6, lo=lo, hi=hi,
                          skip=(step_mark, end_mark))


def scale_path(train_dir, val_dir, resident_step):
    """Phase 23 (see the module docstring); ``resident_step``: phase 10's
    window step. Returns the record."""
    import torch
    from torch.profiler import record_function

    from exaspim_tpu_torch.compression.proxy import chunk_byte_histograms
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train import trainer as tt
    from exaspim_tpu_torch.train.train_bm4dnet import train

    cfg = dict(batch_size=32, lr=1e-3, fg_weight=0.0, seed=42,
               width_multiplier=1.0, bf16=True, exact_cratio_examples=0,
               device="cuda")
    row_b = 2 * 2 * PATCH ** 3  # raw + teacher rows, uint16 (fg not needed)
    cache_b, shard_b = N_TRAIN * row_b, 32 * row_b
    modes = {"resident": dict(device_cache="auto"),
             # A budget below the cache: "auto" streams through the loader.
             "stream": dict(device_cache="auto",
                            device_cache_budget=cache_b // 2),
             # A forced cache with room for one batch: 4 shards of 32 rows.
             "shards": dict(device_cache=True, device_cache_budget=shard_b)}
    counters = (nb_conv3d, nb_conv3d_dw, chunk_byte_histograms)
    spe = N_TRAIN // 32  # steps an epoch
    step_mark, end_mark = "chip_smoke.step", "chip_smoke.window_end"
    rec = {}
    for mode, kw in modes.items():
        # end_at: the step after which a profiled run drains the card and
        # marks its window's end (0: not profiling).
        steps, lo, end_at = [], [0], [0]
        make, make_cached, upload = (tt.make_train_step,
                                     tt.make_cached_train_step,
                                     tt.Trainer._upload_cache)

        def recording(make_fn, cached):
            def made(*args, **kws):
                step = make_fn(*args, **kws)

                def run(state, *batch):
                    with record_function(step_mark):
                        state, loss = step(state, *batch)
                    # Kept on the card, read after the run: no sync. A
                    # cached step's batch indices (a view of the epoch's
                    # order), never a streamed batch.
                    steps.append((lo[0], batch[-1] if cached else None,
                                  loss))
                    if len(steps) == end_at[0]:
                        torch.cuda.synchronize()
                        with record_function(end_mark):
                            pass
                    return state, loss
                return run
            return made

        def spy_upload(self, ds_, row_lo=0, row_hi=None):
            lo[0] = row_lo
            return upload(self, ds_, row_lo, row_hi)

        def run_train(epochs, tag):
            with swapped(tt, make_train_step=recording(make, False),
                         make_cached_train_step=recording(make_cached,
                                                          True)), \
                    swapped(tt.Trainer, _upload_cache=spy_upload):
                return train([train_dir], [val_dir],
                             os.path.join(WORK, f"{mode}{tag}"),
                             epochs=epochs, **cfg, **kw)

        walls = []
        for e in SCALE_WINDOW_EPOCHS:  # the longer run is the counted one
            steps.clear()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for fn in counters:
                fn.launches = 0
            t0 = time.perf_counter()
            trainer = run_train(e, e)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()
        with open(trainer._log_path) as f:
            events = [json.loads(line) for line in f]
        with open(os.path.join(trainer.session_dir, "config.json")) as f:
            shards = json.load(f)["device_cache_shards"]
        uploads = [e["wall_s"] for e in events
                   if e["event"] == "device_cache_upload"]
        n_steps = spe * SCALE_WINDOW_EPOCHS[-1]
        losses = [float(v) for _, _, v in steps]
        step_s = (walls[1] - walls[0]) / (
            spe * (SCALE_WINDOW_EPOCHS[1] - SCALE_WINDOW_EPOCHS[0]))
        want = {"nb_conv3d": 35 * n_steps + 18, "nb_conv3d_dw": 18 * n_steps,
                "chunk_byte_histograms": 1}
        print(f"{mode}: device_cache_shards {shards}; train() walls "
              f"{walls[0]:.4f} / {walls[1]:.4f} s ({SCALE_WINDOW_EPOCHS} "
              "epochs): "
              f"{step_s:.4f} s a step, {32 * PATCH ** 3 / step_s:.1f} "
              f"voxels/s; peak device memory {peak / 2 ** 30:.3f} GiB; "
              f"uploads {len(uploads)} of {uploads[:4]} s; launches "
              f"{launches} (expected {want})", flush=True)
        if not step_s > 0:
            fail(f"{mode}: window step time {step_s} s")
        if shards != {"resident": 1, "stream": 0, "shards": 4}[mode]:
            fail(f"{mode}: the run resolved to {shards} shards")
        if launches != want:
            fail(f"{mode}: launches {launches}, expected {want}")
        if len(losses) != n_steps or not np.all(np.isfinite(losses)) \
                or not np.mean(losses[-4:]) < losses[0]:
            fail(f"{mode}: losses not finite or not falling: {losses}")
        if mode == "shards":
            rows = [(lo_ + idx.cpu()).tolist() for lo_, idx, _ in steps]
            plan = [(32 * s + np.random.default_rng(np.random.SeedSequence(
                [42, epoch, s])).permutation(32)).tolist()
                for epoch in range(SCALE_WINDOW_EPOCHS[-1])
                for s in range(4)]
            if rows != plan:
                fail("the shard index stream is not SeedSequence([seed, "
                     "epoch, s])'s")
            print("shard index stream equals SeedSequence([seed, epoch, "
                  f"shard])'s over {len(rows)} steps", flush=True)
        # The steady state on the entry point itself: a third train(), of
        # SCALE_PROFILE_EPOCHS epochs (validation only after the last step,
        # at the default val_every), profiled; its window runs from the
        # host's end of epoch 1's last step to the card's end of the last
        # step, epoch boundaries (set_epoch, shard uploads) included. The
        # profiler's own host work (CPU activity) counts as host time. A
        # trace that fails its check is taken once more.
        prof_steps = spe * SCALE_PROFILE_EPOCHS
        for attempt in (1, 2):
            prof = profiled_window(
                lambda: run_train(SCALE_PROFILE_EPOCHS, f"prof{attempt}"),
                steps, end_at, prof_steps, spe, step_mark, end_mark, mode)
            if prof is not None:
                break
        del trainer
        torch.cuda.empty_cache()
        rec[mode] = {"step_s": step_s, "window_walls_s": walls,
                     "peak_bytes": peak, "upload_s": uploads,
                     "launches": launches, "losses": losses,
                     "idle_share": None if prof is None
                     else prof["idle_share"],
                     "profile": prof}
    footprint = rec["shards"]["peak_bytes"] - rec["resident"]["peak_bytes"] \
        + cache_b
    print(f"steps (s): resident {rec['resident']['step_s']:.4f}, stream "
          f"{rec['stream']['step_s']:.4f}, shards {rec['shards']['step_s']:.4f}"
          f" (phase 10's resident window: {resident_step}); idle shares "
          + ", ".join(f"{m} {r['idle_share']}" for m, r in rec.items())
          + f"; the shards' cache footprint {footprint / 2 ** 20:.1f} MiB "
          f"(one shard {shard_b / 2 ** 20:.1f}, the whole cache "
          f"{cache_b / 2 ** 20:.1f})", flush=True)
    if not rec["shards"]["peak_bytes"] < rec["resident"]["peak_bytes"] \
            + shard_b or not footprint < 2 * shard_b:
        fail(f"peak memory on shards {rec['shards']['peak_bytes']} B: more "
             f"than one shard at a time (footprint {footprint} B)")
    rec["loader"] = loader_rates(train_dir)
    rec.update({"shard_footprint_bytes": footprint, "shard_bytes": shard_b,
                "cache_bytes": cache_b, "phase10_step_s": resident_step})
    return rec


def print_ptxas(build, name):
    for line in build.build_log(name).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print("  " + line.strip())


def device_intervals(prof, skip=()):
    """(start, end, name), start and end in µs, of the device-side events (kernels, memcpy, memset)
    of a finished profile, on the profiler's clock. The ranges that
    ``record_function`` spans project onto the device timeline (the
    profiler's step, ``skip``) are annotations, not work: left out."""
    import torch

    out = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA \
                or getattr(ev, "is_user_annotation", False) \
                or ev.name.startswith("ProfilerStep") or ev.name in skip:
            continue
        out.append((ev.time_range.start, ev.time_range.end, ev.name))
    return out


def union_s(intervals, lo=float("-inf"), hi=float("inf")):
    """Seconds covered by the union of µs ``intervals`` within [lo, hi]:
    copies on a side stream that overlap a kernel count once."""
    covered, reach = 0.0, lo
    for a, b, *_ in sorted(intervals):
        b = min(b, hi)
        if b > reach:
            covered += b - max(a, reach)
            reach = b
    return covered / 1e6


def profile_once(run, key=("nb_conv3d_kernel", "nb_stats_reduce"),
                 warm=False):
    """Device time by kernel over one run of ``run`` (torch.profiler);
    ``key`` (a name fragment, or a tuple of them) names the kernels whose
    time and launch count are reported, each fragment on its own and
    summed. Busy time is the union of the device intervals; the idle
    share is its complement over the host's wall. ``warm`` first makes one
    discarded run inside the profiler's warm-up step, so that a short
    run's first launches are traced too."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

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
    return profile_report(prof, key, wall)


def profile_report(prof, key, wall, lo=float("-inf"), hi=float("inf"),
                   skip=()):
    """Print and return a profile's device time within [lo, hi] µs (the
    profiler's clock) beside ``wall``, the window's host seconds: busy
    time as the union of the device intervals, kernel time by name (the
    events that start in the window); None where no device time was
    recorded. ``skip``: see :func:`device_intervals`."""
    intervals = device_intervals(prof, skip)
    busy_s = union_s(intervals, lo, hi)
    by_name = {}
    for a, b, name in intervals:
        if lo <= a < hi:
            us, n = by_name.get(name, (0.0, 0))
            by_name[name] = (us + b - a, n + 1)
    rows = sorted(((us, name, n) for name, (us, n) in by_name.items()
                   if us > 0), reverse=True)
    if not rows:
        print("profile: no device time recorded (not measured)")
        return None
    keys = (key,) if isinstance(key, str) else tuple(key)
    sum_s = sum(r[0] for r in rows) / 1e6
    by_key = {k: [sum(r[0] for r in rows if k in r[1]) / 1e6,
                  sum(r[2] for r in rows if k in r[1])] for k in keys}
    conv_s = sum(v[0] for v in by_key.values())
    key_launches = sum(v[1] for v in by_key.values())
    idle = 1 - busy_s / wall
    print(f"profile: wall {wall:.4f} s, device busy {busy_s:.4f} s (union; "
          f"{sum_s:.4f} s summed by kernel; idle share {idle:.3f}), of "
          "which " + " + ".join(f"{k} kernels {v[0]:.4f} s in {v[1]} "
                                 "launches" for k, v in by_key.items())
          + (f" = {conv_s:.4f} s" if len(keys) > 1 else ""))
    for dev_us, name, count in rows[:10]:
        print(f"  {dev_us / 1e3:10.3f} ms  x{count:<5d} {name[:90]}")
    return {"wall_s": wall, "device_busy_s": busy_s, "device_sum_s": sum_s,
            "idle_share": idle, "conv_s": conv_s,
            "key_launches": key_launches, "by_key": by_key,
            "top": [[name, dev_us / 1e3, count]
                    for dev_us, name, count in rows[:15]]}


def codec_path(img, out):
    """Phase 24: the compression package's codecs and ratios on the card's
    machine, on phase 4's noisy and denoised 256^3 block. The blosc-zstd
    ratio runs through the port's own blosc1 encoder (libzstd only): each
    block framed whole and decoded back bit-equal, its header fields as
    blosc writes them, the chunk walk's ratio equal to the per-chunk
    Python loop's (and to the libblosc walk's where libblosc loads), the
    walk timed at 1 and 8 threads. PNG is lossless: its ratio is exact and
    its round trip must be bit-equal. JPEG 2000 and JPEG go through
    compress_and_decompress_2d, scored (PSNR, SSIM) against their input on
    the card. JPEG-XL and the libblosc walk run only where their library
    loads; otherwise one line names the missing library and no number is
    reported for them."""
    from exaspim_tpu_torch.ckpt_quality import score
    from exaspim_tpu_torch.compression import (
        Jpeg2000SliceCodec,
        JpegSliceCodec,
        JxlSliceCodec,
        PngSliceCodec,
        best_codec,
        blosc1,
        blosc_available,
        compress_and_decompress_2d,
        compute_cratio,
        compute_cratio_2d,
        jxl,
        native,
    )

    rec = {"jpegxl": None}
    lossy = [("jpeg2000", Jpeg2000SliceCodec), ("jpeg", JpegSliceCodec)]
    if jxl.available():
        lossy.append(("jpegxl", JxlSliceCodec))
    else:
        rec["jpegxl_missing"] = jxl.unavailable_reason()
        print(f"JPEG-XL: not run ({rec['jpegxl_missing']})", flush=True)
    libblosc_why = (native.unavailable_reason() if blosc_available()
                    else "libblosc.so.1 not found")
    if libblosc_why:
        rec["libblosc_missing"] = libblosc_why
        print(f"libblosc walk (the yardstick): not run ({libblosc_why})",
              flush=True)
    codec = best_codec()
    want_head = {"version": 2, "versionlz": 1, "flags": 0x91, "typesize": 2,
                 "nbytes": img.nbytes, "blocksize": 512 * 1024,
                 "memcpyed": False, "compressor": "zstd"}
    for name, vol in (("noisy", img), ("denoised", out)):
        r = {}
        # The codec's self-check: the whole block as one frame (64 blocks
        # of 512 KiB) decodes back bit-equal; the header is blosc's.
        t0 = time.perf_counter()
        frame = codec.encode(vol)
        r["frame_encode_s"] = time.perf_counter() - t0
        head = blosc1.frame_header(frame)
        back = np.frombuffer(codec.decode(frame), np.uint16)
        if not np.array_equal(back, vol.reshape(-1)):
            fail(f"blosc1 round trip of the {name} block is not bit-equal")
        if any(head[k] != v for k, v in want_head.items()) \
                or head["cbytes"] != len(frame):
            fail(f"blosc1 frame header of the {name} block: {head}")
        chunk = codec.encode(np.ascontiguousarray(vol[:64, :64, :64]))
        if blosc1.frame_header(chunk)["blocksize"] != 64 ** 3 * 2:
            fail(f"64^3 chunk frame header: {blosc1.frame_header(chunk)}")
        # The chunk walk: its ratio equals the per-chunk Python loop's
        # (and the libblosc walk's where libblosc loads).
        walks = {}
        for threads in (1, 8):
            t0 = time.perf_counter()
            walks[threads] = blosc1.chunked_cratio(vol, n_threads=threads)
            r[f"walk_s_{threads}"] = time.perf_counter() - t0
        r["blosc_cratio"] = compute_cratio(vol, codec)
        loop = compute_cratio(vol, codec, use_native=False)
        if len(set(walks.values())) != 1 \
                or round(walks[1], 2) != r["blosc_cratio"]:
            fail(f"blosc1 walks {walks}, compute_cratio {r['blosc_cratio']}")
        if r["blosc_cratio"] != loop:
            fail(f"blosc1 walk {r['blosc_cratio']} != the Python loop {loop}")
        r["blosc_cratio_unrounded"] = walks[1]
        if not libblosc_why:
            r["libblosc_cratio"] = native.chunked_cratio(vol, (64, 64, 64))
            if r["libblosc_cratio"] != walks[1]:
                fail(f"libblosc walk {r['libblosc_cratio']} != the blosc1 "
                     f"walk {walks[1]}")
        t0 = time.perf_counter()
        r["png_cratio"] = compute_cratio_2d(vol, PngSliceCodec())
        back, r["png_roundtrip_cratio"] = compress_and_decompress_2d(
            vol, PngSliceCodec())
        r["png_s"] = time.perf_counter() - t0
        if not np.array_equal(back, vol):
            fail(f"PNG round trip of the {name} block is not bit-equal")
        for cname, cls in lossy if name == "denoised" else ():
            t0 = time.perf_counter()
            dec, ratio = compress_and_decompress_2d(vol, cls())
            s = score(dec, vol, None, device="cuda")
            r[cname] = {"cratio": ratio, "psnr_db": s["psnr_db"],
                        "ssim": s["ssim"], "s": time.perf_counter() - t0}
            if not (ratio > 1 and np.isfinite(s["psnr_db"])
                    and np.isfinite(s["ssim"])):
                fail(f"{cname} on the {name} block: {r[cname]}")
        print(f"{name}: blosc-zstd {r['blosc_cratio']} (exact, "
              f"{walks[1]!r} unrounded; walk {r['walk_s_1']:.3f} s at 1 "
              f"thread, {r['walk_s_8']:.3f} s at 8; the block as one frame "
              f"{len(frame)} bytes in {r['frame_encode_s']:.3f} s, round "
              f"trip bit-equal); PNG cratio {r['png_cratio']} (exact; round "
              f"trip bit-equal, {r['png_roundtrip_cratio']} in its "
              f"32x256x256 chunks) {r['png_s']:.2f} s; " + "; ".join(
                  f"{c} cratio {r[c]['cratio']} psnr {r[c]['psnr_db']:.4f} "
                  f"dB ssim {r[c]['ssim']:.6f} ({r[c]['s']:.2f} s)"
                  for c, _ in lossy if c in r), flush=True)
        rec[name] = r
    rec["png_gain"] = (rec["denoised"]["png_cratio"]
                       / rec["noisy"]["png_cratio"])
    rec["blosc_gain"] = (rec["denoised"]["blosc_cratio_unrounded"]
                         / rec["noisy"]["blosc_cratio_unrounded"])
    print(f"ratio gain noisy -> denoised: blosc-zstd {rec['blosc_gain']:.4f}"
          f", PNG (lossless) {rec['png_gain']:.4f}", flush=True)
    return rec


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _sha(a):
    import hashlib

    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def dp_setup(train_dir, model=None):
    """A train state from the shipped weights (width 1.0, bf16; into
    ``model`` when given, a model restored from them) and the first
    DP_BATCH patches of phase 10's cache as count batches on the card;
    returns (state, (x, y, fg), transform, the gradients list that the
    state's update records)."""
    import torch

    from exaspim_tpu_torch.train.checkpoint import (
        load_checkpoint,
        restore_pipeline,
    )
    from exaspim_tpu_torch.train.state import create_train_state
    from exaspim_tpu_torch.transforms import build_transform

    ckpt = load_checkpoint(CKPT)
    if model is None:
        model, _ = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                    device="cuda")
    state = create_train_state(model, lr=1e-3, total_steps=100,
                               params=ckpt["params"])
    transform = build_transform(ckpt["transform"])
    batch = card_batch(train_dir, DP_BATCH)
    grads, apply = [], state.apply_gradients

    def spy():  # the (all-reduced) gradient AdamW receives
        grads.append(torch.cat([p.grad.reshape(-1).float()
                                for p in model.parameters()]))
        return apply()

    state.apply_gradients = spy
    return state, batch, transform, grads


def _flat_params(state):
    import torch

    return torch.cat([p.detach().reshape(-1).float()
                      for p in state.model.parameters()]).cpu().numpy()


def mgpu_worker(rank, world, port, job_dir):
    """Phase 25: one of two processes sharing the one card over gloo.
    Runs predict_sharded (both stitch branches), bm4d_sharded and one
    data-parallel step on its share; writes its record (each output's
    SHA-256; rank 0 also the step's parameters and gradient) into
    ``job_dir``."""
    import importlib
    import threading

    import torch
    import torch.distributed as dist

    from exaspim_tpu_torch import parallel as par
    from exaspim_tpu_torch.ops.bm4d_match import match_topk
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    # A process's first torch.use_deterministic_algorithms call (BM4D's
    # scoped mode) imports torch._inductor, ~10 s from source on the card's
    # machine: import it beside the predicts instead of inside bm4d_sharded.
    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._inductor.config",), daemon=True)
    warm.start()
    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    par.initialize_multihost(f"127.0.0.1:{port}", world, rank,
                             local_device_ids=[0], backend="gloo")
    res, big = {"backend": dist.get_backend()}, {}
    mesh = par.make_mesh(axis="z")
    model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                        device="cuda")
    img = np.load(os.path.join(job_dir, "img.npy"))
    for name, kw in card_predicts(world, job["patch"], job["batch"]):
        nb_conv3d.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        o = par.predict_sharded(img, model, transform, mesh, **kw)
        res[f"{name}_s"] = time.perf_counter() - t0
        res[f"{name}_launches"] = nb_conv3d.launches
        res[f"{name}_sha"] = _sha(o)
    vol = np.load(os.path.join(job_dir, "bm4d.npy"))
    warm.join()
    match_topk.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    den = par.bm4d_sharded(vol, BM_SIGMA, mesh, block=BM_B, group=BM_K,
                           step=BM_STEP, search=BM_W).cpu().numpy()
    res["bm4d_s"] = time.perf_counter() - t0
    res["bm4d_launches"], res["bm4d_sha"] = match_topk.launches, _sha(den)
    dmesh = par.make_mesh(axis="data")
    state, batch, transform, grads = dp_setup(job["train_dir"], model)
    step = par.make_dp_train_step(dmesh, fg_weight=0.0, transform=transform)
    share = par.shard_batch(dmesh, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, loss = step(state, *share)
    res["dp_loss"] = float(loss)
    res["dp_s"] = time.perf_counter() - t0
    res["dp_share"] = int(share[0].shape[0])
    big["dp_params"] = _flat_params(state)
    big["dp_grads"] = grads[0].cpu().numpy()
    res["dp_params_sha"] = _sha(big["dp_params"])
    with open(os.path.join(job_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(os.path.join(job_dir, "rank0.npz"), **big)
    dist.barrier()
    dist.destroy_process_group()


def start_gloo_ranks(img, patch, batch, train_dir):
    """Start phase 25's two gloo processes (``mgpu_worker``) on their
    inputs, written under ``chip_smoke_work/mgpu``; returns the process
    context and the job directory. They run beside phase 24's host
    codecs."""
    import torch.multiprocessing as mp

    job = os.path.join(WORK, "mgpu")
    os.makedirs(job, exist_ok=True)
    np.save(os.path.join(job, "img.npy"), img)
    z = 2 * MGPU_BM4D_CORE
    np.save(os.path.join(job, "bm4d.npy"),
            img[:z, :MGPU_BM4D_YX, :MGPU_BM4D_YX].astype(np.float32))
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"patch": patch, "batch": batch, "train_dir": train_dir},
                  f)
    print("phase 25's two processes start on the one card over gloo, "
          "backend named explicitly: NCCL refuses two ranks on one "
          "device, and this machine has one card", flush=True)
    ctx = mp.start_processes(mgpu_worker, args=(2, _free_port(), job),
                             nprocs=2, start_method="spawn", join=False)
    return ctx, job, time.perf_counter()


def multi_gpu_path(gloo, img, patch, batch, train_dir, val_dir):
    """Phase 25: the multi-GPU layer on the one card, three ways: two
    processes over gloo (``gloo``: :func:`start_gloo_ranks`; halos cross a
    process boundary), NCCL at world size 1 in this process (torchrun's
    environment), and the checks here. Each is held against the
    single-device path; returns the record."""
    import torch
    import torch.distributed as dist

    from exaspim_tpu_torch import parallel as par
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.bm4d import bm4d
    from exaspim_tpu_torch.ops.bm4d_match import match_topk
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline
    from exaspim_tpu_torch.train.state import make_train_step
    from exaspim_tpu_torch.train.train_bm4dnet import train

    ctx, job, t0 = gloo
    z = 2 * MGPU_BM4D_CORE
    vol = np.load(os.path.join(job, "bm4d.npy"))

    # The single-device references, while the two processes run.
    model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                        device="cuda")
    predicts = card_predicts(2, patch, batch)
    refs = {name: predict(img, model, transform, **kw)
            for name, kw in predicts}
    del model
    halo = par.bm4d_halo(BM_B, BM_W, BM_STEP)
    ext = np.pad(vol, ((halo, halo), (0, 0), (0, 0)), mode="reflect")
    oracle = bm4d(ext, BM_SIGMA, block=BM_B, group=BM_K, step=BM_STEP,
                  search=BM_W, device="cuda")[halo:-halo].cpu().numpy()
    state, xb, transform, grads = dp_setup(train_dir)
    state, loss1 = make_train_step(0.0, transform=transform)(state, *xb)
    single = {"loss": float(loss1), "grads": grads[0].cpu().numpy(),
              "params": _flat_params(state)}
    del state, xb, grads
    torch.cuda.empty_cache()

    # NCCL at world size 1, through torchrun's environment: its untimed
    # checks run beside the two gloo processes, its timed predicts after.
    env = {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
           "RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0"}
    os.environ.update(env)
    try:
        if not par.initialize_multihost() or dist.get_backend() != "nccl":
            fail("initialize_multihost did not join an NCCL group")
        if not par.initialize_multihost():  # a second call is ignored
            fail("a second initialize_multihost call failed")
        mesh = par.make_mesh(axis="z")
        dist.barrier()  # NCCL builds its communicator here, not in a timing
        nccl = {}
        match_topk.launches = 0
        den = par.bm4d_sharded(vol, BM_SIGMA, mesh, block=BM_B, group=BM_K,
                               step=BM_STEP, search=BM_W).cpu().numpy()
        nccl["bm4d_launches"] = match_topk.launches
        print(f"nccl, world size 1, bm4d_sharded: bit-equal "
              f"{np.array_equal(den, oracle)}; match_topk launches "
              f"{match_topk.launches}", flush=True)
        if not np.array_equal(den, oracle) or match_topk.launches != 2:
            fail("bm4d_sharded over NCCL at world size 1")
        dmesh = par.make_mesh(axis="data")
        state, xb, transform, grads = dp_setup(train_dir)
        step = par.make_dp_train_step(dmesh, fg_weight=0.0,
                                      transform=transform)
        state, loss = step(state, *par.shard_batch(dmesh, xb))
        equal = (float(loss) == single["loss"]
                 and np.array_equal(_flat_params(state), single["params"]))
        print(f"nccl, world size 1, one data-parallel step of {DP_BATCH}: "
              f"bit-equal to the single step {equal}", flush=True)
        if not equal:
            fail("the data-parallel step at world size 1 is not the single "
                 "step")
        del state, xb, grads
        torch.cuda.empty_cache()

        nb_conv3d.launches = nb_conv3d_dw.launches = 0
        t1 = time.perf_counter()
        trainer = train([train_dir], [val_dir], os.path.join(WORK, "dp"),
                        epochs=MGPU_TRAIN_EPOCHS, batch_size=DP_BATCH,
                        exact_cratio_examples=0, log_every=1,
                        data_parallel=True)
        torch.cuda.synchronize()
        steps = MGPU_TRAIN_EPOCHS * (N_TRAIN // DP_BATCH)
        launches = {"nb_conv3d": nb_conv3d.launches,
                    "nb_conv3d_dw": nb_conv3d_dw.launches}
        want = {"nb_conv3d": 35 * steps + 18 * -(-N_VAL // DP_BATCH),
                "nb_conv3d_dw": 18 * steps}
        with open(trainer._log_path) as f:
            events = [json.loads(line) for line in f]
        losses = [e["loss"] for e in events if e["event"] == "train"]
        nccl["train"] = {"s": time.perf_counter() - t1, "steps": steps,
                         "launches": launches, "losses": losses}
        print(f"train(data_parallel=True) under torchrun's environment, "
              f"world size 1: {steps} steps in {nccl['train']['s']:.2f} s "
              f"(beside the two gloo processes); losses {losses}; launches "
              f"{launches} (expected {want})", flush=True)
        if trainer.mesh is None or launches != want or len(losses) != \
                steps or not np.all(np.isfinite(losses)):
            fail("train(data_parallel=True) at world size 1")

        while not ctx.join():
            pass
        wall = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(job, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        rec = {"gloo": {"ranks": ranks, "wall_s": wall}}
        print(f"gloo ranks: {wall:.1f} s from their start (beside phase 24) "
              "to their end", flush=True)
        rec["gloo"]["dp"] = _gloo_checks(
            ranks, dict(np.load(os.path.join(job, "rank0.npz"))), refs,
            oracle, single, predicts, z, halo)

        model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                            device="cuda")
        for name, kw in predicts:  # warm: the references ran these shapes
            nb_conv3d.launches = 0
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            o = par.predict_sharded(img, model, transform, mesh, **kw)
            sec = time.perf_counter() - t1
            want = sharded_launches(kw, 1)[0][0]
            nccl[name] = {"s": sec, "launches": nb_conv3d.launches}
            print(f"nccl, world size 1, {name}: bit-equal to predict "
                  f"{np.array_equal(o, refs[name])}; nb_conv3d launches "
                  f"{nb_conv3d.launches} (expected {want}); {sec:.4f} s",
                  flush=True)
            if not np.array_equal(o, refs[name]) or \
                    nb_conv3d.launches != want:
                fail(f"predict_sharded ({name}) over NCCL at world size 1")
        rec["nccl"] = nccl
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    return rec


def _gloo_checks(ranks, big, refs, oracle, single, predicts, z, halo):
    """Phase 25's checks of the two gloo processes' records against the
    single-device references; returns the data-parallel reading."""
    for name, kw in predicts:
        got = [r[f"{name}_launches"] for r in ranks]
        want = sharded_launches(kw, 2)[0]
        shas = {r[f"{name}_sha"] for r in ranks}
        equal = shas == {_sha(refs[name])}  # SHA-256 of the bytes
        print(f"gloo, 2 ranks, {name}: bit-equal to predict {equal}, ranks "
              f"equal {len(shas) == 1}; nb_conv3d launches per rank {got} "
              f"(expected {want}, {sum(got)} in all); "
              + ", ".join(f"{r[f'{name}_s']:.3f}" for r in ranks)
              + " s per rank (two processes sharing one card: a "
              "correctness check, not a speed figure)", flush=True)
        if not equal or len(shas) != 1 or got != want:
            fail(f"predict_sharded ({name}) over gloo")
    equal = {r["bm4d_sha"] for r in ranks} == {_sha(oracle)}
    got = [r["bm4d_launches"] for r in ranks]
    print(f"gloo, 2 ranks, bm4d_sharded {z}x{MGPU_BM4D_YX}^2 (halo {halo})"
          f": bit-equal to bm4d of the reflect-extended volume {equal}; "
          f"match_topk launches per rank {got}; "
          + ", ".join(f"{r['bm4d_s']:.3f}" for r in ranks)
          + " s per rank (correctness check, not a speed figure)",
          flush=True)
    if not equal or got != [2, 2]:
        fail("bm4d_sharded over gloo")
    g_err = float(np.linalg.norm(big["dp_grads"] - single["grads"])
                  / np.linalg.norm(single["grads"]))
    dp = np.abs(big["dp_params"] - single["params"])
    dp_rec = {
        "loss_rel": abs(ranks[0]["dp_loss"] - single["loss"])
        / abs(single["loss"]),
        "grad_rel_l2": g_err, "param_max_abs": float(dp.max()),
        "param_share_apart": float(np.mean(dp > 1e-6)),
        "ranks_equal": ranks[0]["dp_params_sha"] == ranks[1][
            "dp_params_sha"],
    }
    print(f"gloo, 2 ranks x {ranks[0]['dp_share']} against one step of "
          f"{DP_BATCH}: loss {ranks[0]['dp_loss']:.6f} vs "
          f"{single['loss']:.6f} (rel {dp_rec['loss_rel']:.3e}); gradient "
          f"rel L2 {g_err:.3e}; params max |d| {dp_rec['param_max_abs']:.3e}"
          f", apart by > 1e-6 {dp_rec['param_share_apart']:.4%}; params "
          f"bit-equal across ranks {dp_rec['ranks_equal']}; "
          + ", ".join(f"{r['dp_s']:.3f}" for r in ranks)
          + " s per rank (correctness check, not a speed figure)",
          flush=True)
    if not dp_rec["ranks_equal"]:
        fail("data-parallel parameters differ across ranks")
    if not (dp_rec["loss_rel"] <= DP_LOSS_RTOL
            and g_err <= DP_GRAD_REL_L2
            and dp_rec["param_max_abs"] <= DP_PARAM_ATOL
            and dp_rec["param_share_apart"] <= DP_FLIP_SHARE):
        fail(f"the data-parallel step strays from the single step: {dp_rec}")
    return dp_rec


def sharded_launches(kw, n, shape=(BLOCK,) * 3):
    """Expected conv launches per rank of ``predict_sharded`` of a volume
    of ``shape`` over ``n`` ranks at the geometry ``kw``: 18 a batch of
    the patches the rank evaluates (the canvas rows of its core, or the
    global starts that touch it)."""
    from exaspim_tpu_torch.parallel.spatial import (
        _canvas_rows,
        _shard_starts,
    )

    p, b = kw["patch_size"], kw["batch_size"]
    stride = p - kw["overlap"]
    if p <= 2 * stride:
        yx = [len(range(0, max(d - p + stride, 1), stride))
              for d in shape[1:]]
        counts = [(k1 - k0 + 1) * yx[0] * yx[1] for k0, k1 in
                  _canvas_rows(shape[0], n, p, kw["overlap"])]
    else:
        counts = [len(loc) for loc, _ in _shard_starts(
            shape[0], n, p, kw["overlap"], shape)]
    return [18 * -(-c // b) for c in counts], counts


def card_predicts(n, patch, batch):
    """Phases 25's and 26's two predict_sharded geometries of the 256^3
    block over ``n`` ranks: the parity canvas at phase 4's plan where each
    rank's core holds a patch of it, else at patch 64 (its batch kept: at
    4 cards the cores are 64 planes); and the patch-by-patch stitch
    (MGPU_SCATTER)."""
    p = patch if BLOCK // n >= patch else 64
    return (("canvas", dict(patch_size=p, overlap=OVERLAP, trim=TRIM,
                            batch_size=batch)),
            ("scatter", MGPU_SCATTER))


def pipe_volume(img):
    """Phase 16's volume: the 256^3 block mirror-tiled to PIPE_N^3."""
    pad = [(0, max(0, PIPE_N - s)) for s in img.shape]
    return np.pad(img, pad, mode="symmetric")[:PIPE_N, :PIPE_N, :PIPE_N]


def stream_counts(shape, n, slab_z=256):
    """``denoise_volume`` at phase 16's defaults over ``n`` ranks (one: a
    card alone): per rank its expected conv launches, and the patches
    every rank evaluates summed over the super-tiles; each tile's z extent
    padded up to one patch-size core a rank as
    ``pipeline._predict_on_mesh`` does. Returns (launches per rank,
    patches in all, patch)."""
    from exaspim_tpu_torch.inference import plan_tiling
    from exaspim_tpu_torch.pipeline import _tile_plan

    patch, batch = plan_tiling((min(shape[0], slab_z),) + shape[1:], OVERLAP)
    plan = _tile_plan(shape, (max(slab_z, patch),) + shape[1:], patch,
                      patch - OVERLAP)
    kw = dict(patch_size=patch, overlap=OVERLAP, batch_size=batch)
    launches, patches = [0] * n, 0
    for tile in plan:
        zb, y, x = (hi - lo for _, _, lo, hi in tile)
        per, counts = sharded_launches(
            kw, n, (max(n * patch, zb + (-zb) % n), y, x))
        launches = [a + b for a, b in zip(launches, per)]
        patches += sum(counts)
    return launches, patches, patch


def card_batch(train_dir, n):
    """The first ``n`` patches of phase 10's cache (wrapping round it) as
    count batches on the card: (x, y, fg)."""
    from exaspim_tpu_torch.data.cache import CachedPatchDataset
    from exaspim_tpu_torch.data.loader import to_tensor

    ds = CachedPatchDataset(train_dir)
    idx = np.arange(n) % len(ds)
    return tuple(to_tensor(np.asarray(a[0])[idx][..., None], "cuda")
                 for a in (ds._raw, ds._teacher, ds._fg))


def _timed_calls(fn, log):
    """``fn`` wrapped to append (seconds, bytes moved) of each call to
    ``log``: every rank enters together (a barrier), the clock stops when
    the result is on this card."""
    import torch
    import torch.distributed as dist

    def timed(t, *args):
        torch.cuda.synchronize()
        dist.barrier(group=args[-1])
        t0 = time.perf_counter()
        out = fn(t, *args)
        torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, t.numel() * t.element_size()))
        return out

    return timed


def cards_worker(rank, world, port, job_dir):
    """Phase 26: one of ``world`` processes, one card each, over NCCL under
    torchrun's environment (LOCAL_RANK = rank). Set up, it says so
    (``ready<rank>`` in ``job_dir``) and waits, idle, for ``go``, which the
    parent writes after its timed one-card runs. Then it runs
    predict_sharded (both branches, counted, then timed, then with the
    halo exchange and gather_z timed), denoise_volume(mesh=) of phase
    16's volume (counted cold, timed warm, then profiled), bm4d_sharded,
    the data-parallel step of DP_BATCH split over the cards, then
    CARD_BATCH a card timed and profiled; writes its record into
    ``job_dir``."""
    import importlib
    import threading

    import torch
    import torch.distributed as dist

    warm = threading.Thread(target=importlib.import_module,
                            args=("torch._inductor.config",), daemon=True)
    warm.start()
    os.environ.update({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                       "RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank)})
    from exaspim_tpu_torch import parallel as par
    from exaspim_tpu_torch.ops.bm4d_match import match_topk
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.parallel import spatial
    from exaspim_tpu_torch.pipeline import denoise_volume
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    with open(os.path.join(job_dir, "job.json")) as f:
        job = json.load(f)
    if not par.initialize_multihost() or dist.get_backend() != "nccl":
        raise RuntimeError("initialize_multihost did not join an NCCL group")
    dev = torch.cuda.current_device()
    res = {"rank": rank, "device": dev,
           "name": torch.cuda.get_device_name(dev)}
    big = {}
    model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                        device="cuda")
    img = np.load(os.path.join(job_dir, "img.npy"))
    vol = pipe_volume(img)
    bvol = np.load(os.path.join(job_dir, "bm4d.npy"))
    mesh = par.make_mesh(axis="z")
    dist.barrier()
    with open(os.path.join(job_dir, f"ready{rank}"), "w"):
        pass
    go = os.path.join(job_dir, "go")
    while not os.path.exists(go):
        time.sleep(0.05)
    sync = torch.cuda.synchronize

    def run(key, fn, counters):
        for c in counters:
            c.launches = 0
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        res[f"{key}_s"] = time.perf_counter() - t0
        res[f"{key}_launches"] = [c.launches for c in counters]
        return out

    for name, kw in card_predicts(world, job["patch"], job["batch"]):
        o = run(name, lambda: par.predict_sharded(img, model, transform,
                                                   mesh, **kw), [nb_conv3d])
        res[f"{name}_sha"] = _sha(o)
        run(f"{name}_warm", lambda: par.predict_sharded(
            img, model, transform, mesh, **kw), [nb_conv3d])
    # The halo exchange and gather_z alone, on the canvas branch's tensors.
    halos, gathers = [], []
    kw = card_predicts(world, job["patch"], job["batch"])[0][1]
    with swapped(spatial,
                 exchange_halos=_timed_calls(spatial.exchange_halos, halos),
                 gather_z=_timed_calls(spatial.gather_z, gathers)):
        for _ in range(3):
            par.predict_sharded(img, model, transform, mesh, **kw)
    res["halo_calls"], res["gather_calls"] = halos, gathers

    pipe = dict(overlap=OVERLAP, trim=TRIM, slab_z=256, patch_size="auto",
                mesh=mesh)
    o = run("stream_cold", lambda: denoise_volume(vol, model, transform,
                                                  **pipe), [nb_conv3d])
    res["stream_sha"] = _sha(o)
    o = run("stream_warm", lambda: denoise_volume(vol, model, transform,
                                                  **pipe), [nb_conv3d])
    res["stream_warm_sha"] = _sha(o)
    del o
    res["stream_profile"] = profile_once(
        lambda: denoise_volume(vol, model, transform, **pipe), STREAM_KEYS)

    warm.join()
    den = run("bm4d", lambda: par.bm4d_sharded(
        bvol, BM_SIGMA, mesh, block=BM_B, group=BM_K, step=BM_STEP,
        search=BM_W).cpu().numpy(), [match_topk])
    res["bm4d_sha"] = _sha(den)
    torch.cuda.empty_cache()

    # The data-parallel step of DP_BATCH split over the cards.
    dmesh = par.make_mesh(axis="data")
    state, batch, transform, grads = dp_setup(job["train_dir"], model)
    step = par.make_dp_train_step(dmesh, fg_weight=0.0, transform=transform)
    share = par.shard_batch(dmesh, batch)
    state, loss = run("dp", lambda: step(state, *share),
                      [nb_conv3d, nb_conv3d_dw])
    res["dp_loss"], res["dp_share"] = float(loss), int(share[0].shape[0])
    big["dp_params"] = _flat_params(state)
    big["dp_grads"] = grads[0].cpu().numpy()
    res["dp_params_sha"] = _sha(big["dp_params"])
    del state.apply_gradients, batch, share
    grads.clear()

    # CARD_BATCH a card (the global batch CARD_BATCH x world): timed, then
    # profiled.
    share = par.shard_batch(dmesh, card_batch(job["train_dir"],
                                              CARD_BATCH * world))
    state, loss = step(state, *share)
    times = []
    for _ in range(CARD_TIMED_STEPS):
        sync()
        t0 = time.perf_counter()
        state, loss = step(state, *share)
        float(loss)
        times.append(time.perf_counter() - t0)
    res["step_s"] = times

    def steps():
        nonlocal state
        for _ in range(CARD_PROFILED_STEPS):
            state, loss = step(state, *share)
        float(loss)

    res["profile"] = profile_once(steps, ("nccl",))
    with open(os.path.join(job_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    if rank == 0:
        np.savez(os.path.join(job_dir, "rank0.npz"), **big)
    dist.barrier()
    dist.destroy_process_group()


def train_child(job_dir, argv):
    """One rank of phase 26's ``torch.distributed.run`` training run: the
    training CLI's entry (``train_bm4dnet.main``) on ``argv``, as ``-m
    exaspim_tpu_torch.train.train_bm4dnet`` runs it, its ``train()`` set to
    log every step (``log_every=1``, not the default 50: one loss a step
    for the trend), then its launch counts and whether it was the writing
    rank, into ``job_dir``."""
    import functools

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from exaspim_tpu_torch.compression.proxy import (
        byte_histogram,
        chunk_byte_histograms,
    )
    from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
    from exaspim_tpu_torch.train import train_bm4dnet

    counters = (nb_conv3d, nb_conv3d_dw, chunk_byte_histograms,
                byte_histogram)
    for c in counters:
        c.launches = 0
    every_step = functools.partial(train_bm4dnet.train, log_every=1)
    t0 = time.perf_counter()
    with swapped(train_bm4dnet, train=every_step):
        trainer = train_bm4dnet.main(argv)
    torch.cuda.synchronize()
    rec = {"s": time.perf_counter() - t0, "rank": dist.get_rank(),
           "world": dist.get_world_size(), "backend": dist.get_backend(),
           "device": torch.cuda.current_device(),
           "local_rank": int(os.environ["LOCAL_RANK"]),
           "primary": trainer.primary, "mesh": trainer.mesh is not None,
           "launches": {c.__name__: c.launches for c in counters}}
    with open(os.path.join(job_dir, f"train_rank{rec['rank']}.json"),
              "w") as f:
        json.dump(rec, f)
    dist.destroy_process_group()
    return 0


def kernels_on_cards(n, img, transform, val_dir):
    """Phase 26 (a): the kernel checks of phases 3, 7, 8, 11, 13 and 14, one
    path shape or set of each row, run from this one process on cuda:0 ...
    cuda:n-1, each card the current device in turn. On every card each
    check holds its kernel against its plain version with its phase's
    limits and times it; the kernels' outputs on every other card must be
    bit-equal to card 0's. A kernel whose dynamic shared memory was allowed
    on one card only fails to launch on the next. Returns card 0's records
    by row."""
    import torch

    from exaspim_tpu_torch.data.cache import CachedValidateDataset
    from exaspim_tpu_torch.data.loader import counts_f32, to_tensor

    val = np.asarray(CachedValidateDataset(val_dir)._raw[0])
    checks = {
        "row 1": ("dL/dx of the training step at 32^3 64->32, B=32 "
                  "(phase 7)", lambda out: check_kernel(
                      32, 32, (64,), 32, seed=261, stats=False,
                      outputs=out)),
        "row 2": ("the 256^3 block's 48^3 64->64 forward, B=9 (phase 3)",
                  lambda out: check_kernel(9, 48, (64,), 64, seed=262,
                                           outputs=out)),
        "row 3": ("dL/dW of the training step at 32^3 64->64, B=32 "
                  "(phase 7)", lambda out: check_dw(32, 32, (64,), 64,
                                                    seed=263, outputs=out)),
        "rows 4-5": ("phase 11: three volumes, a batch of three, the "
                     "teacher path's batches of 8", lambda out:
                     matching_kernels(out)),
        "row 6": ("phase 8 on a validation batch, without its edge cases",
                  lambda out: check_histogram(
                      counts_f32(to_tensor(val, "cuda")).to(torch.int32),
                      edge_cases=False, outputs=out)),
        "row 7": ("phase 13 on the 256^3 block", lambda out:
                  asinh_kernels(img, transform, out)[0]),
        "row 8": ("phase 14: seven checked shapes, three timed at B=32",
                  lambda out: blocked_kernel(out)[1]),
    }
    recs = {}
    for row, (where, check) in checks.items():
        outs = []
        for i in range(n):
            out = []
            print(f"(a) {row} on cuda:{i}: {where}", flush=True)
            with torch.cuda.device(i):
                try:
                    rec = check(out)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    fail(f"{row} on cuda:{i} (after cuda:0 ... cuda:{i - 1} "
                         f"in this process): {e}")
                torch.cuda.empty_cache()
            if i == 0:
                recs[row] = {"checked_at": where, "record": rec}
            outs.append(out)
        equal = [len(o) == len(outs[0]) and all(
            torch.equal(a, b) for a, b in zip(o, outs[0])) for o in outs]
        recs[row]["bits_equal_across_cards"] = all(equal)
        print(f"(a) {row}: {len(outs[0])} kernel outputs on each card, "
              f"bits equal to card 0's {equal}", flush=True)
        if not all(equal):
            fail(f"{row}: a card's kernel outputs differ from card 0's")
    return recs


def matching_rows(matching):
    """Rows 4 and 5 from phase 11's records: the fused kernel (its ms per
    patch in the path's batches, its plain version's and its bound summed
    over the 64^3 raw patch and its stage-1 estimate) and the selection
    timed alone over a table on those two."""
    return ({**per_step(matching["fused"][:2], [1, 1]),
             "ms": sum(matching["path_ms"]),
             "max_abs_err": max(r["max_abs_err"] for r in matching["fused"]
                                + [{"max_abs_err": matching[
                                    "batch_max_abs_err"]}])},
            per_step(matching["select"][:2], [1, 1]))


def _smi_lines():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()


def run_torchrun(n, train_dir, val_dir, job):
    """Phase 26 (f): ``python3 -m torch.distributed.run --nproc_per_node
    n`` of the training CLI with ``--data-parallel`` at CARD_BATCH
    patches a card, each rank through :func:`train_child`; returns the
    ranks' records, the writing rank's log events and what it wrote."""
    out = os.path.join(job, "train")
    spe = N_TRAIN // (CARD_BATCH * n)
    if spe == 0:
        fail(f"{n} cards of {CARD_BATCH} patches need a cache of at least "
             f"{CARD_BATCH * n} patches, not {N_TRAIN}")
    epochs = -(-CARD_TRAIN_STEPS // spe)
    args = ["--data-parallel", "--train-cache", train_dir, "--val-cache",
            val_dir, "--out", out, "--epochs", str(epochs),
            "--batch-size", str(CARD_BATCH * n), "--exact-cratio-examples",
            "0"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", str(n), "--master_addr", "127.0.0.1",
           "--master_port", str(_free_port()),
           os.path.join(ROOT, "chip_smoke.py"), "--train-child", job, "--",
           *args]
    print("torch.distributed.run --nproc_per_node "
          f"{n} ... train_bm4dnet.main {' '.join(args)}", flush=True)
    log = os.path.join(job, "torchrun.log")
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                cwd=ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=CARD_DEADLINE_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None or rc is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        with open(log) as f:
            print(f.read()[-6000:], flush=True)
        fail(f"torch.distributed.run exited with {rc} after {wall:.1f} s")
    ranks = []
    for r in range(n):
        with open(os.path.join(job, f"train_rank{r}.json")) as f:
            ranks.append(json.load(f))
    sessions = sorted(glob.glob(os.path.join(out, "session-*")))
    events, ckpts = [], []
    for s in sessions:
        with open(os.path.join(s, "log.jsonl")) as f:
            events += [json.loads(line) for line in f]
        ckpts += glob.glob(os.path.join(s, "checkpoints", "*"))
    return {"wall_s": wall, "epochs": epochs, "steps": epochs * spe,
            "ranks": ranks, "sessions": len(sessions), "events": events,
            "checkpoints": sorted(os.path.basename(c) for c in ckpts)}


def multi_card_path(img, patch, batch, train_dir, val_dir, transform_cfg):
    """Phase 26: the multi-GPU layer across the machine's cards, one
    process a card over NCCL; every check held against the same work on
    one card here. Returns the record."""
    import torch
    import torch.multiprocessing as mp

    from exaspim_tpu_torch import parallel as par
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.bm4d import bm4d
    from exaspim_tpu_torch.pipeline import denoise_volume
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline
    from exaspim_tpu_torch.train.state import make_train_step
    from exaspim_tpu_torch.transforms import build_transform

    n = torch.cuda.device_count()
    smi = _smi_lines()
    rec = {"cards": n, "nvidia_smi": smi}
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    print(f"(a) every kernel on each of the {n} cards from this process",
          flush=True)
    rec["kernels"] = kernels_on_cards(n, img, build_transform(transform_cfg),
                                      val_dir)

    job = os.path.join(WORK, "cards")
    shutil.rmtree(job, ignore_errors=True)
    os.makedirs(job)
    np.save(os.path.join(job, "img.npy"), img)
    z = n * MGPU_BM4D_CORE
    bvol = np.pad(img[:, :MGPU_BM4D_YX, :MGPU_BM4D_YX],
                  ((0, max(0, z - BLOCK)), (0, 0), (0, 0)),
                  mode="symmetric")[:z].astype(np.float32)
    np.save(os.path.join(job, "bm4d.npy"), bvol)
    with open(os.path.join(job, "job.json"), "w") as f:
        json.dump({"patch": patch, "batch": batch, "train_dir": train_dir},
                  f)
    ctx = mp.start_processes(cards_worker, args=(n, _free_port(), job),
                             nprocs=n, start_method="spawn", join=False)
    t_start = time.perf_counter()
    try:
        # The one-card references while the processes start; the timed
        # one-card runs once they wait, idle, for ``go``.
        model, transform = restore_pipeline(CKPT, dtype=torch.bfloat16,
                                            device="cuda")
        predicts = card_predicts(n, patch, batch)
        refs = {name: predict(img, model, transform, **kw)
                for name, kw in predicts}
        halo = par.bm4d_halo(BM_B, BM_W, BM_STEP)
        ext = np.pad(bvol, ((halo, halo), (0, 0), (0, 0)), mode="reflect")
        oracle = bm4d(ext, BM_SIGMA, block=BM_B, group=BM_K, step=BM_STEP,
                      search=BM_W, device="cuda")[halo:-halo].cpu().numpy()
        state, xb, dp_transform, grads = dp_setup(train_dir)
        step = make_train_step(0.0, transform=dp_transform)
        state, loss1 = step(state, *xb)
        single = {"loss": float(loss1), "grads": grads[0].cpu().numpy(),
                  "params": _flat_params(state)}
        del state.apply_gradients, xb
        grads.clear()
        while not all(os.path.exists(os.path.join(job, f"ready{r}"))
                      for r in range(n)):
            if time.perf_counter() - t_start > CARD_DEADLINE_S or \
                    ctx.join(timeout=0.05):
                fail(f"the {n} processes did not get ready")
        vol = pipe_volume(img)
        pipe = dict(overlap=OVERLAP, trim=TRIM, slab_z=256,
                    patch_size="auto")
        one = {}
        for tag in ("cold", "warm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref_stream = denoise_volume(vol, model, transform, **pipe)
            torch.cuda.synchronize()
            one[f"stream_{tag}_s"] = time.perf_counter() - t0
        one["stream_profile"] = profile_once(
            lambda: denoise_volume(vol, model, transform, **pipe),
            STREAM_KEYS)
        del model
        # One card's step at CARD_BATCH, timed as the ranks time theirs.
        xb = card_batch(train_dir, CARD_BATCH)
        state, loss = step(state, *xb)
        one["step_s"] = []
        for _ in range(CARD_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step(state, *xb)
            float(loss)
            one["step_s"].append(time.perf_counter() - t0)
        del state, xb, step
        torch.cuda.empty_cache()
        rec["one_card"] = one
        with open(os.path.join(job, "go"), "w"):
            pass
        print(f"one-card references ready after "
              f"{time.perf_counter() - t_start:.1f} s; the {n} processes "
              "run", flush=True)
        while not ctx.join(timeout=5):
            if time.perf_counter() - t_start > CARD_DEADLINE_S:
                fail(f"the {n} processes did not end within "
                     f"{CARD_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = []
    for r in range(n):
        with open(os.path.join(job, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    rec["ranks"] = ranks
    rec["processes_s"] = time.perf_counter() - t_start
    big = dict(np.load(os.path.join(job, "rank0.npz")))
    card_checks(rec, ranks, big, refs, ref_stream, oracle, single, predicts,
                vol.shape)

    print("(f) data-parallel training through torch.distributed.run",
          flush=True)
    tr = run_torchrun(n, train_dir, val_dir, job)
    rec["torchrun"] = train_checks(tr, n)
    return rec


def card_checks(rec, ranks, big, refs, ref_stream, oracle, single, predicts,
                shape):
    """Phase 26 (b)-(e) and the card figures: the ranks' records against
    the one-card references; adds the readings to ``rec``."""
    n, smi = len(ranks), rec["nvidia_smi"]
    if [r["device"] for r in ranks] != list(range(n)):
        fail(f"the ranks ran on cards {[r['device'] for r in ranks]}")
    for name, kw in predicts:  # (b)
        got = [r[f"{name}_launches"][0] for r in ranks]
        want = sharded_launches(kw, n)[0]
        equal = {r[f"{name}_sha"] for r in ranks} == {_sha(refs[name])}
        print(f"(b) predict_sharded ({name}, patch {kw['patch_size']}, "
              f"overlap {kw['overlap']}, batch {kw['batch_size']}) over "
              f"{n} cards: every rank SHA-equal to one card's predict "
              f"{equal}; nb_conv3d launches per rank {got} (expected "
              f"{want}); s per rank cold "
              + ", ".join(f"{r[f'{name}_s']:.4f}" for r in ranks)
              + ", warm " + ", ".join(f"{r[f'{name}_warm_s']:.4f}"
                                     for r in ranks), flush=True)
        if not equal or got != want or \
                [r[f"{name}_warm_launches"][0] for r in ranks] != want:
            fail(f"predict_sharded ({name}) across the cards")
    comm = {}
    for key in ("halo", "gather"):
        per = [[s for s, _ in r[f"{key}_calls"]] for r in ranks]
        nbytes = ranks[0][f"{key}_calls"][0][1]
        comm[key] = {"ms_per_call": [1e3 * float(np.mean(p)) for p in per],
                     "bytes_per_call": nbytes, "calls": len(per[0])}
    rec["comm"] = comm

    # (c) the stream.
    launches, patches, p = stream_counts(shape, n)
    one_launches, one_patches, _ = stream_counts(shape, 1)
    got = [r["stream_cold_launches"][0] for r in ranks]
    equal = {r[k] for r in ranks for k in ("stream_sha", "stream_warm_sha")} \
        == {_sha(ref_stream)}
    voxels = float(np.prod(shape))
    wall = max(r["stream_warm_s"] for r in ranks)
    one = rec["one_card"]
    stream = {"voxels_per_s": voxels / wall,
              "one_card_voxels_per_s": voxels / one["stream_warm_s"],
              "speedup": one["stream_warm_s"] / wall,
              "forwarded_over_output": patches * p ** 3 / voxels,
              "one_card_forwarded_over_output": one_patches * p ** 3 / voxels,
              "launches": got, "expected": launches,
              "cold_s": [r["stream_cold_s"] for r in ranks],
              "warm_s": [r["stream_warm_s"] for r in ranks]}
    rec["stream"] = stream
    print(f"(c) denoise_volume(mesh=) of the {PIPE_N}^3 volume at phase "
          f"16's defaults: every rank SHA-equal to the one-card stream "
          f"{equal} (cold and warm); nb_conv3d launches per rank {got} "
          f"(expected {launches}; one card {one_launches[0]})", flush=True)
    if not equal or got != launches or \
            [r["stream_warm_launches"][0] for r in ranks] != launches:
        fail("denoise_volume(mesh=) across the cards")

    # (d) BM4D.
    equal = {r["bm4d_sha"] for r in ranks} == {_sha(oracle)}
    got = [r["bm4d_launches"][0] for r in ranks]
    print(f"(d) bm4d_sharded {oracle.shape[0]}x{MGPU_BM4D_YX}^2 over {n} "
          f"cards: bit-equal to bm4d of the reflect-extended volume on one "
          f"card {equal}; match_topk launches per rank {got}; s per rank "
          + ", ".join(f"{r['bm4d_s']:.3f}" for r in ranks), flush=True)
    if not equal or got != [2] * n:
        fail("bm4d_sharded across the cards")

    # (e) the data-parallel step.
    g_err = float(np.linalg.norm(big["dp_grads"] - single["grads"])
                  / np.linalg.norm(single["grads"]))
    dp = np.abs(big["dp_params"] - single["params"])
    dp_rec = {
        "loss_rel": abs(ranks[0]["dp_loss"] - single["loss"])
        / abs(single["loss"]),
        "grad_rel_l2": g_err, "param_max_abs": float(dp.max()),
        "param_share_apart": float(np.mean(dp > 1e-6)),
        "ranks_equal": len({r["dp_params_sha"] for r in ranks}) == 1,
        "launches": [r["dp_launches"] for r in ranks]}
    rec["dp_step"] = dp_rec
    print(f"(e) one data-parallel step, {n} cards x {ranks[0]['dp_share']} "
          f"against one step of {DP_BATCH} on one card: loss rel "
          f"{dp_rec['loss_rel']:.3e} (<= {DP_LOSS_RTOL}), gradient rel L2 "
          f"{g_err:.3e} (<= {DP_GRAD_REL_L2}), params max |d| "
          f"{dp_rec['param_max_abs']:.3e} (<= {DP_PARAM_ATOL:.4g}), apart "
          f"by > 1e-6 {dp_rec['param_share_apart']:.4%} (<= "
          f"{DP_FLIP_SHARE:.1%}); params bit-equal across the cards "
          f"{dp_rec['ranks_equal']}; launches per rank (conv, dL/dW) "
          f"{dp_rec['launches']}", flush=True)
    if not dp_rec["ranks_equal"] or \
            dp_rec["launches"] != [[35, 18]] * n:
        fail("the data-parallel step across the cards")
    if not (dp_rec["loss_rel"] <= DP_LOSS_RTOL
            and g_err <= DP_GRAD_REL_L2
            and dp_rec["param_max_abs"] <= DP_PARAM_ATOL
            and dp_rec["param_share_apart"] <= DP_FLIP_SHARE):
        fail(f"the data-parallel step strays from the single step: {dp_rec}")

    # The figures, one line a card.
    one_step = float(np.median(one["step_s"]))
    print(f"figures (host clock; every rank returns the whole volume): "
          f"stream {stream['voxels_per_s']:.1f} voxels/s on {n} cards "
          f"(the slowest rank's warm run) against "
          f"{stream['one_card_voxels_per_s']:.1f} on one card in this run "
          f"({stream['speedup']:.3f}x); forwarded voxels / output voxels "
          f"{stream['forwarded_over_output']:.4f} on {n} cards, "
          f"{stream['one_card_forwarded_over_output']:.4f} on one; one "
          f"card's stream {_profile_text(one['stream_profile'])}; one "
          f"card's step at {CARD_BATCH} {one_step:.4f} s (median of "
          f"{one['step_s']})", flush=True)
    for r, line in zip(ranks, smi):
        prof = r["profile"]
        nccl = (f"{1e3 * prof['by_key']['nccl'][0] / CARD_PROFILED_STEPS:.3f}"
                f" ms a step ({prof['by_key']['nccl'][1]} kernels in "
                f"{CARD_PROFILED_STEPS} steps), idle share "
                f"{prof['idle_share']:.3f}" if prof
                else "not measured (no device time traced)")
        print(f"  card {r['device']} ({line}): halo exchange "
              f"{comm['halo']['ms_per_call'][r['rank']]:.3f} ms a call "
              f"({comm['halo']['bytes_per_call'] / 2 ** 20:.1f} MiB each "
              f"way), gather_z {comm['gather']['ms_per_call'][r['rank']]:.3f}"
              f" ms a call ({comm['gather']['bytes_per_call'] / 2 ** 20:.1f}"
              f" MiB in); stream warm {r['stream_warm_s']:.3f} s, "
              f"{_profile_text(r['stream_profile'])}; DP step at "
              f"{CARD_BATCH} a card {float(np.median(r['step_s'])):.4f} s "
              f"(median of {r['step_s']}); the all-reduce's NCCL kernels "
              + nccl, flush=True)


def _profile_text(p):
    if p is None:
        return "profile: no device time traced (not measured)"
    return (f"profiled {p['wall_s']:.3f} s: device busy "
            f"{p['device_busy_s']:.3f} s, idle share {p['idle_share']:.3f}; "
            + ", ".join(f"{k} {1e3 * s:.1f} ms ({c})"
                        for k, (s, c) in p["by_key"].items()))


def train_checks(tr, n):
    """Phase 26 (f): the ranks of the torchrun run trained over NCCL, one
    card each; the launches per rank; one writer; losses finite and
    falling."""
    steps = tr["steps"]
    n_val = -(-N_VAL // (CARD_BATCH * n))
    want = [{"nb_conv3d": 35 * steps + (18 * n_val if r == 0 else 0),
             "nb_conv3d_dw": 18 * steps,
             "chunk_byte_histograms": n_val if r == 0 else 0,
             "byte_histogram": 0} for r in range(n)]
    got = [r["launches"] for r in tr["ranks"]]
    train = [e for e in tr["events"] if e["event"] == "train"]
    losses = [e["loss"] for e in train]
    step_s = [e["step_time_s"] for e in train if "step_time_s" in e]
    tr["losses"], tr["step_s"] = losses, step_s
    ok_ranks = all(r["backend"] == "nccl" and r["world"] == n
                   and r["device"] == r["local_rank"] == r["rank"]
                   and r["mesh"] and r["primary"] == (r["rank"] == 0)
                   for r in tr["ranks"])
    print(f"(f) {steps} steps at {CARD_BATCH} a card (global "
          f"{CARD_BATCH * n}) in {tr['wall_s']:.1f} s from the launch: "
          f"ranks on their own cards over NCCL, rank 0 alone writing "
          f"{ok_ranks}; losses {losses}; step s (rank 0's log, host clock "
          f"between steps, loader included) {step_s}; launches per rank "
          f"{got} (expected {want}); {tr['sessions']} session, "
          f"checkpoints {tr['checkpoints']}", flush=True)
    if not ok_ranks or got != want:
        fail("torch.distributed.run data-parallel training: ranks or "
             "launches")
    if len(losses) != steps or not np.all(np.isfinite(losses)) or \
            not np.mean(losses[-3:]) < losses[0]:
        fail(f"torch.distributed.run data-parallel training: losses "
             f"{losses} (one log line a step, finite, falling)")
    if tr["sessions"] != 1 or not tr["checkpoints"] or not any(
            e["event"] == "val" for e in tr["events"]):
        fail("torch.distributed.run data-parallel training: the writing "
             "rank's session, validation and checkpoints")
    return tr


CARD_SOURCES = {
    "nb_conv3d": ("exaspim_tpu_torch/csrc/nb_conv3d.cu",
                  "exaspim_tpu/ops/nb_conv.py:358"),
    "nb_conv3d (statistics)": ("exaspim_tpu_torch/csrc/nb_conv3d.cu",
                               "exaspim_tpu/ops/nb_conv.py:358"),
    "nb_conv3d_dw": ("exaspim_tpu_torch/csrc/nb_conv3d_dw.cu",
                     "exaspim_tpu/ops/nb_conv.py:448"),
    "bm4d_match_topk": ("exaspim_tpu_torch/csrc/bm4d_match.cu",
                        "exaspim_tpu/ops/pallas_bm4d.py:53"),
    "bm4d_select": ("exaspim_tpu_torch/csrc/bm4d_select.cu",
                    "exaspim_tpu/ops/pallas_bm4d.py:126"),
    "byte_histogram": ("exaspim_tpu_torch/csrc/byte_histogram.cu",
                       "exaspim_tpu/compression/proxy.py:58"),
    "chunk_byte_histograms": ("exaspim_tpu_torch/csrc/byte_histogram.cu",
                              "exaspim_tpu/compression/proxy.py:58"),
    "asinh_forward": ("exaspim_tpu_torch/csrc/asinh_transform.cu",
                      "exaspim_tpu/ops/pallas_ops.py:70"),
    "asinh_inverse": ("exaspim_tpu_torch/csrc/asinh_transform.cu",
                      "exaspim_tpu/ops/pallas_ops.py:99"),
    "blocked_conv3d": ("exaspim_tpu_torch/csrc/blocked_conv3d.cu",
                       "exaspim_tpu/ops/pallas_conv.py:117"),
}


def card_rows(recs):
    """(name, row, record) of each kernel entry, from card 0's records of
    phase 26 (a), as the one-card kernels line reads phases 7-14's."""
    fused, select = matching_rows(recs["rows 4-5"]["record"])
    hist = recs["row 6"]["record"]["validation batch"]
    asinh = recs["row 7"]["record"]
    times = recs["row 8"]["record"]
    return [("nb_conv3d", "row 1", recs["row 1"]["record"]),
            ("nb_conv3d (statistics)", "row 2", recs["row 2"]["record"]),
            ("nb_conv3d_dw", "row 3", recs["row 3"]["record"]),
            ("bm4d_match_topk", "rows 4-5", fused),
            ("bm4d_select", "rows 4-5", select),
            ("byte_histogram", "row 6", hist),
            ("chunk_byte_histograms", "row 6", hist["chunk_entry"]),
            ("asinh_forward", "row 7", asinh["asinh_forward"]),
            ("asinh_inverse", "row 7", asinh["asinh_inverse"]),
            ("blocked_conv3d", "row 8", per_step(times, [1] * len(times)))]


def card_launches(mc):
    """Each kernel entry of phase 26 (a) with its launches per rank on
    phase 26's paths. The conv wrapper counts its two modes (rows 1 and 2)
    in one count, which row 1 carries; row 2 names it (``counted_with``).
    ``bm4d_select`` runs inside the fused matcher's launches (row 4) and is
    never launched alone on these paths: no count of its own."""
    ranks, tr = mc["ranks"], mc["torchrun"]["ranks"]
    conv = {k: [r[f"{k}_launches"][0] for r in ranks]
            for k in ("canvas", "scatter", "stream_cold", "dp")}
    conv["train"] = [r["launches"]["nb_conv3d"] for r in tr]
    per = {
        "nb_conv3d": conv,
        "nb_conv3d_dw": {"dp": [r["dp_launches"][1] for r in ranks],
                         "train": [r["launches"]["nb_conv3d_dw"]
                                   for r in tr]},
        "bm4d_match_topk": {"bm4d_sharded": [r["bm4d_launches"][0]
                                             for r in ranks]},
        "chunk_byte_histograms": {"train": [
            r["launches"]["chunk_byte_histograms"] for r in tr]},
        "byte_histogram": {"train": [r["launches"]["byte_histogram"]
                                     for r in tr]},
        "asinh_forward": {}, "asinh_inverse": {}, "blocked_conv3d": {},
    }
    out = []
    for name, row, rec in card_rows(mc["kernels"]):
        src, rep = CARD_SOURCES[name]
        k = {"name": name, "route": "cuda", "source": src, "replaces": rep}
        if name in per:
            k["launches"] = sum(sum(v) for v in per[name].values())
            k["launches_per_rank"] = per[name]
        elif name == "nb_conv3d (statistics)":
            k.update(launches=None, launches_per_rank=None,
                     counted_with="nb_conv3d")
        else:
            k.update(launches=None, launches_per_rank=None,
                     runs_inside="bm4d_match_topk")
        k.update({key: rec[key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")})
        k["checked_at"] = mc["kernels"][row]["checked_at"]
        k["bits_equal_across_cards"] = mc["kernels"][row][
            "bits_equal_across_cards"]
        out.append(k)
    return out


def multi_card_main(record, kind):
    """``--multi-card``: after the device and build phases, phase 26 alone
    (its block, its caches and the record); prints the kernels' line of
    its paths and the last line."""
    import torch

    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.inference import plan_tiling
    from exaspim_tpu_torch.train.checkpoint import load_checkpoint

    patch, batch = plan_tiling((BLOCK,) * 3, OVERLAP)
    img = noisy_observation(neurite_phantom((BLOCK,) * 3, n_tubes=24,
                                            seed=0)[0], seed=1)
    transform_cfg = load_checkpoint(CKPT)["transform"]
    train_dir, val_dir = make_caches(transform_cfg)
    phase(CARDS_PHASE)
    try:
        record["multi_card"] = mc = multi_card_path(
            img, patch, batch, train_dir, val_dir, transform_cfg)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
        shutil.rmtree(CACHES, ignore_errors=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke_record.json"), "w") as f:
        json.dump(record, f, indent=1, default=float)
    # Each kernel of (a): its checks and times on card 0 at the shape
    # named, and its launches per rank on phase 26's paths.
    print(json.dumps({"kernels": card_launches(mc)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


CARDS_PHASE = "multi-GPU across cards over NCCL (one process a card)"


def main():
    import torch

    if sys.argv[1:2] == ["--train-child"]:
        return train_child(sys.argv[2], sys.argv[4:])
    multi = sys.argv[1:] == ["--multi-card"]
    if sys.argv[1:] and not multi:
        print("usage: python3 chip_smoke.py [--multi-card]", file=sys.stderr)
        return 2
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
    smi_all = _smi_lines()
    smi = smi_all[0]
    for line in smi_all:
        print(line, flush=True)
    kind = torch.cuda.get_device_name(0)
    n_cards = torch.cuda.device_count()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind} x {n_cards}",
          flush=True)
    record["nvidia_smi"], record["nvidia_smi_all"] = smi, smi_all
    if multi and n_cards < 2:
        print(f"--multi-card needs at least 2 cards; this machine has "
              f"{n_cards}", file=sys.stderr)
        return 2

    phase("build")
    t0 = time.time()
    if set(KERNELS) != set(_build.KERNELS):
        fail(f"the package lists the kernel sources {_build.KERNELS}")
    # The blosc1 codec (host C++, g++, links libzstd.so.1) builds beside
    # the kernels, in a thread of its own.
    from exaspim_tpu_torch.compression import blosc1

    codec_build = {}

    def build_codec():
        t = time.time()
        codec_build["ok"] = blosc1.available()
        codec_build["s"] = time.time() - t

    codec_thread = threading.Thread(target=build_codec)
    codec_thread.start()
    build_s = _build.build_all(KERNELS)
    codec_thread.join()
    record["build_s"] = time.time() - t0
    print(f"build_s={record['build_s']:.2f} (all seven sources, in parallel; "
          f"nb_conv3d {build_s['nb_conv3d']:.2f})", flush=True)
    if not codec_build.get("ok"):
        fail(f"the blosc1 codec did not build: {blosc1.unavailable_reason()}")
    record["zstd_version"] = blosc1.zstd_version()
    record["codec_build_s"] = codec_build["s"]
    print(f"blosc1_zstd.cpp: built and loaded in {codec_build['s']:.2f} s "
          f"(g++, beside the kernels); libzstd {record['zstd_version']} "
          "(ZSTD_versionString: the exact ratios follow it)", flush=True)
    print_ptxas(_build, "nb_conv3d")
    for name in ("nb_conv3d", "nb_conv3d_dw", "blocked_conv3d"):
        spills = [ln for ln in _build.build_log(name).splitlines()
                  if re.search(r"[1-9][0-9]* bytes spill", ln)]
        if spills:
            fail(f"{name} spills registers: {spills}")
    if multi:
        return multi_card_main(record, kind)

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
    clean, clean_fg = neurite_phantom((BLOCK,) * 3, n_tubes=24, seed=0)
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
    # The whole guard (bench.py:74 quality_ok) on the card's output, scored
    # through the port's quality check (ckpt_quality.score): the exact
    # blosc-zstd ratio (the port's blosc1 encoder over libzstd), PSNR, SSIM.
    from exaspim_tpu_torch.ckpt_quality import exact_codec, proxy_ratios
    from exaspim_tpu_torch.ckpt_quality import score as quality_score
    from exaspim_tpu_torch.compression.proxy import chunk_byte_histograms

    codec = exact_codec()
    s_noisy = quality_score(img, clean, codec, device="cuda")
    s_out = quality_score(out, clean, codec, device="cuda")
    q = {
        "cratio_noisy": s_noisy["cratio"],
        "cratio_denoised": s_out["cratio"],
        "psnr_noisy_db": s_noisy["psnr_db"],
        "psnr_denoised_db": s_out["psnr_db"],
        "ssim_noisy": s_noisy["ssim"],
        "ssim_denoised": s_out["ssim"],
    }
    q["cratio_gain"] = q["cratio_denoised"] / q["cratio_noisy"]
    q["psnr_gain_db"] = q["psnr_denoised_db"] - q["psnr_noisy_db"]
    ok = q["cratio_gain"] >= MIN_CRATIO_GAIN \
        and q["ssim_denoised"] >= q["ssim_noisy"] \
        and q["psnr_gain_db"] >= MIN_PSNR_GAIN_DB
    print(f"cratio {q['cratio_noisy']} -> {q['cratio_denoised']} gain "
          f"{q['cratio_gain']:.4f} (>= {MIN_CRATIO_GAIN}; exact, "
          f"{codec.config}; r05 {REF_R05['cratio_gain']})")
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
          f"guard) beside the exact {q['cratio_noisy']} -> "
          f"{q['cratio_denoised']} gain {q['cratio_gain']:.4f}", flush=True)
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

    phase(f"live teachers: precompute(source='live') on two {LIVE_SIDE}^3 "
          "brains")
    record["live"] = live_path(img, clean, clean_fg)
    shutil.rmtree(WORK, ignore_errors=True)

    phase("production-scale training: resident, streamed and sharded")
    record["scale"] = scale_path(train_dir, val_dir,
                                 record["train"]["step_s"])
    shutil.rmtree(WORK, ignore_errors=True)

    phase("codecs: the slice codecs and ratios on the 256^3 pair")
    gloo = start_gloo_ranks(img, patch, batch, train_dir)
    record["codecs"] = codec_path(img, out)

    phase("multi-GPU: two processes over gloo, then NCCL at world size 1")
    record["multi_gpu"] = mgpu = multi_gpu_path(gloo, img, patch, batch,
                                                train_dir, val_dir)
    shutil.rmtree(WORK, ignore_errors=True)

    phase(CARDS_PHASE)
    if n_cards >= 2:
        record["multi_card"] = multi_card_path(img, patch, batch, train_dir,
                                               val_dir, transform_cfg)
        shutil.rmtree(WORK, ignore_errors=True)
    else:
        print(f"not run: it needs at least 2 cards and this machine has "
              f"{n_cards} (python3 chip_smoke.py --multi-card runs it "
              "alone)", flush=True)
    shutil.rmtree(CACHES, ignore_errors=True)

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
        **matching_rows(matching)[0],
    }, {
        "name": "bm4d_match_topk",
        "path": "teachers",
        "route": "cuda",
        "source": "exaspim_tpu_torch/csrc/bm4d_match.cu",
        "timed_as": "exaspim_tpu_torch/csrc/bm4d_select.cu (the fused "
                    "kernel's selection, bm4d_select.cuh, over a table)",
        "replaces": "exaspim_tpu/ops/pallas_bm4d.py:126",
        "launches": teach["match_topk"],
        **matching_rows(matching)[1],
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
    # Phase 22: the fused matcher's launches in the live precompute() run.
    # Phase 23: rows 1-3 and 6 in the counted (longer) train() run of the
    # streamed and of the sharded path. Phase 25: row 1-2's launches in the
    # sharded predicts of the 256^3 block (both stitch branches; over the
    # two gloo ranks, then at world size 1 over NCCL), rows 1-3 in the
    # train(data_parallel=True) run, rows 4-5 in bm4d_sharded (two gloo
    # ranks, then world size 1).
    demo = record["demo"]["launches"]
    n2v = record["n2v"]["launches"]
    scale = record["scale"]
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
        if key == "match_topk":
            k["live_launches"] = record["live"]["launches"]
        if key in scale["stream"]["launches"] and k["path"] == "training":
            k["stream_launches"] = scale["stream"]["launches"][key]
            k["shard_launches"] = scale["shards"]["launches"][key]
        if k["name"] in ("nb_conv3d", "nb_conv3d_dw"):
            d = record["n2v"]["conv" if k["name"] == "nb_conv3d" else "dw"]
            k["n2v_step"] = per_step(d["recs"], d["counts"])
        if k["name"] == "nb_conv3d (inference path)":
            k["sharded_launches"] = {
                "gloo_2_ranks": sum(r[f"{b}_launches"] for r in mgpu[
                    "gloo"]["ranks"] for b in ("canvas", "scatter")),
                "nccl_world_1": sum(mgpu["nccl"][b]["launches"]
                                    for b in ("canvas", "scatter"))}
        if k["name"] in ("nb_conv3d", "nb_conv3d_dw"):
            k["dp_launches"] = mgpu["nccl"]["train"]["launches"][k["name"]]
        if key == "match_topk":
            k["sharded_launches"] = {
                "gloo_2_ranks": sum(r["bm4d_launches"]
                                    for r in mgpu["gloo"]["ranks"]),
                "nccl_world_1": mgpu["nccl"]["bm4d_launches"]}
        if k["name"] == "nb_conv3d (inference path)":
            k["reference_launches"] = imported
            ref = record["reference"]
            if ref["conv_checks"]:
                # The new shapes of (d) at the block's batch, per batch.
                k["reference_new_shapes"] = per_step(ref["conv_checks"],
                                                      ref["conv_counts"])
    if "multi_card" in record:
        # Phase 26: each row's launches per rank on the paths across cards.
        across = {k["name"]: k["launches_per_rank"]
                  for k in card_launches(record["multi_card"])}
        for k in kernels:
            name = {"nb_conv3d (inference path)": "nb_conv3d"}.get(
                k["name"], k["name"])
            if name in across:
                k["multi_card_launches"] = across[name]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
