"""End-to-end run on synthetic data, the way a user runs the system.

Counterpart of ``scripts/demo_end_to_end.py``, with its flags and
defaults: precompute a train and a val cache of neurite phantoms with BM4D
teachers, train BM4DNet on them, denoise a held-out 128³ block with the
best checkpoint, and write ``summary.json`` with the compression gain and
the fidelity against the clean phantom.

    python -m exaspim_tpu_torch.demo_end_to_end --out DIR \\
        [--n-train 256] [--epochs 8] [--width 1.0] [--device cuda|cpu]

It runs on the card (bf16 compute, f32 params, as the JAX demo) unless
``--device cpu`` is given (f32 there, on the plain versions of the
kernels). The summary has the JAX demo's keys and roundings. The exact
ratios (``cratio_raw``, ``cratio_denoised``, ``cratio_gain``, and the
``val_cratio`` of 16 validation examples that checkpoint selection
weighs, as in the JAX demo) need only libzstd: the codec is the port's
own blosc1 encoder, whose frames are libblosc's. Beside them stand
``cratio_proxy_raw``, ``cratio_proxy_denoised`` and
``cratio_proxy_gain``: the device-side entropy proxy of the noisy and the
denoised block, from one histogram launch on the pair.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from exaspim_tpu_torch.data import precompute as precompute_mod
from exaspim_tpu_torch.train import train_bm4dnet

__all__ = ["main", "score_checkpoint", "held_out_volumes", "TRANSFORM"]

#: the frozen intensity transform of the demo's caches
TRANSFORM = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def held_out_volumes():
    """``(clean, noisy)``: the held-out 128³ phantom (16 tubes, seed 999)
    and its noisy observation (seed 1000)."""
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )

    clean, _ = neurite_phantom((128, 128, 128), n_tubes=16, seed=999)
    return clean, noisy_observation(clean, seed=1000)


def score_checkpoint(ckpt, device="cuda", dtype=None):
    """Denoise the held-out block with ``ckpt`` and score it: the demo's
    summary fields of the checkpoint (cratio, PSNR and SSIM against the
    clean phantom, the count-space metrics with the foreground mask of the
    clean block, the proxy ratios, ``predict_128c_s`` and ``cratio_gain``),
    rounded as the JAX demo rounds them. ``dtype`` defaults to bf16 on the
    card and f32 on the CPU."""
    from exaspim_tpu_torch.ckpt_quality import exact_codec, proxy_ratios
    from exaspim_tpu_torch.ckpt_quality import score as score_volume
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.ops.metrics import (
        evaluate_example,
        make_foreground_mask,
    )
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    if dtype is None:
        dtype = torch.float32 if device == "cpu" else torch.bfloat16
    model, transform = restore_pipeline(ckpt, dtype=dtype, device=device)
    clean, noisy = held_out_volumes()
    t0 = time.time()
    with torch.no_grad():
        denoised = predict(noisy, model, transform, device=device)
    t_pred = time.time() - t0
    del model

    codec = exact_codec()
    clean_u16 = np.clip(np.round(clean), 0, 65535).astype(np.uint16)
    fg = make_foreground_mask(clean_u16)
    metrics = evaluate_example(denoised, noisy, clean_u16, fg)
    raw = score_volume(noisy, clean, codec, device)
    out = score_volume(denoised, clean, codec, device)
    p_raw, p_out = proxy_ratios([noisy, denoised], device)
    return {
        "checkpoint": ckpt,
        "cratio_raw": raw["cratio"],
        "cratio_denoised": out["cratio"],
        "psnr_vs_clean_raw": round(raw["psnr_db"], 2),
        "psnr_vs_clean_denoised": round(out["psnr_db"], 2),
        "ssim_vs_clean_raw": round(raw["ssim"], 4),
        "ssim_vs_clean_denoised": round(out["ssim"], 4),
        **{k: round(float(v), 3) for k, v in metrics.items()},
        "cratio_proxy_raw": round(p_raw, 4),
        "cratio_proxy_denoised": round(p_out, 4),
        "cratio_proxy_gain": round(p_out / p_raw, 4),
        "predict_128c_s": round(t_pred, 2),
        "cratio_gain": round(out["cratio"] / raw["cratio"], 3),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--n-train", type=int, default=256)
    p.add_argument("--n-val", type=int, default=16)
    p.add_argument("--patch", type=int, default=64)
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--width", type=float, default=1.0)
    p.add_argument("--fg-weight", type=float, default=0.0)
    p.add_argument("--loss-eps", type=float, default=1e-3)
    p.add_argument("--sigma-bm4d", type=float, default=24.0)
    p.add_argument("--bm4d-step", type=int, default=3,
                   help="BM4D reference-grid step for teacher generation "
                        "(3 = parity default; 4 = documented fast profile)")
    p.add_argument("--augment", action="store_true",
                   help="one of the 48 cube orientations per train step "
                        "(device-cache mode)")
    p.add_argument("--device-cache-budget-gb", type=float, default=8.0)
    p.add_argument("--full-state-every", type=int, default=4,
                   help="write the full-state resume checkpoint every "
                        "Nth validation")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run the "
                           "demo on the CPU")
    from exaspim_tpu_torch.train.checkpoint import find_best_checkpoint

    os.makedirs(args.out, exist_ok=True)
    patch = (args.patch,) * 3

    # 1. Precompute caches with real BM4D teachers.
    t0 = time.time()
    train_cache = os.path.join(args.out, "cache_train")
    val_cache = os.path.join(args.out, "cache_val")
    if not os.path.exists(os.path.join(train_cache, "raw.npy")):
        for out_dir, split, n in ((train_cache, "train", args.n_train),
                                  (val_cache, "val", args.n_val)):
            precompute_mod.precompute(
                out_dir, split=split, source="synthetic", n=n, patch=patch,
                sigma_bm4d=args.sigma_bm4d, seed=args.seed,
                transform_cfg=TRANSFORM, bm4d_step=args.bm4d_step,
                device=args.device,
            )
    t_cache = time.time() - t0

    # 2. Train.
    t0 = time.time()
    trainer = train_bm4dnet.train(
        [train_cache], [val_cache], os.path.join(args.out, "run"),
        epochs=args.epochs, batch_size=args.batch_size, lr=1e-3,
        fg_weight=args.fg_weight, loss_eps=args.loss_eps,
        val_every=200, seed=args.seed,
        width_multiplier=args.width, max_val_examples=8,
        augment=args.augment,
        device_cache_budget=int(args.device_cache_budget_gb * (1 << 30)),
        full_state_every=args.full_state_every,
        bf16=args.device != "cpu",
        exact_cratio_examples=16,
        device=args.device,
    )
    t_train = time.time() - t0
    ckpt_dir = trainer.ckpt_dir
    del trainer

    # 3. Held-out block: tiled denoise + metrics.
    held = score_checkpoint(find_best_checkpoint(ckpt_dir),
                            device=args.device)
    tail = ("predict_128c_s", "cratio_gain")
    summary = {
        **{k: v for k, v in held.items() if k not in tail},
        "cache_build_s": round(t_cache, 1),
        "train_s": round(t_train, 1),
        "predict_128c_s": held["predict_128c_s"],
        "n_train": args.n_train,
        "epochs": args.epochs,
        "width": args.width,
        "loss_eps": args.loss_eps,
        "sigma_bm4d": args.sigma_bm4d,
        "bm4d_step": args.bm4d_step,
        "augment": args.augment,
        "cratio_gain": held["cratio_gain"],
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
