"""Self-supervised Noise2Void training: no teachers, noisy data only.

Counterpart of ``scripts/train_n2v.py``, with its flags and defaults: train
a blind-spot denoiser (``N2V2UNet``, width 0.5, value head, head drawn from
a normal) on noisy 64³ phantom patches alone, then denoise a held-out 128³
block and score it against the clean phantom.

    python -m exaspim_tpu_torch.train.train_n2v --out DIR [--steps 6000]
        [--n-patches 512] [--sigma-gain G] [--device cuda|cpu]
    python -m exaspim_tpu_torch.train.train_n2v --out DIR --score CKPT
        [--device cpu]

It runs on the card (bf16 compute, f32 params) unless ``--device cpu`` is
given (f32 there, on the plain versions of the kernels). The patch pool
lives on the device as uint16 bits and each step gathers its batch there;
the batch indices come from ``np.random.default_rng(seed)`` and the blind
spots from ``fold_in(key(seed), step)``, as in the JAX script. It writes
``n2v.msgpack`` and ``summary.json`` with the script's keys. Where no
exact codec is installed (libblosc or ``zstandard``), as on the card's
machine, ``cratio_noisy`` and ``cratio_denoised`` are ``null`` and one line
on stderr says why; beside them stand the entropy-proxy ratios of the
noisy and the denoised block and their gain, from one histogram launch,
and ``step_s``, the seconds a step between the step-200 log and the last.
``--score CKPT`` skips training and scores a checkpoint on the held-out
block the same way (``held_out.json``): with ``--device cpu`` on a machine
with an exact codec, the cratio of a checkpoint trained on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

__all__ = ["main", "held_out_volumes", "held_out_scores", "TRANSFORM"]

#: the frozen intensity transform of the script
TRANSFORM = {"kind": "asinh", "params": {"offset": 100.0, "scale": 60.0}}


def held_out_volumes():
    """``(clean, noisy)``: the held-out 128³ phantom (16 tubes, seed 991)
    and its noisy observation (seed 992)."""
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )

    clean, _ = neurite_phantom((128, 128, 128), n_tubes=16, seed=991)
    return clean, noisy_observation(clean, seed=992)


def held_out_scores(model, transform, patch=64, device="cuda"):
    """Denoise the held-out block with ``model`` (patch ``patch``, overlap
    12, trim 5, batch 8, the prediction clamped to the input's range) and
    score it against the clean phantom: the script's cratio, PSNR and SSIM
    fields, rounded as it rounds them, and the proxy ratios beside them."""
    from exaspim_tpu_torch.ckpt_quality import exact_codec, proxy_ratios
    from exaspim_tpu_torch.ckpt_quality import score as score_volume
    from exaspim_tpu_torch.inference import predict

    clean, noisy = held_out_volumes()
    # output_clip: a self-supervised prediction can overshoot in the
    # transform domain, and the asinh inverse turns a small overshoot at a
    # bright voxel into a 65535 clamp.
    with torch.no_grad():
        den = predict(noisy, model, transform, patch_size=patch, overlap=12,
                      trim=5, batch_size=8, output_clip="input",
                      device=device)
    codec, why = exact_codec()
    if codec is None:
        print(f"cratio: unavailable ({why})", file=sys.stderr, flush=True)
    raw = score_volume(noisy, clean, codec, device)
    out = score_volume(den, clean, codec, device)
    p_noisy, p_den = proxy_ratios([noisy, den], device)
    return {
        "cratio_noisy": raw["cratio"],
        "cratio_denoised": out["cratio"],
        "psnr_noisy_db": round(raw["psnr_db"], 2),
        "psnr_denoised_db": round(out["psnr_db"], 2),
        "ssim_noisy": round(raw["ssim"], 4),
        "ssim_denoised": round(out["ssim"], 4),
        "cratio_proxy_noisy": round(p_noisy, 4),
        "cratio_proxy_denoised": round(p_den, 4),
        "cratio_proxy_gain": round(p_den / p_noisy, 4),
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=6000)
    p.add_argument("--n-patches", type=int, default=512)
    p.add_argument("--patch", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--width", type=float, default=0.5)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--mask-rate", type=float, default=0.005)
    p.add_argument("--sigma-gain", type=float, default=None,
                   help="enable the sigma-aware count-space loss with "
                        "this Poisson gain (try 1.0); see train/n2v.py")
    p.add_argument("--sigma-read", type=float, default=0.0,
                   help="read-noise std (counts) for the sigma model")
    p.add_argument("--model", default="N2V2UNet",
                   choices=["N2V2UNet", "UNet"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--score", metavar="CKPT", default=None,
                   help="score CKPT on the held-out block instead of "
                        "training (writes held_out.json)")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")
    device = torch.device(args.device)
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    os.makedirs(args.out, exist_ok=True)
    if args.score is not None:
        from exaspim_tpu_torch.train.checkpoint import restore_pipeline

        model, t = restore_pipeline(args.score, dtype=dtype, device=device)
        held = {"checkpoint": args.score,
                **held_out_scores(model, t, args.patch, device)}
        with open(os.path.join(args.out, "held_out.json"), "w") as f:
            json.dump(held, f, indent=2)
        print(json.dumps(held, indent=2))
        return held

    from exaspim_tpu_torch.data.loader import to_tensor
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.models import MODEL_REGISTRY
    from exaspim_tpu_torch.train import prng
    from exaspim_tpu_torch.train.checkpoint import save_checkpoint
    from exaspim_tpu_torch.train.n2v import make_n2v_train_step
    from exaspim_tpu_torch.train.state import create_train_state
    from exaspim_tpu_torch.transforms import build_transform

    P = args.patch
    rng = np.random.default_rng(args.seed)

    # Noisy-only training pool (the N2V premise: no clean/teacher data).
    print(f"[n2v] generating {args.n_patches} noisy patches", flush=True)
    patches = np.empty((args.n_patches, P, P, P), np.uint16)
    for i in range(args.n_patches):
        clean, _ = neurite_phantom(
            (P, P, P), n_tubes=6, seed=args.seed * 100000 + i)
        patches[i] = noisy_observation(clean, seed=args.seed * 7 + i)
    pool = to_tensor(patches, device)

    t = build_transform(TRANSFORM)
    # A head drawn from a normal (a zero head blocks every masked voxel's
    # gradient) and the value head: the residual form would learn
    # target − substituted centre and misfire on unmasked inputs.
    model = MODEL_REGISTRY[args.model](
        width_multiplier=args.width, dtype=dtype, head_init="normal",
        residual=False).to(device)
    state = create_train_state(model, lr=args.lr, total_steps=args.steps,
                               seed=args.seed)
    step_fn = make_n2v_train_step(
        transform=t, mask_rate=args.mask_rate, sigma_gain=args.sigma_gain,
        sigma_read=args.sigma_read)
    base_key = prng.key(args.seed)

    t0 = time.time()
    log, walls = [], {}
    for s in range(args.steps):
        idx = rng.integers(0, args.n_patches, args.batch_size)
        x = pool.index_select(0, torch.from_numpy(idx).to(device))[..., None]
        state, loss = step_fn(state, x, prng.fold_in(base_key, s))
        if s % 200 == 0 or s == args.steps - 1:
            loss = float(loss)
            walls[s] = time.time() - t0
            log.append({"step": s, "loss": loss,
                        "wall_s": round(walls[s], 1)})
            print(f"[n2v] step {s} loss {loss:.5f}", flush=True)
    last = args.steps - 1
    step_s = ((walls[last] - walls[200]) / (last - 200)
              if last > 200 else None)
    del pool

    ckpt = os.path.join(args.out, "n2v.msgpack")
    save_checkpoint(ckpt, state.params, model.config, t.cfg,
                    step=args.steps, score=float(loss))

    # Held-out evaluation (clean known only to the evaluator).
    model.eval()
    held = held_out_scores(model, t, P, device)
    summary = {
        "model": args.model,
        "sigma_gain": args.sigma_gain,
        "steps": args.steps,
        "width": args.width,
        "checkpoint": ckpt,
        **{k: held[k] for k in ("cratio_noisy", "cratio_denoised",
                                "psnr_noisy_db", "psnr_denoised_db",
                                "ssim_noisy", "ssim_denoised")},
        "train_log": log,
        **{k: held[k] for k in ("cratio_proxy_noisy",
                                "cratio_proxy_denoised",
                                "cratio_proxy_gain")},
        "step_s": step_s,
    }
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps({k: v for k, v in summary.items()
                      if k != "train_log"}, indent=2))
    return summary


if __name__ == "__main__":
    main()
