"""Score checkpoints on the bench phantom: the main path's quality check.

PyTorch counterpart of ``scripts/ckpt_quality.py``. It runs the quality
protocol of ``bench.py`` for one or more checkpoints: the 256³ neurite
phantom (seeds 0 and 1), denoised by ``predict(..., patch_size="auto")``,
scored by the blosc-zstd-6 chunked compression ratio and by PSNR and SSIM
against the clean phantom. It prints one JSON record for the noisy volume
and one per checkpoint, with the script's fields and rounding:

* noisy: ``family``, ``cratio_noisy``, ``psnr_noisy_db``, ``ssim_noisy``;
* per checkpoint: ``ckpt``, ``cratio_denoised``, ``cratio_gain``,
  ``psnr_denoised_db``, ``ssim_denoised``.

The exact ratio needs libblosc (or the ``zstandard`` package). Where
neither is installed, as on the card's machine, the cratio fields are
``null``, one line on stderr says why, and nothing is estimated in their
place. Beside them each record carries the device-side entropy proxy
(``compression/proxy.py``: ``cratio_proxy_noisy``; per checkpoint
``cratio_proxy_denoised`` and ``cratio_proxy_gain``), from one
``cratio_proxy_batch`` launch on the noisy and denoised pair: the only
compression figure the card's machine can give.

    python -m exaspim_tpu_torch.ckpt_quality CKPT [CKPT ...] [--block 256]
        [--family a|b] [--seed-clean 0] [--seed-noise 1]
        [--volume-offset none|auto] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given, in bf16 there as the
script runs it, and in f32 on the CPU, where the plain conv runs
(:func:`quality_records` also takes the dtype and the patch size).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

__all__ = ["main", "quality_records", "score", "proxy_ratios",
           "bench_volumes"]

CLEVEL = 6


def bench_volumes(block=256, family="a", seed_clean=0, seed_noise=1):
    """``(clean, noisy)`` of the script: ``neurite_phantom`` with 24 tubes
    (family ``a``, the bench's) or ``neurite_phantom_b`` (family ``b``),
    and its ``noisy_observation``."""
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        neurite_phantom_b,
        noisy_observation,
    )

    shape = (block,) * 3
    if family == "a":
        clean, _ = neurite_phantom(shape, n_tubes=24, seed=seed_clean)
    elif family == "b":
        clean, _ = neurite_phantom_b(shape, seed=seed_clean)
    else:
        raise ValueError(f"family must be 'a' or 'b', got {family!r}")
    return clean, noisy_observation(clean, seed=seed_noise)


def exact_codec():
    """The script's codec (blosc-zstd level 6), or ``(None, why)`` where
    no exact codec is installed."""
    from exaspim_tpu_torch.compression import best_codec

    try:
        return best_codec(clevel=CLEVEL), None
    except RuntimeError as exc:
        return None, str(exc)


def score(vol, clean, codec=None, device="cuda"):
    """Unrounded scores of one uint16 volume against the clean phantom:
    ``cratio`` (``None`` without a codec), ``psnr_db`` and ``ssim`` (on
    ``device``, data range the clean maximum)."""
    from exaspim_tpu_torch.compression import compute_cratio
    from exaspim_tpu_torch.ops.ssim import psnr, ssim3d

    drange = float(np.max(clean))
    v = torch.from_numpy(np.asarray(vol, dtype=np.float32)).to(device)
    c = torch.from_numpy(np.asarray(clean, dtype=np.float32)).to(device)
    return {
        "cratio": None if codec is None else compute_cratio(vol, codec),
        "psnr_db": float(psnr(v, c, drange)),
        "ssim": float(ssim3d(v, c, data_range=drange)),
    }


def proxy_ratios(vols, device="cuda", chunk=64):
    """Entropy-proxy ratios of uint16 volumes of one shape, from one
    ``cratio_proxy_batch`` call on the stack (one histogram launch on the
    card)."""
    from exaspim_tpu_torch.compression.proxy import cratio_proxy_batch

    batch = torch.from_numpy(np.stack(vols).astype(np.int32)).to(device)
    return [float(r) for r in cratio_proxy_batch(batch, chunk).cpu()]


def _volume_transform(transform, img, seed_clean, seed_noise):
    """The script's ``--volume-offset auto``: the frozen transform composed
    with the difference between this volume's background estimate and the
    estimate on the family the transform was calibrated for."""
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.transforms import estimate_offset, with_offset

    ref_clean, _ = neurite_phantom((64, 64, 64), n_tubes=2, seed=seed_clean)
    est_train = estimate_offset(noisy_observation(ref_clean, seed=seed_noise))
    return with_offset(transform, estimate_offset(img) - est_train)


def quality_records(ckpts, block=256, family="a", seed_clean=0, seed_noise=1,
                    volume_offset="none", device="cuda", dtype=None,
                    patch_size="auto"):
    """The records the script prints (see the module docstring), as dicts:
    the noisy volume's first, then one per checkpoint path."""
    from exaspim_tpu_torch.inference import predict
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline

    if volume_offset not in ("none", "auto"):
        raise ValueError(f"volume_offset must be 'none' or 'auto', got "
                         f"{volume_offset!r}")
    if dtype is None:
        dtype = torch.bfloat16 if device != "cpu" else torch.float32
    clean, img = bench_volumes(block, family, seed_clean, seed_noise)
    codec, why = exact_codec()
    if codec is None:
        print(f"cratio: unavailable ({why})", file=sys.stderr, flush=True)
    noisy = score(img, clean, codec, device)
    records = [{
        "family": family,
        "cratio_noisy": noisy["cratio"],
        "psnr_noisy_db": round(noisy["psnr_db"], 2),
        "ssim_noisy": round(noisy["ssim"], 4),
    }]
    for path in ckpts:
        model, transform = restore_pipeline(path, dtype=dtype, device=device)
        if volume_offset == "auto":
            transform = _volume_transform(transform, img, seed_clean,
                                          seed_noise)
        with torch.no_grad():
            out = predict(img, model, transform, patch_size=patch_size,
                          device=device)
        del model
        s = score(out, clean, codec, device)
        p_noisy, p_out = proxy_ratios([img, out], device)
        records[0]["cratio_proxy_noisy"] = round(p_noisy, 4)
        records.append({
            "ckpt": path,
            "cratio_denoised": s["cratio"],
            "cratio_gain": (None if codec is None
                            else round(s["cratio"] / noisy["cratio"], 3)),
            "psnr_denoised_db": round(s["psnr_db"], 2),
            "ssim_denoised": round(s["ssim"], 4),
            "cratio_proxy_denoised": round(p_out, 4),
            "cratio_proxy_gain": round(p_out / p_noisy, 4),
        })
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ckpts", nargs="+")
    p.add_argument("--block", type=int, default=256)
    p.add_argument("--family", choices=("a", "b"), default="a",
                   help="phantom family: a = bench default; b = denser/"
                        "dimmer/wider-PSF/low-pedestal generalization probe "
                        "(data/synthetic.py neurite_phantom_b)")
    p.add_argument("--seed-clean", type=int, default=0)
    p.add_argument("--seed-noise", type=int, default=1)
    p.add_argument("--volume-offset", choices=("none", "auto"),
                   default="none",
                   help="'auto' composes the frozen transform with the "
                        "difference between this volume's estimated "
                        "background and the estimate on the family the "
                        "transform was calibrated for")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to score on "
                           "the CPU")
    records = quality_records(
        args.ckpts, block=args.block, family=args.family,
        seed_clean=args.seed_clean, seed_noise=args.seed_noise,
        volume_offset=args.volume_offset, device=args.device)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return records


if __name__ == "__main__":
    main()
