"""Train BM4DNet from precomputed caches (the port's training entry).

Counterpart of ``scripts/train_bm4dnet.py``, with the same defaults: the
transform comes from the cache contract (every cache dir must agree), a
width-1.0 UNet in bf16 with f32 params, batch 32, AdamW lr 1e-3 with a
cosine schedule, ``fg_weight`` 0, the card-resident cache when it fits,
and checkpoint weights with cratio 10. The run config is recorded next to
the checkpoints.

Usage (on the card):
    python -m exaspim_tpu_torch.train.train_bm4dnet --train-cache /c/train \\
        --val-cache /c/val --out /runs/bm4dnet [--epochs 50] ...

Flags of the reference that the port does not support yet
(``--config-json``, ``--data-parallel``, ``--augment``,
``--full-state-every``) raise. ``--exact-cratio-examples 0`` skips the
exact host cratio where neither libblosc nor ``zstandard`` is installed.
"""

from __future__ import annotations

import argparse

import torch

from exaspim_tpu_torch.data.cache import (
    CachedPatchDataset,
    CachedValidateDataset,
    load_cache_transform,
)
from exaspim_tpu_torch.models import UNet, build_model
from exaspim_tpu_torch.train.trainer import Trainer
from exaspim_tpu_torch.transforms import build_transform

__all__ = ["train", "main", "CHECKPOINT_WEIGHTS"]

#: the reference's compression operating point
CHECKPOINT_WEIGHTS = {
    "fg_mae": 1.0, "bg_mae": 0.2, "top_pct_error": 0.5, "cratio": 10.0,
}


def train(train_cache, val_cache, output_dir, *, epochs=50, batch_size=32,
          lr=1e-3, fg_weight=0.0, loss_eps=1e-3, preserve_foreground=False,
          val_every=1000, seed=42, width_multiplier=1.0, model_cfg=None,
          resume=None, bf16=True, checkpoint_weights=None,
          max_val_examples=None, data_parallel=False, device_cache="auto",
          device_cache_budget=8 << 30, augment=False,
          exact_cratio_examples=16, log_every=50, device="cuda"):
    """Run cache-only training; returns the Trainer (its ``state`` holds
    the final train state)."""
    if data_parallel:
        raise NotImplementedError(
            "data-parallel training comes with the multi-GPU slice")
    if augment:
        raise NotImplementedError(
            "augment=True comes with a later slice of the port")
    train_cache, val_cache = list(train_cache), list(val_cache)
    transform = build_transform(load_cache_transform(train_cache + val_cache))
    train_ds = CachedPatchDataset(train_cache)
    val_ds = CachedValidateDataset(val_cache)

    dtype = torch.bfloat16 if bf16 else torch.float32
    if resume:
        from exaspim_tpu_torch.train.checkpoint import load_checkpoint

        resume = load_checkpoint(resume)
        if model_cfg is None:
            model_cfg = resume["model_config"]
    if model_cfg:
        model = build_model(model_cfg, dtype=dtype, device=device)
    else:
        model = UNet(width_multiplier=width_multiplier, dtype=dtype)
    trainer = Trainer(
        output_dir, model, transform, lr=lr, epochs=epochs,
        batch_size=batch_size, fg_weight=fg_weight, loss_eps=loss_eps,
        preserve_foreground=preserve_foreground, val_every=val_every,
        checkpoint_weights=checkpoint_weights or CHECKPOINT_WEIGHTS,
        seed=seed, max_val_examples=max_val_examples,
        device_cache=device_cache, device_cache_budget=device_cache_budget,
        exact_cratio_examples=exact_cratio_examples, log_every=log_every,
        device=device,
    )
    trainer.save_config({
        "train_cache": train_cache,
        "val_cache": val_cache,
        "bf16": bf16,
    })
    if resume:
        trainer.load_pretrained_weights(resume)
    trainer.state = trainer.run(train_ds, val_ds)
    return trainer


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--config-json")
    p.add_argument("--train-cache", nargs="+")
    p.add_argument("--val-cache", nargs="+")
    p.add_argument("--out")
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--fg-weight", type=float, default=0.0)
    p.add_argument("--loss-eps", type=float, default=1e-3)
    p.add_argument("--preserve-foreground", action="store_true")
    p.add_argument("--val-every", type=int, default=1000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--width-multiplier", type=float, default=1.0)
    p.add_argument("--resume", help="checkpoint to warm-start from")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--max-val-examples", type=int)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto")
    p.add_argument("--device-cache-budget-gb", type=float, default=8.0)
    p.add_argument("--augment", action="store_true")
    p.add_argument("--full-state-every", type=int)
    p.add_argument("--exact-cratio-examples", type=int, default=16,
                   help="examples per validation whose exact chunked "
                        "cratio is measured on the host (0: none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    unsupported = [flag for flag, on in (
        ("--config-json", args.config_json),
        ("--full-state-every", args.full_state_every is not None),
    ) if on]
    if unsupported:
        raise NotImplementedError(
            f"{', '.join(unsupported)}: not supported by the port yet")
    if not (args.train_cache and args.val_cache and args.out):
        p.error("--train-cache/--val-cache/--out are required")
    return train(
        args.train_cache, args.val_cache, args.out, epochs=args.epochs,
        batch_size=args.batch_size, lr=args.lr, fg_weight=args.fg_weight,
        loss_eps=args.loss_eps,
        preserve_foreground=args.preserve_foreground,
        val_every=args.val_every, seed=args.seed,
        width_multiplier=args.width_multiplier, resume=args.resume,
        bf16=not args.no_bf16, max_val_examples=args.max_val_examples,
        data_parallel=args.data_parallel,
        device_cache={"auto": "auto", "on": True, "off": False}[
            args.device_cache],
        device_cache_budget=int(args.device_cache_budget_gb * (1 << 30)),
        augment=args.augment,
        exact_cratio_examples=args.exact_cratio_examples,
        device=args.device,
    )


if __name__ == "__main__":
    main()
