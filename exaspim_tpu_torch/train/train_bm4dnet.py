"""Train BM4DNet from precomputed caches (the port's training entry).

Counterpart of ``scripts/train_bm4dnet.py``, with the same defaults: the
transform comes from the cache contract (every cache dir must agree), a
width-1.0 UNet (or the model of ``--model-config``, built by
:func:`~exaspim_tpu_torch.models.build_model`) in bf16 with f32 params,
batch 32, AdamW lr 1e-3 with a cosine schedule, ``fg_weight`` 0, the
card-resident cache when it fits, and checkpoint weights with cratio 10.
The run config is recorded next to the checkpoints.

Usage (on the card):
    python -m exaspim_tpu_torch.train.train_bm4dnet --train-cache /c/train \\
        --val-cache /c/val --out /runs/bm4dnet [--epochs 50] ...

``--config-json`` takes a :class:`~exaspim_tpu_torch.config.TrainConfig`
file that drives the run as in the JAX script: its fields replace the
training flags, which are then ignored. The port's own flags
(``--exact-cratio-examples``, ``--device``) still apply.
The exact host cratio of ``--exact-cratio-examples`` validation
examples (16, as the JAX trainer measures them) needs only libzstd: the
codec is the port's own blosc1 encoder, so it is measured on the card's
machine too; ``--exact-cratio-examples 0`` measures none.

``--data-parallel`` trains over every process of the job, one device
each (:mod:`exaspim_tpu_torch.parallel`): launch it with ``torchrun``,
whose environment :func:`~exaspim_tpu_torch.parallel.initialize_multihost`
reads (NCCL on the card, gloo with ``--device cpu``)::

    torchrun --nproc_per_node 4 -m exaspim_tpu_torch.train.train_bm4dnet \
        --data-parallel --train-cache /c/train --val-cache /c/val --out /r

The global batch (``--batch-size``) splits evenly over the processes;
only rank 0 writes checkpoints and logs. A plain run with
``--data-parallel`` is a world of one.
"""

from __future__ import annotations

import argparse
import json

import torch

from exaspim_tpu_torch.data.cache import (
    CachedPatchDataset,
    CachedValidateDataset,
    load_cache_transform,
)
from exaspim_tpu_torch.models import build_model
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
          device_cache_budget=8 << 30, augment=False, full_state_every=1,
          exact_cratio_examples=16, log_every=50, device="cuda"):
    """Run cache-only training; returns the Trainer (its ``state`` holds
    the final train state). ``data_parallel`` joins the job's process
    group (:func:`~exaspim_tpu_torch.parallel.initialize_multihost`; a
    no-op solo) and trains over a mesh of all its ranks."""
    mesh = None
    if data_parallel:
        from exaspim_tpu_torch.parallel import initialize_multihost, make_mesh

        initialize_multihost(device=device)
        mesh = make_mesh(axis="data", device=device)
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
    model = build_model(
        model_cfg or {"model": "UNet", "width_multiplier": width_multiplier},
        dtype=dtype, device=device)
    trainer = Trainer(
        output_dir, model, transform, lr=lr, epochs=epochs,
        batch_size=batch_size, fg_weight=fg_weight, loss_eps=loss_eps,
        preserve_foreground=preserve_foreground, val_every=val_every,
        checkpoint_weights=checkpoint_weights or CHECKPOINT_WEIGHTS,
        seed=seed, max_val_examples=max_val_examples,
        device_cache=device_cache, device_cache_budget=device_cache_budget,
        exact_cratio_examples=exact_cratio_examples, augment=augment,
        full_state_every=full_state_every, log_every=log_every,
        mesh=mesh, device=device,
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
    p.add_argument("--config-json",
                   help="TrainConfig JSON; when given it drives the whole "
                        "run and the training flags are ignored")
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
    p.add_argument("--width-multiplier", type=float, default=1.0,
                   help="the UNet's width when no --model-config is given")
    p.add_argument("--model-config", type=json.loads,
                   help="the model to train, as a checkpoint's model_config "
                        'in JSON (\'{"model": "RCAN3D"}\'); default the '
                        "UNet at --width-multiplier")
    p.add_argument("--resume", help="checkpoint to warm-start from")
    p.add_argument("--no-bf16", action="store_true")
    p.add_argument("--max-val-examples", type=int)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--device-cache", choices=("auto", "on", "off"),
                   default="auto")
    p.add_argument("--device-cache-budget-gb", type=float, default=8.0)
    p.add_argument("--augment", action="store_true",
                   help="one of the 48 cube orientations per train step "
                        "(device-cache mode, cubic patches)")
    p.add_argument("--full-state-every", type=int, default=1,
                   help="write the full-state resume checkpoint every Nth "
                        "validation")
    p.add_argument("--exact-cratio-examples", type=int, default=16,
                   help="examples per validation whose exact chunked "
                        "cratio is measured on the host (0: none)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    port = dict(exact_cratio_examples=args.exact_cratio_examples,
                device=args.device)
    if args.model_config:
        port["model_cfg"] = args.model_config
    if args.config_json:
        from exaspim_tpu_torch.config import TrainConfig

        c = TrainConfig.from_json(args.config_json)
        return train(
            c.train_cache, c.val_cache, c.output_dir, epochs=c.epochs,
            batch_size=c.batch_size, lr=c.lr, fg_weight=c.fg_weight,
            preserve_foreground=c.preserve_foreground,
            val_every=c.val_every, seed=c.seed,
            width_multiplier=c.width_multiplier, resume=c.resume,
            bf16=c.bf16, checkpoint_weights=c.checkpoint_weights,
            data_parallel=c.data_parallel, **port,
        )
    if not (args.train_cache and args.val_cache and args.out):
        p.error("--train-cache/--val-cache/--out (or --config-json) are "
                "required")
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
        augment=args.augment, full_state_every=args.full_state_every,
        **port,
    )


if __name__ == "__main__":
    main()
