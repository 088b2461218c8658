"""Training orchestration: epoch loop, validation, compression-aware
checkpoint selection.

Counterpart of ``exaspim_tpu/train/trainer.py``: step-based validation
cadence, count-space metrics of each validation batch on the device plus
the compressibility proxy (one histogram launch per batch), exact chunked
cratios of the leading examples on the host, the weighted checkpoint score
(lower is better; cratio subtracts), checkpoints named
``BM4DNet-<date>-<step>-<score>.ckpt`` in the JAX package's format, a
``config.json`` run record and a ``log.jsonl`` of events.

Two training loops, as in the reference: the whole uint16 cache resident
on the card with the batch gather inside the step (``device_cache``), or
batches streamed through the loader. The loss is read to the host only
when a step is logged (every ``log_every`` steps), so other steps add no
host sync.

Later slices of the port: rotating cache shards through device memory
(a cache larger than ``device_cache_budget``), full-state resume
checkpoints, the data-parallel (mesh) step, TensorBoard scalars and MIP
images. The exact cratio needs libblosc or ``zstandard``; without either,
pass ``exact_cratio_examples=0`` and ``val_cratio`` is 0.0, as the
reference reports it when no example was measured.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime

import numpy as np
import torch

from exaspim_tpu_torch.compression import best_codec, compute_cratio
from exaspim_tpu_torch.compression.proxy import cratio_proxy_batch
from exaspim_tpu_torch.data.loader import (
    DataLoader,
    counts_f32,
    make_count_train_collate,
    make_count_val_collate,
    prefetch_to_device,
    to_tensor,
)
from exaspim_tpu_torch.ops.metrics import (
    DEFAULT_CHECKPOINT_WEIGHTS,
    checkpoint_score,
)
from exaspim_tpu_torch.ops.metrics_device import evaluate_batch
from exaspim_tpu_torch.train.checkpoint import (
    checkpoint_filename,
    load_checkpoint,
    save_checkpoint,
)
from exaspim_tpu_torch.train.state import (
    create_train_state,
    make_cached_train_step,
    make_eval_step,
    make_train_step,
    pack_fg_bits,
)
from exaspim_tpu_torch.utils.profiling import StepTimer

__all__ = ["Trainer"]


class Trainer:
    """Train a denoiser on (raw, teacher, fg) patch datasets.

    The defaults are the reference's operating point: ``fg_weight=0``,
    ``preserve_foreground=False``. ``device`` is where the model trains
    (the card unless the caller asks for the CPU).
    """

    def __init__(self, output_dir, model, transform, *, lr=1e-3,
                 weight_decay=1e-2, epochs=50, batch_size=32,
                 fg_weight=0.0, preserve_foreground=False, val_every=1000,
                 loss_eps=1e-3, checkpoint_weights=None, clevel=6, seed=42,
                 warmup_steps=0, max_val_examples=None,
                 device_cache="auto", device_cache_budget=8 << 30,
                 exact_cratio_examples=16, log_every=50, device="cuda"):
        self.model = model
        self.transform = transform
        self.lr = lr
        self.weight_decay = weight_decay
        self.epochs = int(epochs)
        self.batch_size = int(batch_size)
        self.fg_weight = float(fg_weight)
        self.loss_eps = float(loss_eps)
        self.preserve_foreground = bool(preserve_foreground)
        self.val_every = int(val_every)
        self.checkpoint_weights = dict(
            checkpoint_weights or DEFAULT_CHECKPOINT_WEIGHTS
        )
        self.exact_cratio_examples = int(exact_cratio_examples)
        # The exact codec is built only where an exact ratio is measured:
        # the card's host may have neither libblosc nor zstandard.
        self.codec = (best_codec(clevel=clevel)
                      if self.exact_cratio_examples > 0 else None)
        self.seed = int(seed)
        self.warmup_steps = int(warmup_steps)
        self.max_val_examples = max_val_examples
        #: "auto": train from a card-resident cache when the dataset
        #: exposes its arrays, fits ``device_cache_budget`` and divides
        #: into whole batches; True forces it; False streams batches.
        self.device_cache = device_cache
        self.device_cache_budget = int(device_cache_budget)
        self.log_every = int(log_every)
        self.device = torch.device(device)

        stamp = datetime.now().strftime("%Y%m%d_%H%M")
        self.output_dir = os.fspath(output_dir)
        self.session_dir = os.path.join(self.output_dir, f"session-{stamp}")
        self.ckpt_dir = os.path.join(self.session_dir, "checkpoints")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._log_path = os.path.join(self.session_dir, "log.jsonl")
        self._pretrained_params = None
        self._pretrained_transform_cfg = None

    # ------------------------------------------------------------- setup

    def load_pretrained_weights(self, ckpt_path):
        """Stage params from a checkpoint (path or loaded dict); a
        model-config mismatch raises."""
        from exaspim_tpu_torch.models import build_model

        ckpt = (ckpt_path if isinstance(ckpt_path, dict)
                else load_checkpoint(ckpt_path))
        cfg = build_model(ckpt["model_config"], device="cpu").config
        if cfg != self.model.config:
            raise ValueError(
                "checkpoint model_config does not match this model: "
                f"{ckpt['model_config']} vs {self.model.config}"
            )
        self._pretrained_params = ckpt["params"]
        self._pretrained_transform_cfg = ckpt["transform"]

    def check_transform_cfg(self):
        """Resumed training must keep the identical intensity mapping."""
        if self._pretrained_transform_cfg is None:
            return
        if self._pretrained_transform_cfg != self.transform.cfg:
            raise ValueError(
                "resume transform cfg mismatch: checkpoint has "
                f"{self._pretrained_transform_cfg}, trainer has "
                f"{self.transform.cfg}"
            )

    def save_config(self, extra=None):
        """Merge the run config into ``session_dir/config.json``."""
        path = os.path.join(self.session_dir, "config.json")
        cfg = {}
        if os.path.exists(path):
            with open(path) as f:
                cfg = json.load(f)
        cfg.update({
            "model_config": self.model.config,
            "transform": self.transform.cfg,
            "lr": self.lr,
            "weight_decay": self.weight_decay,
            "epochs": self.epochs,
            "batch_size": self.batch_size,
            "fg_weight": self.fg_weight,
            "loss_eps": self.loss_eps,
            "preserve_foreground": self.preserve_foreground,
            "val_every": self.val_every,
            "checkpoint_weights": self.checkpoint_weights,
            "seed": self.seed,
            "warmup_steps": self.warmup_steps,
            "codec": getattr(self.codec, "config", None),
        })
        cfg.update(extra or {})
        with open(path, "w") as f:
            json.dump(cfg, f, indent=2, sort_keys=True, default=str)
        return path

    # ------------------------------------------------- device-cache mode

    def _fg_needed(self):
        """The cached step reads fg only when the loss weights it or the
        foreground-preserving target rule is on."""
        return self.preserve_foreground or self.fg_weight != 0

    def _cache_nbytes(self, ds):
        """Device bytes of the resident cache (fg bit-packed when needed,
        absent when not)."""
        raw_b = sum(a.nbytes for a in ds._raw)
        teach_b = sum(a.nbytes for a in ds._teacher)
        fg_b = -(-sum(a.nbytes for a in ds._fg) // 8) \
            if self._fg_needed() else 0
        return raw_b + teach_b + fg_b

    def _resolve_device_cache(self, train_ds):
        """True to train from a card-resident cache, with the reference's
        gating: ``"auto"`` engages only when the dataset exposes its
        arrays, holds at least one batch, fits the budget and divides into
        whole batches; ``True`` raises where it cannot be honoured."""
        forced = self.device_cache is True
        if not self.device_cache:
            return False
        if not all(hasattr(train_ds, f) for f in ("_raw", "_teacher", "_fg")):
            if forced:
                raise ValueError(
                    "device_cache=True requires a cached dataset with "
                    "in-memory (_raw, _teacher, _fg) arrays")
            return False
        n = len(train_ds)
        if n < self.batch_size:
            if forced:
                raise ValueError(
                    f"device_cache=True but the dataset ({n} patches) is "
                    f"smaller than batch_size ({self.batch_size})")
            return False
        fits = self._cache_nbytes(train_ds) <= self.device_cache_budget
        if self.device_cache == "auto":
            return fits and n % self.batch_size == 0
        if not fits:
            raise NotImplementedError(
                "the cache exceeds device_cache_budget; rotating shards "
                "through device memory comes with a later slice of the port")
        return True

    # Host staging granularity of the cache upload.
    _UPLOAD_CHUNK_BYTES = 256 << 20

    def _upload_cache(self, ds):
        """Copy the whole (raw, teacher[, fg]) cache to the device, chunk
        by chunk from the memmaps: uint16 as int16 bits, fg bit-packed
        when the loss needs it and skipped when not."""
        t0 = time.time()
        n = len(ds)

        def up(parts, host_transform=None):
            probe = parts[0][:1]
            if host_transform is not None:
                probe = host_transform(probe)
            probe = to_tensor(probe, "cpu")
            buf = torch.empty((n, *probe.shape[1:]), dtype=probe.dtype,
                              device=self.device)
            row_bytes = max(1, int(np.prod(parts[0].shape[1:]))
                            * parts[0].dtype.itemsize)
            rows = max(1, self._UPLOAD_CHUNK_BYTES // row_bytes)
            off = 0
            for p in parts:
                for lo in range(0, p.shape[0], rows):
                    chunk = np.ascontiguousarray(p[lo:lo + rows])
                    if host_transform is not None:
                        chunk = host_transform(chunk)
                    buf[off:off + len(chunk)].copy_(to_tensor(chunk, "cpu"))
                    off += len(chunk)
            return buf

        raw_dev = up(ds._raw)
        teacher_dev = up(ds._teacher)
        fg_dev = up(ds._fg, pack_fg_bits) if self._fg_needed() else None
        self._log({
            "event": "device_cache_upload",
            "rows": [0, int(n)],
            "bytes": int(self._cache_nbytes(ds)),
            "fg": "packed" if fg_dev is not None else "skipped",
            "wall_s": round(time.time() - t0, 1),
        })
        return raw_dev, teacher_dev, fg_dev

    # -------------------------------------------------------------- run

    def run(self, train_ds, val_ds):
        """Full training run; returns the final train state."""
        self.check_transform_cfg()
        train_loader = DataLoader(
            train_ds, self.batch_size,
            make_count_train_collate(self.preserve_foreground),
            shuffle=True, seed=self.seed,
        )
        val_loader = DataLoader(val_ds, self.batch_size,
                                make_count_val_collate())
        use_dev_cache = self._resolve_device_cache(train_ds)
        if use_dev_cache:
            steps_per_epoch = len(train_ds) // self.batch_size
        else:
            steps_per_epoch = len(train_loader)
        total_steps = max(1, self.epochs * steps_per_epoch)
        patch = tuple(train_ds.patch_shape)

        self.model.to(self.device)
        state = create_train_state(
            self.model, lr=self.lr,
            total_steps=total_steps, weight_decay=self.weight_decay,
            seed=self.seed, warmup_steps=self.warmup_steps,
            params=self._pretrained_params,
        )
        if use_dev_cache:
            train_step = make_cached_train_step(
                self.fg_weight, eps=self.loss_eps, transform=self.transform,
                preserve_foreground=self.preserve_foreground,
                fg_packed=self._fg_needed(), patch_shape=patch,
            )
        else:
            train_step = make_train_step(
                self.fg_weight, eps=self.loss_eps, transform=self.transform)
        eval_step = make_eval_step(self.fg_weight, eps=self.loss_eps,
                                   transform=self.transform)
        self.save_config({
            "total_steps": total_steps,
            "steps_per_epoch": steps_per_epoch,
            "device_cache": bool(use_dev_cache),
            "device": str(self.device),
        })

        step = 0
        t0 = time.time()
        timer = StepTimer(voxels_per_step=self.batch_size * int(np.prod(patch)))

        def bookkeep(state, loss, epoch):
            nonlocal step
            step += 1
            stats = timer.step() or {}
            if step % self.log_every == 0 or step == total_steps:
                self._log({
                    "event": "train", "step": step, "epoch": epoch,
                    "loss": float(loss),
                    "wall_s": round(time.time() - t0, 1),
                    **stats,
                })
            if step % self.val_every == 0:
                self.validate_and_checkpoint(state, eval_step, val_loader,
                                             step)

        if use_dev_cache:
            raw_dev, teacher_dev, fg_dev = self._upload_cache(train_ds)
            samples_per_epoch = steps_per_epoch * self.batch_size
            for epoch in range(self.epochs):
                # The DataLoader's permutation stream, sent once per epoch.
                order = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch])
                ).permutation(len(train_ds))[:samples_per_epoch]
                order = torch.from_numpy(order.astype(np.int64)).to(
                    self.device)
                for lo in range(0, samples_per_epoch, self.batch_size):
                    state, loss = train_step(
                        state, raw_dev, teacher_dev, fg_dev,
                        order[lo:lo + self.batch_size])
                    bookkeep(state, loss, epoch)
        else:
            for epoch in range(self.epochs):
                train_loader.set_epoch(epoch)
                for x, y, fg in prefetch_to_device(train_loader,
                                                   device=self.device):
                    state, loss = train_step(state, x, y, fg)
                    bookkeep(state, loss, epoch)
        if step % self.val_every != 0:
            self.validate_and_checkpoint(state, eval_step, val_loader, step)
        return state

    # ------------------------------------------------------- validation

    def validate(self, state, eval_step, val_loader):
        """Loss, count-space metrics and compression evidence.

        Each batch: the eval step and the metrics + cratio proxy on the
        device, only ``(B,)`` results to the host; exact chunked cratios
        of the first ``exact_cratio_examples`` predictions on the host.
        (The reference's per-example host-oracle path,
        ``val_device_metrics=False``, is not ported; its metrics,
        :func:`exaspim_tpu_torch.ops.metrics.evaluate_example`, are the
        oracle the tests hold these to.)"""
        losses, proxies, exact_cratios = [], [], []
        sums, n_rows, n_seen = {}, 0, 0
        for x, y, _counts, fg in val_loader:
            if (self.max_val_examples is not None
                    and n_seen >= self.max_val_examples):
                break
            x, y, fg = (to_tensor(a, self.device) for a in (x, y, fg))
            loss, pred = eval_step(state, x, y, fg)
            with torch.inference_mode():
                m = evaluate_batch(pred[..., 0], counts_f32(x[..., 0]),
                                   counts_f32(y[..., 0]), fg[..., 0])
                proxy = cratio_proxy_batch(pred[..., 0], chunk=64)
            losses.append(float(loss))
            b = int(pred.shape[0])
            take = b if self.max_val_examples is None else min(
                b, self.max_val_examples - n_seen)
            host = torch.stack([m[k] for k in m]).cpu().numpy()
            for k, v in zip(m, host):
                sums[k] = sums.get(k, 0.0) + float(np.sum(v[:take]))
            n_rows += take
            proxies.extend(proxy[:take].cpu().tolist())
            n_exact = min(take, max(
                0, self.exact_cratio_examples - len(exact_cratios)))
            if n_exact > 0:
                head = pred[:n_exact, ..., 0].cpu().numpy().astype(np.uint16)
                exact_cratios.extend(compute_cratio(v, self.codec)
                                     for v in head)
            n_seen += take
        agg = {k: s / n_rows for k, s in sums.items()} if n_rows else {}
        result = {
            "val_loss": float(np.mean(losses)) if losses else float("nan"),
            "val_cratio": (float(np.median(exact_cratios)) if exact_cratios
                           else 0.0),
            "val_cratio_proxy": (float(np.median(proxies)) if proxies
                                 else 0.0),
            **{f"val_{k}": v for k, v in agg.items()},
        }
        result["val_score"] = checkpoint_score(
            agg, result["val_cratio"], self.checkpoint_weights
        ) if n_rows else float("inf")
        return result

    def validate_and_checkpoint(self, state, eval_step, val_loader, step):
        """Validate, log, and write the scored checkpoint."""
        metrics = self.validate(state, eval_step, val_loader)
        self._log({"event": "val", "step": step, **metrics})
        path = os.path.join(
            self.ckpt_dir, checkpoint_filename(step, metrics["val_score"]))
        save_checkpoint(
            path, state.params, self.model.config, self.transform.cfg,
            step=step, score=metrics["val_score"],
            extra={"metrics": metrics},
        )
        return metrics, path

    # ---------------------------------------------------------- logging

    def _log(self, record):
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")
