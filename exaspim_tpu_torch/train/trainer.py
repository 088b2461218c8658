"""Training orchestration: epoch loop, validation, compression-aware
checkpoint selection.

Counterpart of ``exaspim_tpu/train/trainer.py``: step-based validation
cadence, count-space metrics of each validation batch on the device plus
the compressibility proxy (one histogram launch per batch), exact chunked
cratios of the leading examples on the host, the weighted checkpoint score
(lower is better; cratio subtracts), checkpoints named
``BM4DNet-<date>-<step>-<score>.ckpt`` in the JAX package's format, a
``config.json`` run record and a ``log.jsonl`` of events.

Three training loops, as in the reference: the whole uint16 cache
resident on the card with the batch gather inside the step
(``device_cache``); a forced ``device_cache=True`` on a cache above
``device_cache_budget`` rotating contiguous shards of whole batches through
device memory (each shard freed before the next is uploaded, shuffled by
``SeedSequence([seed, epoch, shard])``); or batches streamed through the
loader. The loss is read to the host only when a step is logged (every
``log_every`` steps), so other steps add no host sync.

Every ``full_state_every``-th validation also writes the full train
state (``latest_state.ckpt``), from which ``run(resume_state=)`` continues
a run: params, AdamW moments and the step, in the JAX package's format,
so either package resumes the other's. ``augment=True`` orients each
batch of the card-resident cache by the reference's per-step draw.

Validation writes max-projection PNGs of the first ``keep_mips``
predictions (``session_dir/mips``), and with ``tensorboard`` the scalars
``train_loss``, ``voxels_per_sec`` and every validation metric to
``session_dir/tb`` (``tensorboardX``; where it is missing, the scalars are
skipped with one message on stderr). ``val_device_metrics=False`` scores
each example on the host with
:func:`~exaspim_tpu_torch.ops.metrics.evaluate_example` instead (the
oracle path).

With a ``mesh`` (:func:`~exaspim_tpu_torch.parallel.make_mesh`, one
process per device) training is data-parallel, as the JAX package's
``Trainer(mesh=)``: every rank draws the same global batch stream from
the seed, takes its contiguous share and steps with the gradients
all-reduced to the global mean
(:func:`~exaspim_tpu_torch.parallel.make_dp_train_step`); the parameters
are broadcast from rank 0 at the start and stay equal on every rank.
Batches stream through the loader (``device_cache=True`` with a mesh
raises). Only the primary rank validates and writes checkpoints, logs,
MIPs and TensorBoard scalars. The codec is always built, as the
reference builds it: the exact cratio needs only libzstd (the port's own
blosc1 encoder, :mod:`~exaspim_tpu_torch.compression.blosc1`), so it is
measured on every machine the port runs on. ``exact_cratio_examples=0``
measures none and ``val_cratio`` is 0.0, as the reference reports it
when no example was measured.
"""

from __future__ import annotations

import json
import os
import sys
import time
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

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
    evaluate_example,
)
from exaspim_tpu_torch.ops.metrics_device import evaluate_batch
from exaspim_tpu_torch.train.checkpoint import (
    checkpoint_filename,
    load_checkpoint,
    load_train_state,
    read_train_state,
    save_checkpoint,
    save_train_state,
)
from exaspim_tpu_torch.train.state import (
    create_train_state,
    make_cached_train_step,
    make_eval_step,
    make_train_step,
    pack_fg_bits,
)
from exaspim_tpu_torch.utils.profiling import StepTimer, span

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
                 exact_cratio_examples=16, augment=False,
                 full_state_every=1, log_every=50, keep_mips=10,
                 tensorboard=True, val_device_metrics=True, mesh=None,
                 device="cuda"):
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
        self.codec = best_codec(clevel=clevel)
        self.seed = int(seed)
        self.warmup_steps = int(warmup_steps)
        self.max_val_examples = max_val_examples
        #: "auto": train from a card-resident cache when the dataset
        #: exposes its arrays, fits ``device_cache_budget`` and divides
        #: into whole batches; True forces it (rotating shards when the
        #: cache exceeds the budget); False streams batches.
        self.device_cache = device_cache
        self.device_cache_budget = int(device_cache_budget)
        #: one of the 48 cube orientations per step, drawn from (seed,
        #: step); card-resident cache and cubic patches only.
        self.augment = bool(augment)
        #: write ``latest_state.ckpt`` on every Nth validation.
        self.full_state_every = max(1, int(full_state_every))
        self._n_validations = 0
        self.log_every = int(log_every)
        self.keep_mips = int(keep_mips)
        #: True: each validation batch is scored on the device (metrics +
        #: proxy); False: every example on the host (the oracle path).
        self.val_device_metrics = bool(val_device_metrics)
        self.device = torch.device(device)
        #: a 1-D DeviceMesh: data-parallel training over its ranks.
        self.mesh = mesh
        #: the rank that validates and writes (every rank without a mesh).
        self.primary = mesh is None or dist.get_rank() == 0

        stamp = datetime.now().strftime("%Y%m%d_%H%M")
        self.output_dir = os.fspath(output_dir)
        self.session_dir = os.path.join(self.output_dir, f"session-{stamp}")
        self.ckpt_dir = os.path.join(self.session_dir, "checkpoints")
        self.mip_dir = os.path.join(self.session_dir, "mips")
        if self.primary:
            for d in (self.ckpt_dir, self.mip_dir):
                os.makedirs(d, exist_ok=True)
        self._writer = None
        if tensorboard and self.primary:
            try:
                from tensorboardX import SummaryWriter
            except ImportError as exc:
                print(f"TensorBoard scalars skipped: {exc}", file=sys.stderr,
                      flush=True)
            else:
                self._writer = SummaryWriter(
                    os.path.join(self.session_dir, "tb"))
        self._log_path = os.path.join(self.session_dir, "log.jsonl")
        self._pretrained_params = None
        self._pretrained_transform_cfg = None

    # ------------------------------------------------------------- setup

    def load_pretrained_weights(self, ckpt_path):
        """Stage params from a checkpoint (path or loaded dict); a
        model-config mismatch raises."""
        ckpt = (ckpt_path if isinstance(ckpt_path, dict)
                else load_checkpoint(ckpt_path))
        if not self._same_model(ckpt["model_config"]):
            raise ValueError(
                "checkpoint model_config does not match this model: "
                f"{ckpt['model_config']} vs {self.model.config}"
            )
        self._pretrained_params = ckpt["params"]
        self._pretrained_transform_cfg = ckpt["transform"]

    def _same_model(self, model_config):
        """Whether a checkpoint's model config builds this model (a field
        missing from an older file compares as its default)."""
        from exaspim_tpu_torch.models import build_model

        return build_model(model_config, device="cpu").config \
            == self.model.config

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
        """Merge the run config into ``session_dir/config.json`` (on the
        primary rank)."""
        path = os.path.join(self.session_dir, "config.json")
        if not self.primary:
            return path
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

    def _cache_nbytes(self, ds, resident=True):
        """Bytes of the cache on the device (``resident``: fg bit-packed
        when needed, absent when not) or on the host."""
        raw_b = sum(a.nbytes for a in ds._raw)
        teach_b = sum(a.nbytes for a in ds._teacher)
        fg_b = sum(a.nbytes for a in ds._fg)
        if resident:
            fg_b = -(-fg_b // 8) if self._fg_needed() else 0
        return raw_b + teach_b + fg_b

    def _resolve_device_cache(self, train_ds):
        """How this run trains: 0 streams through the loader, 1 keeps the
        whole cache on the device, S > 1 rotates S contiguous shards.

        ``"auto"`` engages only full residency, when the dataset exposes
        its arrays, holds at least one batch, fits the budget and divides
        into whole batches, and streams otherwise. ``True`` raises where
        it cannot be honoured and shards a cache above the budget (each
        shard a whole number of batches; the budget must hold one)."""
        forced = self.device_cache is True
        if not self.device_cache:
            return 0
        if self.mesh is not None:
            if forced:
                raise ValueError(
                    "device_cache=True is incompatible with mesh "
                    "data-parallel training (the DP step streams sharded "
                    "host batches); use device_cache='auto' or False")
            return 0
        if not all(hasattr(train_ds, f) for f in ("_raw", "_teacher", "_fg")):
            if forced:
                raise ValueError(
                    "device_cache=True requires a cached dataset with "
                    "in-memory (_raw, _teacher, _fg) arrays; a live/"
                    "streaming dataset cannot be device-resident")
            return 0
        n = len(train_ds)
        if n < self.batch_size:
            if forced:
                raise ValueError(
                    f"device_cache=True but the dataset ({n} patches) is "
                    f"smaller than batch_size ({self.batch_size})")
            return 0
        nbytes = self._cache_nbytes(train_ds)
        fits = nbytes <= self.device_cache_budget
        if self.device_cache == "auto":
            return 1 if fits and n % self.batch_size == 0 else 0
        if fits:
            return 1
        row_b = nbytes / n
        batches_per_shard = int(self.device_cache_budget // row_b) \
            // self.batch_size
        if batches_per_shard < 1:
            raise ValueError(
                f"device_cache=True but device_cache_budget "
                f"({self.device_cache_budget} B) cannot hold even one "
                f"batch ({int(row_b) * self.batch_size} B)")
        return -(-(n // self.batch_size) // batches_per_shard)

    # Host staging granularity of the cache upload.
    _UPLOAD_CHUNK_BYTES = 256 << 20

    @staticmethod
    def _row_slices(parts, lo, hi):
        """Contiguous host slices covering global rows [lo, hi) across a
        multi-dir cache's list of memmaps."""
        off = 0
        for p in parts:
            s, e = max(lo - off, 0), min(hi - off, p.shape[0])
            if s < e:
                yield p[s:e]
            off += p.shape[0]

    def _upload_cache(self, ds, lo=0, hi=None):
        """Copy cache rows [lo, hi) of (raw, teacher[, fg]) to the device,
        chunk by chunk from the memmaps into one buffer each: uint16 as
        int16 bits, fg bit-packed when the loss needs it and skipped when
        not. On the card the logged ``wall_s`` is the copy's own: the
        caller has drained the stream, and the copy is waited for."""
        hi = len(ds) if hi is None else hi
        t0 = time.time()

        def up(parts, host_transform=None):
            probe = parts[0][:1]
            if host_transform is not None:
                probe = host_transform(probe)
            probe = to_tensor(probe, "cpu")
            buf = torch.empty((hi - lo, *probe.shape[1:]), dtype=probe.dtype,
                              device=self.device)
            row_bytes = max(1, int(np.prod(parts[0].shape[1:]))
                            * parts[0].dtype.itemsize)
            rows = max(1, self._UPLOAD_CHUNK_BYTES // row_bytes)
            off = 0
            for p in self._row_slices(parts, lo, hi):
                for clo in range(0, p.shape[0], rows):
                    chunk = np.ascontiguousarray(p[clo:clo + rows])
                    if host_transform is not None:
                        chunk = host_transform(chunk)
                    buf[off:off + len(chunk)].copy_(to_tensor(chunk, "cpu"))
                    off += len(chunk)
            return buf

        raw_dev = up(ds._raw)
        teacher_dev = up(ds._teacher)
        fg_dev = up(ds._fg, pack_fg_bits) if self._fg_needed() else None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._log({
            "event": "device_cache_upload",
            "rows": [int(lo), int(hi)],
            "bytes": int((hi - lo) / max(len(ds), 1)
                         * self._cache_nbytes(ds)),
            "fg": "packed" if fg_dev is not None else "skipped",
            "wall_s": round(time.time() - t0, 4),
        })
        return raw_dev, teacher_dev, fg_dev

    # -------------------------------------------------------------- run

    def run(self, train_ds, val_ds, resume_state=None):
        """Full training run; returns the final train state.

        ``resume_state``: a full-state checkpoint (``latest_state.ckpt`` of
        either package) to continue from. Params, optimizer moments and
        the step restore; the run goes on from the epoch that step falls
        in, as the reference does."""
        self.check_transform_cfg()
        train_loader = DataLoader(
            train_ds, self.batch_size,
            make_count_train_collate(self.preserve_foreground),
            shuffle=True, seed=self.seed,
        )
        val_loader = DataLoader(val_ds, self.batch_size,
                                make_count_val_collate())
        n_shards = self._resolve_device_cache(train_ds)
        use_dev_cache = n_shards > 0
        if self.augment and not use_dev_cache:
            raise ValueError(
                "augment=True requires device-cache mode (the orientation "
                "draw runs inside the cached train step); this run resolved "
                "to the streaming loader path")
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
        start_step = 0
        if resume_state:
            tree, meta = read_train_state(resume_state)
            if meta["transform"] != self.transform.cfg:
                raise ValueError(
                    "resume transform cfg mismatch: "
                    f"{meta['transform']} vs {self.transform.cfg}")
            if not self._same_model(meta["model_config"]):
                raise ValueError(
                    "resume model_config mismatch: "
                    f"{meta['model_config']} vs {self.model.config}")
            start_step = load_train_state(state, tree).step
        if self.mesh is not None:
            from exaspim_tpu_torch.parallel.data_parallel import (
                make_dp_train_step,
                replicate_params,
                shard_batch,
            )

            replicate_params(self.mesh, self.model)
            train_step = make_dp_train_step(
                self.mesh, fg_weight=self.fg_weight, eps=self.loss_eps,
                transform=self.transform)
        elif use_dev_cache:
            if self.augment and len(set(patch)) != 1:
                raise ValueError(
                    f"augment=True requires cubic patches, got {patch}")
            train_step = make_cached_train_step(
                self.fg_weight, eps=self.loss_eps, transform=self.transform,
                preserve_foreground=self.preserve_foreground,
                fg_packed=self._fg_needed(), augment=self.augment,
                seed=self.seed, patch_shape=patch,
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
            "device_cache_shards": n_shards,
            "augment": self.augment,
            "device": str(self.device),
        })

        step = start_step
        start_epoch = start_step // max(steps_per_epoch, 1)
        t0 = time.time()
        timer = StepTimer(voxels_per_step=self.batch_size * int(np.prod(patch)))

        def bookkeep(state, loss, epoch):
            nonlocal step
            step += 1
            stats = timer.step() or {}
            if step % self.log_every == 0 or step == total_steps:
                with span("trainer.log"):
                    self._scalar("train_loss", float(loss), step)
                    if "voxels_per_sec" in stats:
                        self._scalar("voxels_per_sec",
                                     stats["voxels_per_sec"], step)
                    self._log({
                        "event": "train", "step": step, "epoch": epoch,
                        "loss": float(loss),
                        "wall_s": round(time.time() - t0, 1),
                        **stats,
                    })
            if step % self.val_every == 0 and self.primary:
                with span("trainer.validate"):
                    self.validate_and_checkpoint(state, eval_step,
                                                 val_loader, step)

        samples_per_epoch = steps_per_epoch * self.batch_size
        if n_shards == 1:
            raw_dev, teacher_dev, fg_dev = self._upload_cache(train_ds)
            for epoch in range(start_epoch, self.epochs):
                # The DataLoader's permutation stream, sent once per epoch.
                order = np.random.default_rng(
                    np.random.SeedSequence([self.seed, epoch])
                ).permutation(len(train_ds))[:samples_per_epoch]
                order = torch.from_numpy(order.astype(np.int64)).to(
                    self.device)
                for lo in range(0, samples_per_epoch, self.batch_size):
                    with span("trainer.step"):
                        state, loss = train_step(
                            state, raw_dev, teacher_dev, fg_dev,
                            order[lo:lo + self.batch_size])
                    bookkeep(state, loss, epoch)
        elif use_dev_cache:
            # Shard rotation: each epoch walks S contiguous shards of whole
            # batches, one on the device at a time, each shuffled on its
            # own (SeedSequence([seed, epoch, s])); every epoch still visits
            # every patch.
            shard_rows = -(-steps_per_epoch // n_shards) * self.batch_size
            for epoch in range(start_epoch, self.epochs):
                for s in range(n_shards):
                    row_lo = s * shard_rows
                    row_hi = min(samples_per_epoch, row_lo + shard_rows)
                    if row_lo >= row_hi:
                        break
                    raw_dev, teacher_dev, fg_dev = self._upload_cache(
                        train_ds, row_lo, row_hi)
                    order = np.random.default_rng(
                        np.random.SeedSequence([self.seed, epoch, s])
                    ).permutation(row_hi - row_lo)
                    order = torch.from_numpy(order.astype(np.int64)).to(
                        self.device)
                    for lo in range(0, len(order), self.batch_size):
                        with span("trainer.step"):
                            state, loss = train_step(
                                state, raw_dev, teacher_dev, fg_dev,
                                order[lo:lo + self.batch_size])
                        bookkeep(state, loss, epoch)
                    # The freed shard goes back to the caching allocator,
                    # which reuses it for the next one in stream order.
                    # Draining the stream first keeps the next upload's
                    # logged time the copy's own.
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    del raw_dev, teacher_dev, fg_dev, order
        else:
            for epoch in range(start_epoch, self.epochs):
                train_loader.set_epoch(epoch)
                batches = train_loader
                if self.mesh is not None:  # this rank's share of each batch
                    batches = (shard_batch(self.mesh, b)
                               for b in train_loader)
                for x, y, fg in prefetch_to_device(batches,
                                                   device=self.device):
                    with span("trainer.step"):
                        state, loss = train_step(state, x, y, fg)
                    bookkeep(state, loss, epoch)
        if step % self.val_every != 0 and self.primary:
            with span("trainer.validate"):
                self.validate_and_checkpoint(state, eval_step, val_loader,
                                             step)
        if self._writer is not None:
            self._writer.flush()
        return state

    # ------------------------------------------------------- validation

    def validate(self, state, eval_step, val_loader, step):
        """Loss, count-space metrics and compression evidence; MIPs of the
        first ``keep_mips`` predictions are written for ``step``.

        Each batch: the eval step and the metrics + cratio proxy on the
        device, only ``(B,)`` results to the host; exact chunked cratios
        of the first ``exact_cratio_examples`` predictions on the host.
        With ``val_device_metrics=False``, :meth:`_validate_host`."""
        if not self.val_device_metrics:
            return self._validate_host(state, eval_step, val_loader, step)
        losses, proxies, exact_cratios = [], [], []
        sums, n_rows, n_seen, n_mips = {}, 0, 0, 0
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
            # Bounded host pulls: exact ratios and MIPs of the leading
            # examples only.
            n_exact = min(take, max(
                0, self.exact_cratio_examples - len(exact_cratios)))
            n_pull = max(n_exact, min(take, self.keep_mips - n_mips))
            if n_pull > 0:
                head = pred[:n_pull, ..., 0].cpu().numpy().astype(np.uint16)
                for i in range(n_pull):
                    if i < n_exact:
                        exact_cratios.append(
                            compute_cratio(head[i], self.codec))
                    if n_mips < self.keep_mips:
                        self._save_mip(head[i], step, n_mips)
                        n_mips += 1
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

    def _validate_host(self, state, eval_step, val_loader, step):
        """Per-example host-oracle validation: every prediction comes to
        the host and is scored by
        :func:`~exaspim_tpu_torch.ops.metrics.evaluate_example`, with its
        exact cratio."""
        losses, cratios, rows = [], [], []
        n_seen = n_mips = 0
        for x, y, counts, fg in val_loader:
            if (self.max_val_examples is not None
                    and n_seen >= self.max_val_examples):
                break
            loss, pred = eval_step(
                state, *(to_tensor(a, self.device) for a in (x, y, fg)))
            losses.append(float(loss))
            # The eval step inverse-maps on the device: pred is counts.
            pred = pred[..., 0].cpu().numpy().astype(np.uint16)
            y_np = np.asarray(y)[..., 0]
            fg_np = np.asarray(fg)[..., 0].astype(bool)
            for i in range(pred.shape[0]):
                if (self.max_val_examples is not None
                        and n_seen >= self.max_val_examples):
                    break
                cratios.append(compute_cratio(pred[i], self.codec))
                rows.append(evaluate_example(
                    pred[i], np.asarray(counts[i]), y_np[i], fg_np[i]))
                if n_mips < self.keep_mips:
                    self._save_mip(pred[i], step, n_mips)
                    n_mips += 1
                n_seen += 1
        agg = {k: float(np.mean([r[k] for r in rows]))
               for k in rows[0]} if rows else {}
        result = {
            "val_loss": float(np.mean(losses)) if losses else float("nan"),
            "val_cratio": float(np.median(cratios)) if cratios else 0.0,
            **{f"val_{k}": v for k, v in agg.items()},
        }
        result["val_score"] = checkpoint_score(
            agg, result["val_cratio"], self.checkpoint_weights
        ) if rows else float("inf")
        return result

    def validate_and_checkpoint(self, state, eval_step, val_loader, step):
        """Validate, log (and write the scalars), and write the scored
        checkpoint (and, every ``full_state_every``-th time,
        ``latest_state.ckpt``)."""
        metrics = self.validate(state, eval_step, val_loader, step)
        for k, v in metrics.items():
            self._scalar(k, v, step)
        self._log({"event": "val", "step": step, **metrics})
        path = os.path.join(
            self.ckpt_dir, checkpoint_filename(step, metrics["val_score"]))
        save_checkpoint(
            path, state.params, self.model.config, self.transform.cfg,
            step=step, score=metrics["val_score"],
            extra={"metrics": metrics},
        )
        self._n_validations += 1
        if self._n_validations % self.full_state_every == 0:
            save_train_state(
                os.path.join(self.ckpt_dir, "latest_state.ckpt"), state,
                self.model.config, self.transform.cfg)
        return metrics, path

    # ---------------------------------------------------------- logging

    def _scalar(self, tag, value, step):
        if self._writer is not None:
            self._writer.add_scalar(tag, value, step)

    def _log(self, record):
        if not self.primary:
            return
        with open(self._log_path, "a") as f:
            f.write(json.dumps(record, default=float) + "\n")

    def _save_mip(self, counts, step, index):
        """Write the z max-projection of a prediction as an 8-bit PNG
        (scaled to its maximum) into ``mip_dir``; a failure is logged,
        not raised."""
        try:
            from PIL import Image

            mip = counts.max(axis=0).astype(np.float32)
            hi = max(float(mip.max()), 1.0)
            img = (255 * mip / hi).astype(np.uint8)
            Image.fromarray(img).save(os.path.join(
                self.mip_dir, f"step{step:07d}_ex{index}.png"))
        except Exception as exc:
            self._log({"event": "mip_failed", "step": step,
                       "error": repr(exc)})
