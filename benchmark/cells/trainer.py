"""Training through the trainer: ``train.trainer.Trainer.run`` on a patch
cache held in host memory, as the page cache holds a production cache,
with the loop the trainer resolves to (``device_cache`` of the traffic:
``false`` streams batches through its ``DataLoader`` and
``prefetch_to_device``, what ``"auto"`` resolves to for a production cache
over the device budget).

``Trainer.run`` is one call that runs set-up and the window. This entry
sees each step through an optimizer step hook: steps 1-3 are read for the
check, the window opens at the end of warm-up step ``warmup_units`` and
closes at the first step that ends past the deadline, whose hook stops
the run. The same trainer, model and optimizer serve the check's steps
and the window.

The run fine-tunes the configuration's checkpoint, which the trainer
loads (``load_pretrained_weights``) and the reference reads with its own
reader, or trains from weights the benchmark draws from the seed
(``weights.py``), handed to both. Checked against the plain reference's
three steps on the same weights and rows (``reference/train.py`` with the
model's reference from ``references.py``): step 1's loss, the
median leaf's first gradient (from AdamW's first moment after step 1) and
the median leaf's change over three steps.

On several ranks (``ctx.world``, one card each) the trainer runs
data-parallel through the program's own path (``initialize_multihost``,
``make_mesh``, ``Trainer(mesh=)``: every rank draws the same global batch
of ``batch_size`` rows and steps on its contiguous share, the gradients
all-reduced). Each rank makes its ``count / world`` patches from its own
seed and the ranks gather them in rank order, so every rank holds the one
global cache. Rank 0 is checked, against the reference's steps on the
whole global batch; the window's stop is agreed across ranks by the
harness.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from benchmark import generate, references, weights
from benchmark.reference import msgpack_read, unet
from benchmark.reference import train as ref_train


class _WindowClosed(Exception):
    pass


def port_to_flax_name(name):
    return name.replace(".", "/")


def host_dataset(raw, teacher, fg, transform_cfg):
    """The program's cached dataset over arrays held in memory."""
    from exaspim_tpu_torch.data.cache import CachedPatchDataset

    class HotCache(CachedPatchDataset):
        def __init__(self):
            self.cache_dirs = []
            self.transform_cfg = transform_cfg
            self._raw, self._teacher, self._fg = [raw], [teacher], [fg]
            self._cumlen = np.cumsum([len(raw)])
            self.patch_shape = tuple(raw.shape[1:])

    return HotCache()


def _gather_rows(t, world):
    """Every rank's ``t`` (equal shapes), concatenated along dim 0 in rank
    order, on every rank."""
    import torch.distributed as dist

    out = torch.empty((world * t.shape[0], *t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    if t.is_cuda:
        dist.all_gather_into_tensor(out, t.contiguous())
    else:
        dist.all_gather(list(out.chunk(world)), t.contiguous())
    return out


def _bits(t):
    """Counts 0..65535 (an int32 tensor) as their int16 bits: a gather
    moves two bytes a voxel."""
    return torch.where(t >= 32768, t - 65536, t).to(torch.int16)


def global_patches(inputs, seed, device, world):
    """``(raw, clean, fg)`` host arrays (uint16, uint16, bool) of the
    traffic's ``inputs``: made whole from the seed on one rank; on
    ``world`` ranks each makes its ``count / world`` patches from
    ``volumes / world`` blocks with a seed of its own, and the ranks
    gather them in rank order."""
    if world == 1:
        raw, clean, fg = generate.patches(inputs, seed, device)
        return (raw.cpu().numpy().astype(np.uint16),
                clean.cpu().numpy().astype(np.uint16), fg.cpu().numpy())
    import torch.distributed as dist

    share = dict(inputs, count=int(inputs["count"]) // world,
                 volumes=int(inputs["volumes"]) // world)
    raw, clean, fg = generate.patches(
        share, generate.sub_seed(seed, dist.get_rank()), device)
    # int16 pairs travel as int32: neither NCCL nor gloo moves int16.
    out = [_gather_rows(_bits(t).view(torch.int32), world).cpu().numpy()
           .view(np.uint16) for t in (raw, clean)]
    out.append(_gather_rows(fg.to(torch.uint8), world).cpu().numpy()
               .astype(bool))
    return tuple(out)


# The control: the reference in float8, the precision below the configuration's bf16.
CONTROL = "fp8"

class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic

    def run(self, h):
        from exaspim_tpu_torch.models import build_model
        from exaspim_tpu_torch.ops import _build
        from exaspim_tpu_torch.ops.nb_conv import nb_conv3d, nb_conv3d_dw
        from exaspim_tpu_torch.train.trainer import Trainer
        from exaspim_tpu_torch.transforms import build_transform
        from torch.optim.optimizer import register_optimizer_step_post_hook

        ctx, dev, tr = self.ctx, self.ctx.device, self.tr
        cuda = torch.device(dev).type == "cuda"
        mesh = None
        if ctx.world > 1:
            from exaspim_tpu_torch.parallel import (
                initialize_multihost,
                make_mesh,
            )

            initialize_multihost(device=dev)
            mesh = make_mesh(axis="data", device=dev)
        if cuda:
            _build.build_all(names=tuple(tr["kernels"]))
        h.mark("kernels")
        self.raw, self.teacher, fg = global_patches(tr["inputs"], ctx.seed,
                                                    dev, ctx.world)
        h.mark("inputs")
        mc = ctx.config["model_config"]
        dtype = getattr(torch, ctx.config["dtype"]) if cuda else torch.float32
        transform = build_transform(ctx.config["transform"])
        self.model = build_model(mc, dtype=dtype, device=dev)
        t = ctx.config["training"]
        self.out_dir = tempfile.mkdtemp(prefix="bench-trainer-")
        trainer = Trainer(
            self.out_dir, self.model, transform, lr=t["lr"],
            weight_decay=t["weight_decay"], epochs=int(tr["epochs"]),
            batch_size=int(tr["batch_size"]), fg_weight=t["fg_weight"],
            loss_eps=t["loss_eps"], seed=ctx.seed,
            device_cache=tr["device_cache"], val_every=int(tr["val_every"]),
            exact_cratio_examples=0, tensorboard=False, log_every=1,
            mesh=mesh, device=dev)
        if weights.from_seed(ctx.config):
            self.seeded = weights.seeded(self.model, ctx.seed, dev)
            trainer.load_pretrained_weights({
                "model_config": mc, "transform": transform.cfg,
                "params": weights.as_tree(self.seeded)})
        else:
            trainer.load_pretrained_weights(
                os.path.join(ctx.root, ctx.config["weights"]))
        h.mark("trainer")
        self.datasets = ds, val = (
            host_dataset(self.raw, self.teacher, fg, transform.cfg),
            host_dataset(self.raw[:tr["batch_size"]],
                         self.teacher[:tr["batch_size"]],
                         fg[:tr["batch_size"]], transform.cfg))
        self.steps_per_epoch = len(ds) // int(tr["batch_size"])
        self.losses = []
        log = trainer._log

        def log_loss(record):
            if record.get("event") == "train":
                self.losses.append(record["loss"])
            return log(record)

        trainer._log = log_loss
        names = [port_to_flax_name(n) for n, _ in
                 self.model.named_parameters()]
        size = int(tr["batch_size"]) * int(np.prod(ds.patch_shape))
        warm = int(tr["warmup_units"])
        h.watch("nb_conv3d.launches", lambda: nb_conv3d.launches)
        h.watch("nb_conv3d_dw.launches", lambda: nb_conv3d_dw.launches)
        count = [0]

        def hook(opt, args, kwargs):
            count[0] += 1
            n = count[0]
            params = [p for g in opt.param_groups for p in g["params"]]
            if n == 1:
                h.mark("step 1")
            if n == 1 and ctx.rank == 0:
                b1 = opt.param_groups[0]["betas"][0]
                self.g1 = {k: opt.state[p]["exp_avg"].detach().float()
                           / (1 - b1) for k, p in zip(names, params)}
            if n == 3 and ctx.rank == 0:
                self.theta3 = {k: p.detach().float().clone()
                               for k, p in zip(names, params)}
            if n == 4:  # steps 1-3 logged their losses
                trainer.log_every = int(tr["log_every"])
            if n == warm:
                h.begin_window()
            elif n > warm:
                h.step_mark()
                h.unit_done(size)
                if h.over():
                    h.end_window()
                    raise _WindowClosed

        handle = register_optimizer_step_post_hook(hook)
        try:
            trainer.run(ds, val)
        except _WindowClosed:
            pass
        finally:
            handle.remove()
        if h.window_s is None:
            raise RuntimeError("the trainer's epochs ended before the window")
        self.trainer = trainer

    def free(self):
        del self.model, self.trainer
        # The loader's producer thread, blocked on its full queue once the
        # window stopped the run, keeps its dataset: let go of the arrays
        # (the check's copies stay with this entry), so that a process
        # running several seeds holds one cache, not one a run.
        for d in self.datasets:
            d._raw, d._teacher, d._fg = [], [], []
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        shutil.rmtree(self.out_dir, ignore_errors=True)

    def initial_params(self):
        """The reference's flat float32 parameters before step 1: the
        checkpoint read by the reference's own reader, or the seed's draw
        (the benchmark's own tensors, which the trainer copied)."""
        ctx, dev = self.ctx, self.ctx.device
        if weights.from_seed(ctx.config):
            flat = weights.flat_names(self.seeded)
        else:
            tree, _ = msgpack_read.read_checkpoint(
                os.path.join(ctx.root, ctx.config["weights"]))
            flat = unet.flatten(tree)
        return {k: ref_train.f32(v, dev) for k, v in flat.items()}

    def reference(self, theta0, quant=None, half=False):
        """The reference's readings of steps 1-3 from ``theta0`` on the
        same rows: the trainer's epoch-0 permutation (``SeedSequence([seed,
        0])``), batch ``k`` its rows ``k·B … (k+1)·B − 1`` of the global
        batch ``B`` (the ranks' shares in rank order). ``quant`` and
        ``half`` read the control and a fault in the program's place."""
        ctx, dev, tr = self.ctx, self.ctx.device, self.tr
        t = ctx.config["training"]
        mc = ctx.config["model_config"]
        model = references.reference_model(mc, ctx.bench_dir)
        T = unet.transform(ctx.config["transform"])
        params = ref_train.to_params(theta0, dev)
        opt = ref_train.AdamW(params, tuple(t["betas"]), t["eps"],
                              t["weight_decay"])
        order = np.random.default_rng(
            np.random.SeedSequence([ctx.seed, 0])).permutation(len(self.raw))
        b = int(tr["batch_size"])
        total = int(tr["epochs"]) * self.steps_per_epoch
        losses, g1 = [], None
        for k in range(3):
            rows = order[k * b:(k + 1) * b]
            if half:  # the fault: half the batch, the mean over the rest
                rows = rows[:b // 2]
            x = T.forward(torch.from_numpy(
                self.raw[rows].astype(np.float32)).to(dev))[:, None]
            y = T.forward(torch.from_numpy(
                self.teacher[rows].astype(np.float32)).to(dev))[:, None]
            loss, grads = ref_train.supervised_grads(
                model, params, mc, x, y, t["loss_eps"],
                int(tr["check"]["reference_chunk"]), quant)
            losses.append(loss)
            if k == 0:
                g1 = grads
            opt.step(grads, ref_train.cosine_lr(t["lr"], k, total))
        return {"losses": losses, "g1": g1,
                "theta3": {k: p.detach() for k, p in params.items()}}

    def check(self):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        theta0 = self.initial_params()
        ref = self.reference(theta0)
        if self.ctx.control == "fp8":
            prog = self.reference(theta0, unet.Fp8)
        elif self.ctx.control == "half_batch":
            prog = self.reference(theta0, half=True)
        elif self.ctx.control == "bf16":
            prog = self.reference(theta0, unet.Bf16)
        else:
            prog = {"losses": self.losses[:3], "g1": self.g1,
                    "theta3": self.theta3}
        # The program keeps 3³ taps as (27, Cin, Cout) and the head as
        # (Cin, 1): the Flax leaves' numbers in the same order.
        prog["theta3"] = {k: v.reshape(theta0[k].shape)
                          for k, v in prog["theta3"].items()}
        nums, detail = ref_train.compare(prog, ref, theta0, theta0)
        print(f"check detail {json.dumps(detail)}", file=sys.stderr)
        lim = self.ctx.limits
        return [(k, v, lim[k]) for k, v in nums.items()]
