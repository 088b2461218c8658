"""Whole-volume denoising: ``pipeline.denoise_volume``, ndarray in and
ndarray out, volumes back to back (a closed loop: the next starts when the
last is handed back), with the configuration's checkpoint or weights
drawn from the seed (``weights.py``).

Checked: a sample of the window's output volumes, drawn from the seed,
against the plain reference's tiled denoising of the same input
(``reference/tiled.py`` with the model's reference from
``references.py``): the RMS error over the reference's standard
deviation, and the largest error in counts."""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import generate, references, weights
from benchmark.reference import msgpack_read, tiled, unet


def dtype_of(name, device):
    # The plain versions of the kernels, on the CPU (tests only), run f32.
    if torch.device(device).type != "cuda":
        return torch.float32
    return getattr(torch, name)


# The control: the reference in float8, the precision below the configuration's bf16.
CONTROL = "fp8"

class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.kw = dict(self.tr["denoise"])
        self.failed_units = 0

    def run(self, h):
        from exaspim_tpu_torch.ops import _build
        from exaspim_tpu_torch.ops.nb_conv import nb_conv3d
        from exaspim_tpu_torch.pipeline import denoise_volume

        ctx, dev = self.ctx, self.ctx.device
        if torch.device(dev).type == "cuda":
            _build.build_all(names=tuple(self.tr["kernels"]))
        h.mark("kernels")
        self.model, self.transform = self.load_model()
        h.mark("model")
        self.inputs = generate.volumes(self.tr["inputs"], ctx.seed, dev)
        h.mark("inputs")
        h.watch("nb_conv3d.launches", lambda: nb_conv3d.launches)

        def one(i):
            with torch.profiler.record_function("bench.denoise_volume"):
                return denoise_volume(self.inputs[i % len(self.inputs)],
                                      self.model, self.transform,
                                      device=dev, **self.kw)

        for i in range(int(self.tr["warmup_units"])):
            one(i)
        h.begin_window()
        self.outputs = []
        while True:
            out = one(len(self.outputs))
            self.outputs.append(out)
            h.unit_done(out.size)
            if h.over():
                break
        h.end_window()

    def load_model(self):
        """The program's ``(model, transform)``: restored from the
        checkpoint, or built from the configuration and loaded with
        weights drawn from the seed (kept for the reference)."""
        from exaspim_tpu_torch.models import build_model
        from exaspim_tpu_torch.train.checkpoint import restore_pipeline
        from exaspim_tpu_torch.transforms import build_transform

        ctx, dev = self.ctx, self.ctx.device
        dtype = dtype_of(ctx.config["dtype"], dev)
        if not weights.from_seed(ctx.config):
            return restore_pipeline(
                os.path.join(ctx.root, ctx.config["weights"]), dtype=dtype,
                device=dev)
        model = build_model(ctx.config["model_config"], dtype=dtype,
                            device=dev)
        self.seeded = weights.seeded(model, ctx.seed, dev)
        model.load_state_dict(self.seeded)
        return model, build_transform(ctx.config["transform"])

    def reference_params(self):
        """The reference's flat float32 parameters: the checkpoint read
        by the reference's own reader, or the seed's draw."""
        ctx, dev = self.ctx, self.ctx.device
        if weights.from_seed(ctx.config):
            return {k: v.float() for k, v in
                    weights.flat_names(self.seeded).items()}
        tree, _ = msgpack_read.read_checkpoint(
            os.path.join(ctx.root, ctx.config["weights"]))
        return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
                for k, v in unet.flatten(tree).items()}

    def free(self):
        del self.model, self.transform
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def candidates(self, picks, ref):
        """The outputs judged: the program's, or with ``ctx.control`` the
        reference itself in the control's lower precision (``"fp8"``) or
        in the configuration's bf16 (``"bf16"``, a witness)."""
        if not self.ctx.control:
            return [self.outputs[i] for i in picks]
        quant = unet.Bf16 if self.ctx.control == "bf16" else unet.Fp8
        return [ref(i, quant) for i in picks]

    def check(self):
        ctx, dev = self.ctx, self.ctx.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        params = self.reference_params()
        model = references.reference_model(ctx.config["model_config"],
                                         ctx.bench_dir)
        c = self.tr["check"]
        kw = self.kw
        cache = {}

        def ref(i, quant=None):
            j = i % len(self.inputs)
            if quant is None and j in cache:
                return cache[j]
            out = tiled.denoise(model, params, ctx.config["model_config"],
                                ctx.config["transform"], self.inputs[j],
                                kw["patch_size"], kw["overlap"], kw["trim"],
                                int(c["reference_batch"]), dev, quant)
            if quant is None:
                cache[j] = out
            return out.cpu().numpy() if quant is not None else out

        picks = generate.draw_indices(ctx.seed, len(self.outputs),
                                      int(c["sample"]))
        rms_rel, err_max = 0.0, 0.0
        for i, cand in zip(picks, self.candidates(picks, ref)):
            r = ref(i)
            d = torch.from_numpy(cand.astype(np.float32)).to(dev) - r
            rms = float(d.square().mean().sqrt() / r.std())
            worst = float(d.abs().max())
            ok = (rms <= ctx.limits["err_rms_rel"]
                  and worst <= ctx.limits["err_max_counts"])
            self.failed_units += not ok
            rms_rel, err_max = max(rms_rel, rms), max(err_max, worst)
            del d
        return [("err_rms_rel", rms_rel, ctx.limits["err_rms_rel"]),
                ("err_max_counts", err_max, ctx.limits["err_max_counts"])]
