"""BM4D teachers: ``ops.bm4d.bm4d_batch`` in ``precompute``'s batches at
the configuration's teacher settings (two stages, the fused matcher),
batch after batch over a pool of noisy patches cut from phantom volumes.

Checked stage by stage, on a sample of the window's batches drawn from the
seed, against the plain reference's BM4D (``reference/bm4d.py``). Stage 2
matches on stage 1's float estimate, where the order of a sum flips ties
of the bf16 distance table and regroups blocks, so the reference follows
the program's state there. After the window the program's stage 1 of the
sampled batch (``bm4d_batch(two_stage=False)``, the timed call's first
stage again) and its matcher's groups on that estimate (``match_topk``)
are read, and:

* ``stage1_rms_rel``: the program's stage 1 against the reference's;
* ``stage2_rms_rel``: the window's teachers against the reference's stage
  2 filtered with the program's stage-1 estimate and groups;
* ``match_excess``: how much farther the program's stage-2 groups lie from
  their reference blocks than the reference's own matching on the same
  estimate finds (the stage the second number skips);
* ``max_counts``: the largest voxel gap of either stage.

The RMS gaps are over the RMS of the reference's own change to the noisy
patch."""

from __future__ import annotations

import torch

from benchmark import generate
from benchmark.reference import bm4d as ref_bm4d


def rms(x):
    return float(x.square().mean().sqrt())


# The control: the reference with TF32 products and an e4m3 distance table, below its float32 and bf16.
CONTROL = "tf32_e4m3"

class Cell:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = ctx.traffic
        self.t = ctx.config["teacher"]
        self.failed_units = 0

    def kw(self):
        t = self.t
        return dict(block=t["block"], group=t["group"], step=t["step"],
                    search=t["search"])

    def run(self, h):
        from exaspim_tpu_torch.ops import _build
        from exaspim_tpu_torch.ops.bm4d import bm4d_batch
        from exaspim_tpu_torch.ops.bm4d_match import match_topk

        ctx, dev = self.ctx, self.ctx.device
        if torch.device(dev).type == "cuda":
            _build.build_all(names=tuple(self.tr["kernels"]))
        h.mark("kernels")
        raw, _, _ = generate.patches(self.tr["inputs"], ctx.seed, dev)
        self.pool = raw.float()
        del raw
        h.mark("inputs")
        b = int(self.t["batch"])
        self.n_batches = len(self.pool) // b
        h.watch("match_topk.launches", lambda: match_topk.launches)
        self.latest = {}

        def one(i):
            j = i % self.n_batches
            with torch.profiler.record_function("bench.bm4d_batch"):
                out = bm4d_batch(self.pool[j * b:(j + 1) * b],
                                 self.t["sigma_bm4d"], two_stage=True,
                                 device=dev, **self.kw())
            self.latest[j] = out
            return out

        for i in range(int(self.tr["warmup_units"])):
            one(i)
        self.latest.clear()
        h.begin_window()
        i = 0
        while True:
            one(i)
            i += 1
            h.unit_done(b)
            if h.over():
                break
        h.end_window()

    def free(self):
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def stages(self, vols, j):
        """Batch ``j``'s stage-1 estimates, stage-2 estimates and stage-2
        groups ``(R, K)`` (linear starts) as judged: the program's, or with
        ``ctx.control == "tf32_e4m3"`` the reference one step below the
        configuration's precisions in the program's place: TF32 matrix
        products for float32, an e4m3 distance table for bf16."""
        t, kw = self.t, self.kw()
        B, K, W, step = t["block"], t["group"], t["search"], t["step"]
        if self.ctx.control == "tf32_e4m3":
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                basic = [ref_bm4d.bm4d(v, t["sigma_bm4d"], **kw)[0]
                         for v in vols]
                groups = [ref_bm4d.match(b1, B, K, W, step,
                                         table=ref_bm4d.e4m3)
                          for b1 in basic]
                final = [ref_bm4d.bm4d(v, t["sigma_bm4d"], **kw, basic=b1,
                                       groups=g)[1]
                         for v, b1, g in zip(vols, basic, groups)]
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            return basic, final, groups
        from exaspim_tpu_torch.ops.bm4d import bm4d_batch
        from exaspim_tpu_torch.ops.bm4d_match import match_topk

        basic = bm4d_batch(vols, t["sigma_bm4d"], two_stage=False,
                           device=self.ctx.device, **kw)
        start = torch.stack(match_topk(basic, block=B, group=K, step=step,
                                       search=W), -1)
        groups = [ref_bm4d.linear(s, v.shape, B) for s, v in zip(start, vols)]
        return basic, self.latest[j], groups

    def check(self):
        ctx = self.ctx
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        b = int(self.t["batch"])
        lim = ctx.limits
        keys = sorted(self.latest)
        picks = generate.draw_indices(ctx.seed, len(keys),
                                      int(self.tr["check"]["sample"]))
        t = self.t
        worst = {"stage1_rms_rel": 0.0, "stage2_rms_rel": 0.0,
                 "match_excess": 0.0, "max_counts": 0.0}
        for p in picks:
            j = keys[p]
            vols = self.pool[j * b:(j + 1) * b]
            for vol, b1, b2, g in zip(vols, *self.stages(vols, j)):
                r1, r2 = ref_bm4d.bm4d(vol, t["sigma_bm4d"], **self.kw(),
                                       basic=b1, groups=g)
                nums = {"stage1_rms_rel": rms(b1 - r1) / rms(r1 - vol),
                        "stage2_rms_rel": rms(b2 - r2) / rms(r2 - vol),
                        "match_excess": ref_bm4d.group_excess(
                            b1, g, t["block"], t["group"], t["search"],
                            t["step"]),
                        "max_counts": float(torch.maximum(
                            (b1 - r1).abs().max(), (b2 - r2).abs().max()))}
                self.failed_units += any(v > lim[k] for k, v in nums.items())
                worst = {k: max(worst[k], v) for k, v in nums.items()}
        return [(k, v, lim[k]) for k, v in worst.items()]
