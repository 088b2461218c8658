"""The plain reference of a training step: the float32 model's loss and
gradients by autograd, and AdamW as its paper and ``torch.optim`` state
it (decoupled weight decay ``θ ← θ(1 − lr·wd)``, bias-corrected moments,
``ε`` added to the corrected root), at the cosine schedule's rate
``lr · ½(1 + cos(π·t/T))`` of step ``t``.

The batch is taken in chunks of rows, so that the float32 activations fit
beside nothing else; the loss is the batch mean either way.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def charbonnier(d, eps):
    return torch.sqrt(d * d + eps * eps)


def cosine_lr(lr, t, total):
    t = min(float(t), float(total))
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / total))


def f32(v, device):
    """A leaf (array or tensor) as a float32 tensor of its own on
    ``device``."""
    if not torch.is_tensor(v):
        v = torch.from_numpy(np.asarray(v, np.float32))
    return v.to(device, torch.float32, copy=True)


def to_params(flat, device):
    """Float32 leaves of the flat ``{name: leaf}`` that need their
    gradients."""
    return {k: f32(v, device).requires_grad_(True) for k, v in flat.items()}


def supervised_grads(model, params, model_cfg, x, y, eps, chunk,
                     quant=None):
    """Mean Charbonnier loss of ``model.forward`` (the configuration's
    reference module) on ``x`` against ``y`` (both ``(B, 1, D, H, W)``)
    and its gradients."""
    for p in params.values():
        p.grad = None
    b = x.shape[0]
    total = 0.0
    for i in range(0, b, chunk):
        pred = model.forward(params, x[i:i + chunk], model_cfg, quant)
        loss = charbonnier(pred - y[i:i + chunk], eps).mean() \
            * (pred.shape[0] / b)
        loss.backward()
        total += float(loss.detach())
    return total, {k: p.grad.detach().clone() for k, p in params.items()}


class AdamW:
    def __init__(self, params, betas, eps, weight_decay):
        self.params = params
        self.b1, self.b2 = betas
        self.eps, self.wd = eps, weight_decay
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads, lr):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k] / c2).sqrt_().add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)


def compare(prog, ref, theta0_prog, theta0_ref, floor=1e-3):
    """The step check's numbers, from the program's and the reference's
    readings: ``prog`` and ``ref`` hold ``losses`` (steps 1-3), ``g1``
    (leaf → the first gradient as the optimizer got it) and ``theta3``
    (leaf → parameters after three steps).

    * ``loss1_gap``: the relative gap of step 1's loss (steps 2 and 3 are
      reported, not compared: Adam's first updates are sign-like, so a
      last-bit difference in a gradient element near zero moves its
      parameter by a whole ``lr``, and their losses scatter even between
      two float32 runs);
    * ``grad_gap_median``: over the leaves, the median of the gap between
      the two first-gradient norms over the larger of the reference's
      norm of that leaf and of the median leaf (the worst leaf is
      reported, not compared: one small leaf's gap scatters by seed);
    * ``change_gap_median``: over the leaves, the median of the gap
      between the two norms of the parameters' change over three steps,
      over the larger of the reference's change of that leaf and of the
      median leaf, leaving out leaves whose reference gradient is under
      ``floor`` of the median leaf's (they move by round-off alone); the
      worst leaf is reported, not compared: where a leaf's gradient
      elements sit near zero, rounding flips the sign of Adam's first
      updates and moves the leaf by whole ``lr`` steps, so its gap
      scatters by seed. A step that leaves the state unchanged reads 1.

    Returns the three numbers and, for the record, the rest.
    """
    loss_gaps = [abs(a - b) / abs(b)
                 for a, b in zip(prog["losses"], ref["losses"])]
    gref = {k: float(v.norm()) for k, v in ref["g1"].items()}
    gmed = float(np.median(list(gref.values())))
    ggap = {k: abs(float(prog["g1"][k].norm()) - gref[k]) / max(gref[k], gmed)
            for k in gref}
    dref = {k: float((ref["theta3"][k] - theta0_ref[k]).norm())
            for k in gref}
    dprog = {k: float((prog["theta3"][k].float() - theta0_prog[k]).norm())
             for k in gref}
    moved = [k for k in gref if gref[k] >= floor * gmed]
    dmed = float(np.median([dref[k] for k in moved]))
    cgap = {k: abs(dprog[k] - dref[k]) / max(dref[k], dmed) for k in moved}
    worst_g, worst_c = max(ggap, key=ggap.get), max(cgap, key=cgap.get)
    top = sorted(ggap, key=ggap.get, reverse=True)[:5]
    detail = {"loss_gaps": loss_gaps,
              "grad_gap_worst": [worst_g, ggap[worst_g]],
              "grad_gap_top": [[k, ggap[k], gref[k] / gmed] for k in top],
              "change_gap_worst": [worst_c, cgap[worst_c]],
              "leaves_left_out": sorted(set(gref) - set(moved))}
    return {"loss1_gap": loss_gaps[0],
            "grad_gap_median": float(np.median(list(ggap.values()))),
            "change_gap_median": float(np.median(list(cgap.values())))}, \
        detail
