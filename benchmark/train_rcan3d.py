"""The checkpoint of the configuration ``rcan3d-c32``
(``checkpoints/rcan3d-c32.msgpack``), trained by the plain reference
alone: :func:`benchmark.reference.rcan3d.forward` with ``torch`` autograd
in float32, on phantom pairs from :mod:`benchmark.generate` (the noisy
counts in, the clean phantom rounded to counts as the target). The weights
the cell checks so owe nothing to the program's kernels, model or
trainer; only the file is the program's format, written with its
``save_checkpoint`` so that ``restore_pipeline`` reads it.

The recipe (the constants below; the sizes and the seed are options, so
that a test can run it small):

* the model: 3D-RCAN at the configuration's ``model_config``, Keras's
  initialisers as the source builds its layers (Glorot-uniform kernels,
  fan-in and fan-out ``27·C`` of a 3³ conv and ``C`` of a 1×1 map; zero
  biases), drawn from ``--seed``;
* the data: ``--patches`` patches of ``--patch``³ cut at seeded positions
  from phantom blocks of ``--block``³, ``PER_BLOCK`` a block
  (``generate.patches``: the denoise traffic's tubes, PSF and noise,
  ``TUBES`` a block), drawn once from ``--seed``; each step takes
  ``--batch`` of them at random;
* the loss: Charbonnier (``EPS``) between the output and the target in
  the transform domain (asinh 100/60), each voxel weighted
  ``1 + FG_WEIGHT`` inside a tube and 1 elsewhere, over the batch's
  mean weight: the transform flattens the bright tubes, so an unweighted
  loss learns the background and blurs the tubes below the noisy input's
  fidelity;
* AdamW of ``reference/train.py`` (β 0.9 / 0.999, ε 1e-8, ``WD``), the
  rate rising linearly over ``WARMUP`` steps to ``LR`` then falling on a
  cosine to 0 at ``--steps``, the gradients clipped to a global norm of
  ``CLIP``;
* on the card the convs run in TF32 (``allow_tf32``), the rest float32.

Usage, on one card (``--device cuda``), about ten minutes::

    python3 -m benchmark.train_rcan3d \\
        --out checkpoints/rcan3d-c32.msgpack
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from benchmark import generate
from benchmark.reference import rcan3d, train, unet

HERE = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(HERE, "configs", "rcan3d-c32.json")
TRAFFIC = os.path.join(HERE, "traffic", "denoise-512.json")
PER_BLOCK, TUBES = 32, 6
EPS, FG_WEIGHT = 1e-3, 20.0
LR, WARMUP, WD, CLIP = 3e-4, 100, 1e-4, 1.0
LOG_EVERY = 100


def shapes(model_cfg):
    """``{name: shape}`` of the parameters, in the checkpoint's layout: 3³
    kernels ``(3, 3, 3, Cin, Cout)``, 1×1 maps ``(1, 1, 1, Cin, Cout)``."""
    c = int(model_cfg.get("num_channels", 32))
    r = c // int(model_cfg.get("channel_reduction", 8))
    out = {}

    def conv(name, cin, cout, k=3):
        out[f"{name}/kernel"] = (k, k, k, cin, cout)
        out[f"{name}/bias"] = (cout,)

    conv("Conv_0", 1, c)
    for i in range(int(model_cfg.get("num_residual_groups", 5))):
        for j in range(int(model_cfg.get("num_residual_blocks", 3))):
            blk = f"ResidualGroup_{i}/RCAB_{j}"
            conv(f"{blk}/Conv_0", c, c)
            conv(f"{blk}/Conv_1", c, c)
            conv(f"{blk}/ChannelAttention_0/Conv_0", c, r, 1)
            conv(f"{blk}/ChannelAttention_0/Conv_1", r, c, 1)
        conv(f"ResidualGroup_{i}/Conv_0", c, c)
    conv("Conv_1", c, c)
    conv("Conv_2", c, 1)
    return out


def init(model_cfg, seed):
    """Keras's initialisers from ``seed``: float32 tensors on the CPU."""
    gen = torch.Generator().manual_seed(int(seed))
    params = {}
    for name, shape in shapes(model_cfg).items():
        if name.endswith("kernel"):
            taps = shape[0] * shape[1] * shape[2]
            lim = math.sqrt(6.0 / (taps * (shape[3] + shape[4])))
            params[name] = torch.empty(shape).uniform_(-lim, lim,
                                                       generator=gen)
        else:
            params[name] = torch.zeros(shape)
    return params


def as_tree(params):
    """The nested ``{module: {leaf: numpy}}`` tree of a checkpoint."""
    tree = {}
    for name, v in params.items():
        *path, leaf = name.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v.detach().cpu().numpy().astype(np.float32)
    return tree


def rate(t, steps):
    if t < WARMUP:
        return LR * (t + 1) / WARMUP
    return train.cosine_lr(LR, t - WARMUP, steps - WARMUP)


def data(args, transform, device):
    """Transform-domain inputs, targets and voxel weights, each
    ``(N, 1, P, P, P)`` float32 on ``device``."""
    p = dict(json.load(open(TRAFFIC))["inputs"])
    p.update(patch=args.patch, block=[args.block] * 3, count=args.patches,
             volumes=max(1, args.patches // PER_BLOCK), tubes=TUBES)
    raw, clean, fg = generate.patches(p, args.seed, device)
    x = transform.forward(raw.float())[:, None]
    y = transform.forward(clean.float())[:, None]
    w = (1.0 + FG_WEIGHT * fg.float())[:, None]
    return x, y, w


def run(args):
    cfg = json.load(open(args.config))
    model_cfg, transform_cfg = cfg["model_config"], cfg["transform"]
    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
    T = unet.transform(transform_cfg)
    x, y, w = data(args, T, dev)
    params = train.to_params(init(model_cfg, args.seed), dev)
    opt = train.AdamW(params, (0.9, 0.999), 1e-8, WD)
    pick = torch.Generator(device=dev).manual_seed(
        generate.sub_seed(args.seed, 1))
    log = []
    t0 = time.time()
    for t in range(args.steps):
        idx = torch.randint(0, x.shape[0], (args.batch,), generator=pick,
                            device=dev)
        for p in params.values():
            p.grad = None
        pred = rcan3d.forward(params, x[idx], model_cfg)
        wb = w[idx]
        loss = (wb * train.charbonnier(pred - y[idx], EPS)).mean() \
            / wb.mean()
        loss.backward()
        grads = {k: p.grad for k, p in params.items()}
        norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        scale = torch.clamp(CLIP / (norm + 1e-12), max=1.0)
        for g in grads.values():
            g.mul_(scale)
        opt.step(grads, rate(t, args.steps))
        if t % LOG_EVERY == 0 or t == args.steps - 1:
            rec = {"step": t + 1, "loss": float(loss.detach()),
                   "grad_norm": float(norm), "lr": rate(t, args.steps),
                   "s": round(time.time() - t0, 2)}
            log.append(rec)
            print(json.dumps(rec), flush=True)
    return params, model_cfg, transform_cfg, log


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="the checkpoint to write")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=CONFIG,
                    help="the configuration whose model_config and "
                         "transform to train (default rcan3d-c32's)")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--patch", type=int, default=64)
    ap.add_argument("--block", type=int, default=128)
    ap.add_argument("--patches", type=int, default=2048)
    args = ap.parse_args(argv)
    params, model_cfg, transform_cfg, log = run(args)
    from exaspim_tpu_torch.train.checkpoint import save_checkpoint

    recipe = {k: v for k, v in vars(args).items()
              if k not in ("out", "config")}
    recipe.update(per_block=PER_BLOCK, tubes=TUBES, lr=LR, warmup=WARMUP,
                  wd=WD, clip=CLIP, eps=EPS, fg_weight=FG_WEIGHT)
    save_checkpoint(args.out, as_tree(params), model_cfg, transform_cfg,
                    step=args.steps,
                    extra={"trained_by": "benchmark.train_rcan3d",
                           "recipe": recipe, "last": log[-1]})
    return log


if __name__ == "__main__":
    main()
