"""Convert a checkpoint of the upstream reference package (a torch ``.pt``
/ ``.pth``) to this package's msgpack.

Counterpart of ``scripts/import_torch_checkpoint.py``: the migration path
for users with weights trained by the reference. Both of its formats load
(the ``{"model", "transform", "model_config"}`` dict and a legacy bare
state dict), and the conversion is exact: the conv biases are kept
(``conv_bias=True``) and the upsampling grid is the reference's
(``align_corners=True``).

    python -m exaspim_tpu_torch.import_torch_checkpoint ref.pth out.msgpack
        [--verify] [--device cuda|cpu]

``--verify`` runs the reference's own torch model (it needs the reference
package, ``aind_exaspim_image_compression``, importable) and the imported
model on the same random 32³ patch and prints the max |Δ|. The imported
model runs on ``--device``: bf16 on the card, f32 on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

__all__ = ["main"]


def _reference_model(config, state_dict):
    """The reference's torch model of ``config`` with ``state_dict``."""
    try:
        from aind_exaspim_image_compression.machine_learning.unet3d import (
            N2V2UNet,
            UNet,
        )
    except ImportError as exc:
        raise SystemExit(
            "--verify runs the reference's own model: install the "
            "reference package (aind_exaspim_image_compression) or drop "
            f"--verify ({exc})") from exc
    cls = N2V2UNet if config["model"] == "N2V2UNet" else UNet
    model = cls(width_multiplier=config["width_multiplier"],
                trilinear=config["trilinear"], residual=config["residual"])
    model.load_state_dict(state_dict)
    return model.eval()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("src", help="reference torch checkpoint (.pt/.pth)")
    p.add_argument("dst", help="output path for the msgpack checkpoint")
    p.add_argument("--verify", action="store_true",
                   help="forward both models on a random patch, report "
                        "max |d|")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to import on "
                           "the CPU")
    from exaspim_tpu_torch.train.checkpoint import import_torch_checkpoint

    model, transform = import_torch_checkpoint(args.src, args.dst,
                                               device=args.device)
    print(f"wrote {args.dst}")
    print(f"  model:     {model.config}")
    print(f"  transform: {transform.cfg}")
    if args.verify:
        ckpt = torch.load(args.src, map_location="cpu", weights_only=False)
        state_dict = (ckpt["model"] if isinstance(ckpt, dict)
                      and "model" in ckpt else ckpt)
        ref = _reference_model(model.config, state_dict)
        x = np.random.default_rng(0).normal(
            0.5, 0.2, (1, 32, 32, 32, 1)).astype(np.float32)
        with torch.no_grad():
            want = ref(torch.from_numpy(x).permute(0, 4, 1, 2, 3)).permute(
                0, 2, 3, 4, 1).numpy()
            got = model(torch.from_numpy(x).to(args.device)).float().cpu()
        print(f"  verify max|d| = {np.abs(got.numpy() - want).max():.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
