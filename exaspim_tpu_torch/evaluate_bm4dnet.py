"""End-to-end whole-volume evaluation: denoise, compress, compare, persist.

Counterpart of ``scripts/evaluate_bm4dnet.py``: pick the best
(lowest-score) checkpoint, lazily read a local (OME-)Zarr volume, crop by
voxel or Neuroglancer coordinates, fold in the per-volume background
offset, run tiled inference, report raw-vs-denoised compression ratios,
write MIP plots, and optionally persist the denoised crop as OME-Zarr with
propagated scale and translation.

    python -m exaspim_tpu_torch.evaluate_bm4dnet --ckpt-dir RUNS/bm4dnet \\
        --img DATA/tile.ome.zarr/0 --crop-center 5000 5000 5000 \\
        --crop-shape 1024 1024 1024 --offset 37 --out RESULTS/tile
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from exaspim_tpu_torch.compression import best_codec, compute_cratio
from exaspim_tpu_torch.inference import build_volume_transform, predict
from exaspim_tpu_torch.train.checkpoint import (
    find_best_checkpoint,
    restore_pipeline,
)
from exaspim_tpu_torch.utils import img_io
from exaspim_tpu_torch.utils.plots import plot_mips

__all__ = ["evaluate", "main"]


def evaluate(ckpt, img_path, out_dir, crop_center=None, crop_shape=None,
             neuroglancer_xyz=None, offset=None, clevel=5,
             write_output=None, patch_size=64, overlap=12, trim=5,
             batch_size=32, streaming_slab=None, dtype=torch.bfloat16,
             device="cuda"):
    """Run the full evaluation; returns the results dict."""
    os.makedirs(out_dir, exist_ok=True)
    if os.path.isdir(ckpt) and not ckpt.endswith(".ckpt"):
        ckpt = find_best_checkpoint(ckpt)
    model, transform = restore_pipeline(ckpt, dtype=dtype, device=device)

    img = img_io.read(img_path)
    level_transform = None
    try:
        level_transform = img_io.get_ome_zarr_level_transform(img_path)
    except (ValueError, FileNotFoundError):
        pass

    if neuroglancer_xyz is not None:
        if level_transform is None:
            raise ValueError(
                "neuroglancer coordinates need OME metadata"
            )
        crop_center = img_io.ome_zarr_coordinate_to_voxel(
            neuroglancer_xyz, level_transform
        )
    if crop_center is not None and crop_shape is not None:
        raw = img_io.get_patch(img, crop_center, crop_shape)
    else:
        raw = np.asarray(img)
        if raw.ndim == 5:
            raw = raw[0, 0]
    raw = raw.astype(np.uint16)

    vt = build_volume_transform(
        transform, img=None if offset is not None else raw,
        offset=offset,
    )
    kw = dict(patch_size=patch_size, overlap=overlap, trim=trim,
              batch_size=batch_size, device=device)
    if streaming_slab:
        from exaspim_tpu_torch.pipeline import denoise_volume

        denoised = denoise_volume(raw, model, vt, slab_z=streaming_slab, **kw)
    else:
        denoised = predict(raw, model, vt, **kw)

    codec = best_codec(clevel=clevel)
    cr_raw = compute_cratio(raw, codec)
    cr_den = compute_cratio(denoised, codec)
    results = {
        "checkpoint": ckpt,
        "img": str(img_path),
        "crop_center": crop_center and list(crop_center),
        "crop_shape": crop_shape and list(crop_shape),
        "offset": offset,
        "cratio_raw": cr_raw,
        "cratio_denoised": cr_den,
        "cratio_gain": round(cr_den / cr_raw, 3),
    }
    plot_mips(raw, os.path.join(out_dir, "raw_mips.png"))
    plot_mips(denoised, os.path.join(out_dir, "denoised_mips.png"))
    with open(os.path.join(out_dir, "results.json"), "w") as f:
        json.dump(results, f, indent=2)

    if write_output:
        scale = translation = None
        if level_transform is not None:
            scale = level_transform["scale"]
            # Propagate the crop as a physical translation.
            translation = list(level_transform["translation"])
            if crop_center is not None and crop_shape is not None:
                start, _ = img_io.get_start_end(crop_center, crop_shape)
                for d in range(3):
                    translation[2 + d] += start[d] * scale[2 + d]
        img_io.write_ome_zarr(
            denoised, write_output, scale=scale,
            translation=translation, clevel=clevel,
        )
        results["output"] = write_output
    print(json.dumps(results, indent=2))
    return results


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ckpt-dir", required=True,
                   help="checkpoint file or directory to rank")
    p.add_argument("--img", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--crop-center", type=int, nargs=3)
    p.add_argument("--crop-shape", type=int, nargs=3)
    p.add_argument("--neuroglancer-xyz", type=float, nargs=3)
    p.add_argument("--offset", type=float)
    p.add_argument("--clevel", type=int, default=5)
    p.add_argument("--write-output", help="OME-Zarr destination")
    p.add_argument("--streaming-slab", type=int,
                   help="denoise in z-slabs of this size (for crops "
                        "beyond device memory)")
    p.add_argument("--patch", default="auto",
                   help="patch size (int) or 'auto' to let "
                        "inference.plan_tiling minimize overlap "
                        "redundancy for the crop (default)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    evaluate(
        args.ckpt_dir, args.img, args.out,
        crop_center=args.crop_center and tuple(args.crop_center),
        crop_shape=args.crop_shape and tuple(args.crop_shape),
        neuroglancer_xyz=args.neuroglancer_xyz,
        offset=args.offset, clevel=args.clevel,
        write_output=args.write_output,
        streaming_slab=args.streaming_slab,
        patch_size=(
            args.patch if args.patch == "auto" else int(args.patch)
        ),
        device=args.device,
    )


if __name__ == "__main__":
    main()
