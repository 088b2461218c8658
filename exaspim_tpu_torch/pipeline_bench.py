"""End-to-end whole-volume wall-clock measurement of the streaming pipeline.

Counterpart of ``scripts/pipeline_bench.py``. Measures
``pipeline.denoise_volume`` with the shipped checkpoint (bf16) on a
synthetic phantom volume, Zarr v3 → Zarr v3 on local disk, and reports
M voxels/s (host clock, reader thread, copies and writes included) for:

* the default slab plan (full-plane z-slabs), twice: the first run pays the
  kernels' build and the allocator's warm-up, the second is the steady
  state;
* a forced-small ``--max-block-voxels`` run that exercises 3-axis
  streaming;

plus the device-only rate of one representative block of the default plan
(the same tiled program on a device-resident block, CUDA-synchronized), so
the IO-vs-device bound is named and not guessed, and the exact compression
ratios of the noisy and the denoised volume (libzstd only: the port's own
blosc1 encoder).

``--in-memory`` runs ndarray → ndarray instead (no ``tensorstore`` needed);
the reader thread then hands out slices of the array.

    python -m exaspim_tpu_torch.pipeline_bench [--n 512] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n", type=int, default=512)
    p.add_argument("--shape", type=int, nargs=3,
                   help="volume shape override (z y x); the 3-axis "
                        "streaming case is a wide-plane anisotropic "
                        "volume, not a cube: on a cube the patch-wide "
                        "halos dwarf the cores")
    p.add_argument("--out", default=None,
                   help="work directory (default: a fresh temporary one)")
    p.add_argument("--slab-z", type=int, default=256)
    p.add_argument("--max-block-voxels", type=int, default=64 * 600 * 600,
                   help="forced block bound for the 3-axis streaming run")
    p.add_argument("--skip-small", action="store_true")
    p.add_argument("--skip-slabs", action="store_true")
    p.add_argument("--in-memory", action="store_true",
                   help="ndarray in, ndarray out: no Zarr stores")
    args = p.parse_args(argv)

    import torch

    from exaspim_tpu_torch.compression import best_codec, compute_cratio
    from exaspim_tpu_torch.data.synthetic import (
        neurite_phantom,
        noisy_observation,
    )
    from exaspim_tpu_torch.inference import build_tiled_program, plan_tiling
    from exaspim_tpu_torch.pipeline import denoise_volume
    from exaspim_tpu_torch.train.checkpoint import restore_pipeline
    from exaspim_tpu_torch.utils import img_io

    out_dir = args.out or tempfile.mkdtemp(prefix="pipe_bench_")
    os.makedirs(out_dir, exist_ok=True)
    shape = tuple(args.shape) if args.shape else (args.n,) * 3
    nvox = shape[0] * shape[1] * shape[2]
    tag = "x".join(map(str, shape))
    src_path = os.path.join(out_dir, f"noisy_{tag}.zarr")
    noisy = None
    if args.in_memory or not os.path.exists(src_path):
        print(f"# building {tag} phantom …", flush=True)
        clean, _ = neurite_phantom(
            shape, n_tubes=max(4, 24 * nvox // 256 ** 3), seed=0
        )
        noisy = noisy_observation(clean, seed=1)
        del clean
        if not args.in_memory:
            img_io.write_zarr(noisy[None, None], src_path)
            noisy = None
    source = noisy if args.in_memory else src_path

    ckpt = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "checkpoints", "bm4dnet.msgpack",
    )
    model, transform = restore_pipeline(ckpt, dtype=torch.bfloat16)

    results = {"shape": list(shape),
               "device": torch.cuda.get_device_name(0),
               "source": "ndarray" if args.in_memory else "zarr3"}
    runs = [] if args.skip_slabs else [
        ("default_slabs_cold", dict(slab_z=args.slab_z)),
        ("default_slabs_warm", dict(slab_z=args.slab_z))]
    if not args.skip_small:
        runs.append((
            "forced_3axis",
            dict(slab_z=args.slab_z,
                 max_block_voxels=args.max_block_voxels),
        ))
    outputs = {}
    for name, kw in runs:
        base = name.replace("_cold", "").replace("_warm", "")
        out_path = None if args.in_memory else os.path.join(
            out_dir, f"denoised_{base}.zarr")
        t0 = time.time()
        outputs[base] = denoise_volume(
            source, model, transform, output_path=out_path,
            patch_size="auto", progress=True, **kw,
        )
        torch.cuda.synchronize()
        dt = time.time() - t0
        results[name] = {
            "wall_s": round(dt, 3),
            "mvox_per_s": round(nvox / dt / 1e6, 2),
        }
        print(json.dumps({name: results[name]}), flush=True)

    # Name the bound: the device-resident rate of one representative block
    # of the default plan (the same program) beside the end-to-end number.
    zb = min(args.slab_z + 64, shape[0])
    if args.in_memory:
        block = noisy[:zb]
    else:
        src = img_io.read(src_path)
        block = np.asarray(src[..., :zb, :, :].read().result())[0, 0]
    patch, batch = plan_tiling(block.shape, 12)
    # return_float keeps the result on the device (the uint16 quantization
    # of the default program ends in a copy to the host).
    program, starts = build_tiled_program(
        model, transform, block.shape, patch, 12, 5, batch,
        return_float=True,
    )
    dblock = torch.from_numpy(block.astype(np.float32)).cuda()

    def device_run():
        with torch.inference_mode():
            s = program(dblock, starts).sum()
        torch.cuda.synchronize()
        return float(s)

    device_run()
    reps = 3
    t0 = time.time()
    for _ in range(reps):
        device_run()
    ddt = (time.time() - t0) / reps
    results["device_only_block"] = {
        "block": list(block.shape),
        "mvox_per_s": round(block.size / ddt / 1e6, 2),
    }

    codec = best_codec(clevel=6)
    base = "default_slabs" if not args.skip_slabs else "forced_3axis"
    den = outputs[base]
    if not args.in_memory:
        den = np.asarray(img_io.read(den)[...].read().result())[0, 0]
        noisy = np.asarray(img_io.read(src_path)[...].read().result())[0, 0]
    results["cratio_noisy"] = compute_cratio(noisy, codec)
    results["cratio_denoised"] = compute_cratio(den, codec)
    results["cratio_gain"] = round(
        results["cratio_denoised"] / results["cratio_noisy"], 3
    )
    print(json.dumps(results), flush=True)
    with open(os.path.join(out_dir, f"results_{tag}.json"), "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
