"""Model evaluation harnesses: supervised (saved blocks) and unsupervised
(against live BM4D ground truth).

Counterpart of ``exaspim_tpu/evaluate.py``: per-block compression ratios
with noisy baselines, 3-D SSIM, MAE / L∞ against BM4D ground truth, MIP
plots and CSV reports, with the same column names and rounding digits.

Model inference runs through the tiled engine
(:mod:`exaspim_tpu_torch.inference`) and the BM4D ground truth through
:func:`exaspim_tpu_torch.ops.bm4d.bm4d` (the fused matching kernel on the
card), so an evaluation pass stays on ``device`` except for the codec
calls.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from exaspim_tpu_torch.compression import best_codec, compute_cratio
from exaspim_tpu_torch.inference import predict, predict_patch
from exaspim_tpu_torch.ops.ssim import compute_lmax, compute_mae, ssim3d
from exaspim_tpu_torch.train.checkpoint import restore_pipeline
from exaspim_tpu_torch.transforms import with_offset
from exaspim_tpu_torch.utils.plots import plot_mips

__all__ = [
    "SupervisedEvaluator",
    "UnsupervisedEvaluator",
    "bm4d_ground_truth",
    "quality_metrics",
    "read_brain_ids",
    "read_voxels",
]


def _to_csv(rows, path):
    import pandas as pd

    df = pd.DataFrame(rows)
    df.to_csv(path, index=False)
    return df


def _f32(a, device):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)


def bm4d_ground_truth(noise, sigma, device="cuda"):
    """BM4D estimate of a raw patch, quantized to uint16 counts."""
    from exaspim_tpu_torch.ops.bm4d import bm4d

    gt = bm4d(np.asarray(noise, dtype=np.float32), sigma, device=device)
    return np.clip(np.round(gt.cpu().numpy()), 0, 65535).astype(np.uint16)


def quality_metrics(noise, gt, pred, device="cuda"):
    """The columns of an unsupervised row besides the ratios: SSIM against
    the noisy patch and the ground truth, MAE and L∞ against the ground
    truth."""
    rng = float(np.asarray(noise).max())
    n, g, p = (_f32(a, device) for a in (noise, gt, pred))
    return {
        "ssim_noise": round(float(ssim3d(n, p, data_range=rng)), 5),
        "ssim_gt": round(float(ssim3d(g, p, data_range=rng)), 5),
        "l1_gt": round(float(compute_mae(p, g)), 3),
        "lmax_gt": round(float(compute_lmax(p, g)), 3),
    }


class SupervisedEvaluator:
    """Evaluate checkpoints on a fixed set of noisy blocks.

    ``blocks``: dict ``{block_id: ndarray}`` or list of ``(id, ndarray)``.
    """

    def __init__(self, blocks, output_dir, clevel=6, save_mips=True,
                 patch_size=64, overlap=12, trim=5, batch_size=32,
                 dtype=torch.bfloat16, device="cuda"):
        if isinstance(blocks, dict):
            blocks = sorted(blocks.items())
        self.blocks = [(str(k), np.asarray(v)) for k, v in blocks]
        self.output_dir = os.fspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.codec = best_codec(clevel=clevel)
        self.save_mips = save_mips
        self.dtype, self.device = dtype, device
        self.predict_kwargs = dict(
            patch_size=patch_size, overlap=overlap, trim=trim,
            batch_size=batch_size, device=device,
        )
        # Noisy baselines computed once.
        self.baseline = {
            k: compute_cratio(v, self.codec) for k, v in self.blocks
        }
        if save_mips:
            for k, v in self.blocks:
                plot_mips(v, os.path.join(
                    self.output_dir, f"{k}_noisy_mips.png"
                ))

    def run(self, ckpt_path, offset=None):
        """Evaluate one checkpoint over every block → DataFrame + CSV."""
        model, transform = restore_pipeline(
            ckpt_path, dtype=self.dtype, device=self.device)
        rows = []
        for block_id, noisy in self.blocks:
            t = transform if offset is None else with_offset(
                transform, offset
            )
            denoised = predict(noisy, model, t, **self.predict_kwargs)
            cr = compute_cratio(denoised, self.codec)
            ssim = float(ssim3d(
                _f32(noisy, self.device), _f32(denoised, self.device),
                data_range=float(noisy.max()),
            ))
            rows.append({
                "block_id": block_id,
                "cratio_noisy": self.baseline[block_id],
                "cratio": cr,
                "cratio_gain": round(cr / self.baseline[block_id], 3),
                "ssim": round(ssim, 5),
            })
            if self.save_mips:
                plot_mips(denoised, os.path.join(
                    self.output_dir, f"{block_id}_denoised_mips.png"
                ))
        return _to_csv(
            rows, os.path.join(self.output_dir, "results.csv")
        )


class UnsupervisedEvaluator:
    """Evaluate against live BM4D ground truth at sampled voxels.

    ``read_patch(brain_id, voxel)`` → raw counts of one patch (or None to
    skip the voxel): a live or cached dataset's patch access.
    """

    def __init__(self, read_patch, output_dir, sigma_gt=10.0, clevel=6,
                 dtype=torch.bfloat16, device="cuda"):
        self.read_patch = read_patch
        self.output_dir = os.fspath(output_dir)
        os.makedirs(self.output_dir, exist_ok=True)
        self.sigma_gt = float(sigma_gt)
        self.codec = best_codec(clevel=clevel)
        self.dtype, self.device = dtype, device
        self._model = None

    def ingest_model(self, ckpt_path):
        """Load the checkpoint (model + transform) to evaluate."""
        self._model = restore_pipeline(
            ckpt_path, dtype=self.dtype, device=self.device)

    def run(self, voxel_lists, offsets=None):
        """``voxel_lists``: {(split, kind, brain_id): [(z, y, x), …]}.
        Writes one CSV per key; returns {key: DataFrame}."""
        assert self._model is not None, "call ingest_model first"
        out = {}
        for key, voxels in voxel_lists.items():
            split, kind, brain_id = key
            offset = (offsets or {}).get(brain_id, 0)
            rows = [
                self.compute_metrics(brain_id, tuple(v), offset)
                for v in voxels
            ]
            rows = [r for r in rows if r is not None]
            name = f"{split}_{kind}_{brain_id}.csv"
            out[key] = _to_csv(
                rows, os.path.join(self.output_dir, name)
            )
        return out

    def compute_metrics(self, brain_id, voxel, offset=0):
        """Per-voxel metric row."""
        model, transform = self._model
        noise = self.read_patch(brain_id, voxel)
        if noise is None:
            return None
        noise = np.asarray(noise)
        gt = bm4d_ground_truth(noise, self.sigma_gt, self.device)
        t = with_offset(transform, offset) if offset else transform
        pred = predict_patch(noise, model, t, device=self.device)
        return {
            "brain_id": brain_id,
            "voxel": str(tuple(int(v) for v in voxel)),
            "cratio": compute_cratio(pred, self.codec),
            "cratio_noise": compute_cratio(noise, self.codec),
            "cratio_gt": compute_cratio(gt, self.codec),
            **quality_metrics(noise, gt, pred, self.device),
        }


def read_brain_ids(data_dir, is_test=True):
    """Cohort brain-id list JSON."""
    import json

    name = "test" if is_test else "train"
    with open(os.path.join(data_dir, f"{name}_brain_ids.json")) as f:
        return json.load(f)


def read_voxels(data_dir, brain_id, is_foreground=True):
    """Voxel-tuple CSV for one brain; an empty list when absent."""
    import ast

    import pandas as pd

    kind = "foreground" if is_foreground else "background"
    path = os.path.join(data_dir, f"{kind}-{brain_id}.csv")
    try:
        return list(pd.read_csv(path)["voxels"].apply(ast.literal_eval))
    except FileNotFoundError:
        return []
