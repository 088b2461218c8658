"""The plain reference of tiled whole-volume denoising: the whole volume's
patch grid (stride ``patch − overlap``, the last patches reaching past
the volume into zeros of the transform domain), every patch through the
float32 model, ``trim`` voxels dropped on each face that does not touch
the volume's edge, the overlapping predictions averaged by their weights
(``Σ w·pred / (Σ w + 1e-8)``) and mapped back to counts. One pass over
the whole volume: a streamed program must give the same voxels."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import unet


def starts(dim, patch, overlap):
    stride = patch - overlap
    return list(range(0, max(dim - patch + stride, 1), stride))


def trim_mask(start, patch, trim, shape, device):
    w = torch.ones((patch,) * 3, device=device)
    idx = torch.arange(patch, device=device)
    for axis in range(3):
        keep = torch.ones(patch, dtype=torch.bool, device=device)
        if start[axis] > 0:
            keep &= idx >= trim
        if start[axis] + patch < shape[axis]:
            keep &= idx < patch - trim
        view = [1, 1, 1]
        view[axis] = patch
        w = w * keep.float().reshape(view)
    return w


@torch.no_grad()
def denoise(model, params, model_cfg, transform_cfg, noisy, patch, overlap,
            trim, batch, device, quant=None):
    """Float counts ``(Z, Y, X)`` (clamped to 0..65535, not rounded) of
    the reference denoising of the uint16 volume ``noisy`` by ``model``,
    the configuration's reference module (``references.reference_model``)."""
    T = unet.transform(transform_cfg)
    vol = torch.from_numpy(noisy.astype(np.float32)).to(device)
    x = T.forward(vol)
    del vol
    shape = tuple(x.shape)
    grid = [starts(d, patch, overlap) for d in shape]
    padded = [g[-1] + patch for g in grid]
    x = F.pad(x, [0, padded[2] - shape[2], 0, padded[1] - shape[1],
                  0, padded[0] - shape[0]])
    acc = torch.zeros(padded, device=device)
    wgt = torch.zeros(padded, device=device)
    coords = [(z, y, w) for z in grid[0] for y in grid[1] for w in grid[2]]
    for i in range(0, len(coords), batch):
        chunk = coords[i:i + batch]
        xb = torch.stack([x[z:z + patch, y:y + patch, w:w + patch]
                          for z, y, w in chunk])[:, None]
        pred = model.forward(params, xb, model_cfg, quant)[:, 0]
        for (z, y, w), pr in zip(chunk, pred):
            m = trim_mask((z, y, w), patch, trim, shape, device)
            acc[z:z + patch, y:y + patch, w:w + patch] += pr * m
            wgt[z:z + patch, y:y + patch, w:w + patch] += m
    out = (acc / (wgt + 1e-8))[:shape[0], :shape[1], :shape[2]]
    return T.inverse(out)
