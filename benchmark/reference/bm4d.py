"""The plain reference of two-stage BM4D (Maggioni et al., "Nonlocal
transform-domain filter for volumetric data denoising and reconstruction",
IEEE TIP 2013), at the teacher stage's definition:

* blocks of ``B``³ voxels, reference blocks on a grid of stride ``step``
  (each tail reflect-padded so that the grid reaches it, the result
  cropped back);
* matching on a guide: the squared distance of each reference block to
  the block at every offset of a ``W``³ window (the guide reflect-padded
  by ``W // 2``) in the teacher's stated matching precision (a bf16 table,
  rounded after the sums over z, over y and over x), near offsets first
  among equal distances, the ``K`` smallest kept, their starts clamped
  into the volume;
* the group's 4D transform: orthonormal DCT-II over each block's three
  axes and over the group's axis;
* stage 1 (the noisy volume as its own guide): coefficients kept where
  ``|c| > 2.7σ``, group weight ``1 / (1 + kept)``; stage 2 (matched on
  stage 1's estimate): empirical Wiener ``c·g² / (g² + σ²)`` with ``g``
  the estimate's coefficients, weight ``1 / (1e-8 + Σ shrink²)``;
* aggregation: every filtered block added back at its start times its
  group's weight, divided by the summed weights (``+ 1e-12``).

Float32 outside the distance table, one volume at a time.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dct_matrix(n, device):
    k = torch.arange(n, dtype=torch.float64)[:, None]
    i = torch.arange(n, dtype=torch.float64)[None, :]
    m = torch.cos(math.pi * (2 * i + 1) * k / (2 * n))
    m[0] *= 1.0 / math.sqrt(n)
    m[1:] *= math.sqrt(2.0 / n)
    return m.to(torch.float32).to(device)


def _reflect(v, pads):
    """``v`` ``(Z, Y, X)`` reflect-padded by ``pads`` ``(lo, hi)`` per
    axis (the edge voxel not repeated)."""
    flat = [p for pair in reversed(pads) for p in pair]
    return F.pad(v[None, None], flat, mode="reflect")[0, 0]


def block_rows(v, B):
    """``(rz·ry·rx, B³)``: every ``B``³ block of ``v``, by its start,
    row-major within the block."""
    u = v.unfold(0, B, 1).unfold(1, B, 1).unfold(2, B, 1)
    return u.reshape(-1, B * B * B)


def _box(x, axis, B, step):
    """Sums of ``B`` neighbours along ``axis`` at every ``step``-th start,
    added in order in float32."""
    n = (x.shape[axis] - B) // step + 1
    out = None
    for t in range(B):
        part = x.narrow(axis, t, step * (n - 1) + 1)
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(None, None, step)
        out = part[tuple(idx)] if out is None else out + part[tuple(idx)]
    return out


def bf16(x):
    """The distance table's stated precision."""
    return x.to(torch.bfloat16).to(torch.float32)


def e4m3(x):
    """The format below it (the control's), one scale per tensor (its
    largest magnitude at the format's largest value)."""
    s = x.abs().amax().clamp(min=1e-30) / torch.finfo(torch.float8_e4m3fn).max
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def match(guide, B, K, W, step, table=bf16):
    """``(R, K)`` linear block starts (over the ``(Z−B+1)·(Y−B+1)·(X−B+1)``
    starts) of the ``K`` blocks nearest each reference block.

    The distance table in the configuration's matching precision: the
    squared differences summed over the block's z extent, rounded by
    ``table`` (bf16; the control's e4m3), over y, rounded, over x,
    rounded. Among equal distances the
    nearer offset wins (``min(|Δ|², 15)``), then the offset's digits
    ``(dy, dx, dz)``."""
    Z, Y, X = guide.shape
    h = W // 2
    gp = _reflect(guide, [(h, h)] * 3)
    dist = []
    for oz in range(W):
        for oy in range(W):
            d = torch.stack([(guide - gp[oz:oz + Z, oy:oy + Y, ox:ox + X])
                             ** 2 for ox in range(W)])
            for axis in (1, 2, 3):
                d = table(_box(d, axis, B, step))
            dist.append(d.reshape(W, -1))
    dist = torch.cat(dist)  # (W³, R), offsets in (z, y, x) order
    c = torch.arange(W ** 3, device=guide.device)
    dz, dy, dx = c // (W * W), (c // W) % W, c % W
    near = ((dz - h) ** 2 + (dy - h) ** 2 + (dx - h) ** 2).clamp(max=15)
    tie = ((near * 16 + dy) * 16 + dx) * 16 + dz  # < 2^16
    key = dist.double() * 65536.0 + tie[:, None].double()
    idx = torch.topk(key.T, K, dim=1, largest=False).indices
    off = torch.stack([dz, dy, dx], -1) - h
    start = grid_starts(guide.shape, B, step, guide.device)[:, None, :] \
        + off[idx]
    return linear(start, guide.shape, B)


def grid_starts(shape, B, step, device):
    """``(R, 3)`` starts of the reference blocks, z-major."""
    grid = [torch.arange(0, d - B + 1, step, device=device) for d in shape]
    return torch.stack(torch.meshgrid(*grid, indexing="ij"), -1).reshape(-1, 3)


def linear(start, shape, B):
    """Block starts ``(..., 3)``, clamped into the volume, as linear
    indices over the ``(Z−B+1)·(Y−B+1)·(X−B+1)`` starts."""
    Z, Y, X = shape
    lim = torch.tensor([Z - B, Y - B, X - B], device=start.device)
    start = torch.minimum(start.long().clamp(min=0), lim)
    ry, rx = Y - B + 1, X - B + 1
    return (start[..., 0] * ry + start[..., 1]) * rx + start[..., 2]


def group_excess(guide, lin, B, K, W, step):
    """How much farther the groups ``lin`` ``(R, K)`` lie from their
    reference blocks than this reference's own matching on ``guide``
    finds, in float64 squared distances summed over every group:
    ``(D(lin) − D(own)) / D(own)``. Both select through the bf16 table,
    so the gap of two sound matchers is rounding's."""
    own = match(guide, B, K, W, step)
    rows = block_rows(guide.double(), B)
    refs = linear(grid_starts(guide.shape, B, step, guide.device),
                  guide.shape, B)

    def total(idx):
        return float((rows[idx] - rows[refs][:, None]).square().sum())

    d_own = total(own)
    return (total(lin) - d_own) / d_own


def stage(noisy, guide, sigma, B, K, W, step, hard, lin=None):
    """One BM4D pass; ``lin``, when given, the groups ``(R, K)`` in place
    of matching on ``guide``. The matrix products follow torch's TF32
    setting (off for the reference, on for the control)."""
    mm = torch.matmul
    Z, Y, X = noisy.shape
    dev = noisy.device
    if lin is None:
        lin = match(guide, B, K, W, step)
    mb, mk = dct_matrix(B, dev), dct_matrix(K, dev)
    m3 = torch.kron(torch.kron(mb, mb), mb)
    n = B ** 3
    coef = mm(mk, mm(block_rows(noisy, B)[lin], m3.T))  # (R, K, B³)
    if hard:
        keep = coef.abs() > 2.7 * sigma
        coef = torch.where(keep, coef, torch.zeros_like(coef))
        wgt = 1.0 / (1.0 + keep.sum(dim=(1, 2)).float())
    else:
        g = mm(mk, mm(block_rows(guide, B)[lin], m3.T))
        shrink = g * g / (g * g + sigma * sigma + 1e-12)
        coef = coef * shrink
        wgt = 1.0 / (1e-8 + (shrink ** 2).sum(dim=(1, 2)))
    filt = mm(mm(mk.T, coef), m3)  # back to voxels, (R, K, B³)
    rz, ry, rx = Z - B + 1, Y - B + 1, X - B + 1
    rows = torch.zeros((rz * ry * rx, n + 1), device=dev)
    vals = torch.cat([filt * wgt[:, None, None],
                      wgt[:, None, None].expand(-1, K, 1)], -1)
    rows.index_add_(0, lin.reshape(-1), vals.reshape(-1, n + 1))
    rows = rows.reshape(rz, ry, rx, n + 1)
    acc = torch.zeros((Z, Y, X), device=dev)
    weight = torch.zeros((Z, Y, X), device=dev)
    for dz in range(B):
        for dy in range(B):
            for dx in range(B):
                j = (dz * B + dy) * B + dx
                acc[dz:dz + rz, dy:dy + ry, dx:dx + rx] += rows[..., j]
                weight[dz:dz + rz, dy:dy + ry, dx:dx + rx] += rows[..., n]
    return acc / (weight + 1e-12)


@torch.no_grad()
def bm4d(vol, sigma, block, group, step, search, basic=None, groups=None):
    """Two-stage BM4D of one ``(Z, Y, X)`` float32 volume: ``(stage 1's
    estimate, stage 2's)``. To follow another implementation stage by
    stage, ``basic`` is the stage-1 estimate that stage 2 filters with in
    place of the reference's own, and ``groups`` its stage-2 groups
    ``(R, K)`` (linear starts) in place of matching on it; both need a
    grid that reaches every tail (``(dim − block) % step == 0``)."""
    Z0, Y0, X0 = vol.shape
    tails = [(0, (-(d - block)) % step) for d in vol.shape]
    if any(t for _, t in tails):
        if basic is not None:
            raise ValueError("following another stage 1 needs no tails")
        vol = _reflect(vol, tails)
    kw = (block, group, search, step)
    own = stage(vol, vol, float(sigma), *kw, True)
    guide = own if basic is None else basic
    out = stage(vol, guide, float(sigma), *kw, False, groups)
    return own[:Z0, :Y0, :X0], out[:Z0, :Y0, :X0]
