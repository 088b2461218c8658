"""BM4D volumetric denoiser in PyTorch.

Counterpart of ``exaspim_tpu/ops/bm4d.py``: the same two-pass algorithm
(hard threshold, then empirical Wiener on the re-matched basic estimate)
with the same static structure, so its teachers can stand in for the JAX
package's:

* block matching on a reference grid of stride ``step``: either the two
  kernels of :mod:`exaspim_tpu_torch.ops.bm4d_match` (``matcher="kernel"``,
  the default; bf16 table, packed-key top-K) or dense f32 distances with
  a ``topk`` (``matcher="dense"``, needed for ``search > 15``);
* the factored 4D transform: a patch-extraction conv whose kernel already
  carries the 3D block DCT, one row gather per group, a ``(K, K)``
  contraction along the group axis, shrinkage, and the inverse chain;
* overlap-add aggregation: weighted block rows scattered onto a
  start-indexed row accumulator, then folded to voxels by B³ shifted adds
  (``agg="slices"``, the default) or by one col2im conv (``agg="conv"``,
  which holds the first against an independent fold).

The reference's other option values have no counterpart here and raise
with the value to use: its matchers ``"auto"`` / ``"pallas"`` are
``"kernel"`` and ``"xla"`` is ``"dense"``; its ``agg="sorted"`` pre-sorts
the scatter keys, which the deterministic scatter below does by itself.

Everything outside the matcher is plain PyTorch, as it is plain XLA in
the JAX package. Two things are the card's own. Full f32: cuDNN would run
the patch conv in TF32 by default, which rounds coefficients to 10 bits
and flips the 2.7σ threshold, so the stage runs inside a scope that turns
TF32 off and restores the flags. Determinism: a CUDA ``index_add_`` is
float atomics, whose order changes from run to run; the scatter runs
inside a scoped ``torch.use_deterministic_algorithms`` so that a teacher
does not depend on scheduling.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.nn.functional as F

from exaspim_tpu_torch.ops.bm4d_match import (
    match_topk,
    pad_guide,
    strided_box_sum,
)

__all__ = ["bm4d", "bm4d_stage", "bm4d_batch"]

# Option values of the reference without a counterpart, and what to pass.
_RENAMED = {
    "matcher": {"auto": "kernel", "pallas": "kernel", "xla": "dense"},
    "agg": {"sorted": "slices"},
}


def _dct_matrix_np(n):
    """Orthonormal DCT-II matrix (n, n), numpy."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    mat = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    mat[0] *= 1.0 / np.sqrt(n)
    mat[1:] *= np.sqrt(2.0 / n)
    return mat.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct4_matrix_np(k, b):
    """Full 4D group transform as one Kronecker matrix (K·B³, K·B³): the
    factorization oracle of the tests."""
    mk = _dct_matrix_np(k)
    mb = _dct_matrix_np(b)
    return np.kron(np.kron(np.kron(mk, mb), mb), mb)


@functools.lru_cache(maxsize=None)
def _col2im_kernel_np(b):
    """One-hot conv kernel (B, B, B, B³, 1) folding block rows to voxels:
    ``out[v] = Σ_δ rows[v − δ, flat(δ)]`` as a correlation with zero
    padding B−1."""
    kern = np.zeros((b, b, b, b * b * b, 1), np.float32)
    for dz in range(b):
        for dy in range(b):
            for dx in range(b):
                flat = (dz * b + dy) * b + dx
                kern[b - 1 - dz, b - 1 - dy, b - 1 - dx, flat, 0] = 1.0
    return kern


@functools.lru_cache(maxsize=None)
def _patch_kernel_np(b, c):
    """One-hot patch-extraction kernel (B, B, B, C, C·B³): output channel
    ``ci·B³ + flat(δ)`` holds input channel ``ci`` at in-block offset δ.
    The test oracle of :func:`_patch_dct_kernel_np`."""
    n = b * b * b
    kern = np.zeros((b, b, b, c, c * n), np.float32)
    for dz in range(b):
        for dy in range(b):
            for dx in range(b):
                flat = (dz * b + dy) * b + dx
                for ci in range(c):
                    kern[dz, dy, dx, ci, ci * n + flat] = 1.0
    return kern


@functools.lru_cache(maxsize=None)
def _kron3_matrix_np(b):
    """3D block DCT as one (B³, B³) matrix (row-major flat blocks)."""
    mb = _dct_matrix_np(b)
    return np.kron(np.kron(mb, mb), mb)


@functools.lru_cache(maxsize=None)
def _patch_dct_kernel_np(b, c):
    """DCT-emitting patch kernel (B, B, B, C, C·B³): output channel
    ``ci·B³ + j`` is the j-th 3D-DCT coefficient of input channel ``ci``'s
    block at the output position, so the B³×B³ half of the 4D transform
    runs once per table row instead of once per gathered group member."""
    m3 = _kron3_matrix_np(b)  # (j, flat(δ))
    n = b * b * b
    kern = np.zeros((b, b, b, c, c * n), np.float32)
    for dz in range(b):
        for dy in range(b):
            for dx in range(b):
                flat = (dz * b + dy) * b + dx
                for ci in range(c):
                    kern[dz, dy, dx, ci, ci * n: (ci + 1) * n] = m3[:, flat]
    return kern


@functools.lru_cache(maxsize=None)
def _col2im_agg_kernel_np(b):
    """Aggregation fold kernel (B, B, B, B³+1, 2): output 0 folds the B³
    value rows (the one-hot col2im), output 1 folds the augmented weight
    channel with every tap set."""
    nrow = b * b * b
    kern = np.zeros((b, b, b, nrow + 1, 2), np.float32)
    kern[..., :nrow, :1] = _col2im_kernel_np(b)
    kern[:, :, :, nrow, 1] = 1.0
    return kern


@contextlib.contextmanager
def _full_f32():
    """Convs and matrix products in full f32 for the duration; the
    process's TF32 flags are restored on exit."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = old


@contextlib.contextmanager
def _deterministic():
    """Deterministic scatter for the duration (on CUDA ``index_add_``
    sorts and sums in order instead of using float atomics)."""
    old = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(old[0], warn_only=old[1])


def _conv_ndhwc(x, kern_np):
    """VALID/explicitly padded 3D correlation of ``(Z, Y, X, Cin)`` with a
    DHWIO numpy kernel → ``(Z', Y', X', Cout)``, rows contiguous."""
    w = torch.from_numpy(kern_np).to(x.device).permute(4, 3, 0, 1, 2)
    out = F.conv3d(x.permute(3, 0, 1, 2)[None], w.contiguous())
    return out[0].permute(1, 2, 3, 0).contiguous()


def _box_sum3(x, size, stride):
    """Valid-mode box sum over a cube window of the last three axes,
    separably, at every ``stride``-th window start per axis."""
    for axis in range(x.dim() - 3, x.dim()):
        x = strided_box_sum(x, axis, size, stride)
    return x


def _match_dense(guide, B, K, W, step):
    """f32 distances over all window offsets, the near-offset tie-break,
    and a stable top-K → ``(R, K)`` int64 starts (z, y, x), unclipped."""
    Z, Y, X = guide.shape
    half = W // 2
    gpad = pad_guide(guide, W)
    gz, gy, gx = ((d - B) // step + 1 for d in (Z, Y, X))
    d2 = torch.empty((W, W, W, gz * gy * gx), device=guide.device)
    for dyi in range(W):
        for dxi in range(W):
            sh = gpad[:, dyi:dyi + Y, dxi:dxi + X].unfold(0, Z, 1)
            diff = (guide[None] - sh.permute(0, 3, 1, 2)) ** 2
            d2[:, dyi, dxi] = _box_sum3(diff, B, step).reshape(W, -1)
    d2 = d2.reshape(W ** 3, -1)  # (C, R), offsets in (Δz, Δy, Δx) order
    ar = torch.arange(W, device=guide.device) - half
    offs = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
    offs = offs.reshape(-1, 3)
    # Flat regions tie every candidate; prefer near offsets, by a penalty
    # far below any real distance difference.
    off_norm2 = (offs.to(torch.float32) ** 2).sum(1)
    tie_eps = 1e-6 * (d2.mean(dim=0, keepdim=True) + 1.0)
    d2 = d2 + tie_eps * off_norm2[:, None]
    idx = torch.sort(d2.T, dim=1, stable=True).indices[:, :K]
    refs = torch.stack(torch.meshgrid(
        *(torch.arange(g, device=guide.device) * step for g in (gz, gy, gx)),
        indexing="ij"), -1).reshape(-1, 3)
    sel = refs[:, None, :] + offs[idx]
    return sel[..., 0], sel[..., 1], sel[..., 2]


def _as_volume(x, device):
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.array(x, dtype=np.float32))  # a copy: the source may be read-only
    return t.to(device=device, dtype=torch.float32)


def bm4d_stage(noisy, guide, sigma, block=4, group=16, step=3, search=9,
               mode="hard", matcher="kernel", agg="slices", device="cuda"):
    """One BM4D pass over ``noisy``; groups are matched on ``guide``.

    ``mode="hard"``: hard-threshold coefficients at 2.7σ (stage 1).
    ``mode="wiener"``: empirical Wiener with ``guide`` as the signal
    estimate (stage 2). ``matcher``: ``"kernel"`` (the two matching
    kernels on a CUDA tensor, their plain versions on a CPU tensor) or
    ``"dense"``. ``agg``: ``"slices"`` or ``"conv"``. Volumes are numpy
    arrays or tensors and are moved to ``device``. Returns the aggregated estimate, an f32 tensor of the
    input's shape on ``device``.
    """
    if mode not in ("hard", "wiener"):
        raise ValueError(f"unknown mode {mode!r}")
    for name, value, known in (("matcher", matcher, ("kernel", "dense")),
                               ("agg", agg, ("slices", "conv"))):
        if value in _RENAMED[name]:
            raise ValueError(f"{name}={value!r} is the reference's option; "
                             f"here it is {name}={_RENAMED[name][value]!r}")
        if value not in known:
            raise ValueError(f"unknown {name} {value!r}")
    noisy = _as_volume(noisy, device)
    guide = _as_volume(guide, device)
    if noisy.dim() != 3 or noisy.shape != guide.shape:
        raise ValueError(f"expected two equal 3D volumes, got "
                         f"{tuple(noisy.shape)} and {tuple(guide.shape)}")
    with torch.no_grad(), _full_f32():
        return _stage(noisy, guide, np.float32(sigma), block, group, step,
                      search, mode, matcher, agg)


def _stage(noisy, guide, sigma, B, K, step, W, mode, matcher, agg):
    Z0, Y0, X0 = noisy.shape
    dev = noisy.device
    # Regularize the reference grid: reflect-pad each tail so (dim − B) is
    # a multiple of ``step``; results are cropped back at the end.
    tails = [(-(d - B)) % step for d in (Z0, Y0, X0)]
    if any(tails):
        pad = (0, tails[2], 0, tails[1], 0, tails[0])
        noisy = F.pad(noisy[None, None], pad, mode="reflect")[0, 0]
        guide = F.pad(guide[None, None], pad, mode="reflect")[0, 0]
    Z, Y, X = noisy.shape

    if matcher == "dense":
        sz, sy, sx = _match_dense(guide, B, K, W, step)
    else:
        sz, sy, sx = match_topk(guide, block=B, group=K, step=step, search=W)
    # Clamp near-border candidates into the volume (clipped members may
    # coincide); int64 for indexing.
    rz, ry, rx = Z - B + 1, Y - B + 1, X - B + 1
    lin = ((sz.long().clamp_(0, Z - B) * ry + sy.long().clamp_(0, Y - B))
           * rx + sx.long().clamp_(0, X - B))  # (R, K) row numbers
    del sz, sy, sx

    nb3 = B * B * B
    mk = torch.from_numpy(_dct_matrix_np(K)).to(dev)
    m3 = torch.from_numpy(_kron3_matrix_np(B)).to(dev)

    def block_rows(vols):
        # rows[p, ci·B³ + j]: the j-th 3D-DCT coefficient of channel ci's
        # block starting at voxel p, so the gather moves whole rows.
        rows = _conv_ndhwc(torch.stack(vols, -1),
                           _patch_dct_kernel_np(B, len(vols)))
        return rows.reshape(rz * ry * rx, len(vols) * nb3)

    if mode == "hard":
        g = block_rows([noisy])[lin]  # (R, K, B³) DCT-space rows
        coef = torch.matmul(mk, g)
        del g
        keep = coef.abs() > float(np.float32(2.7) * sigma)
        coef = torch.where(keep, coef, torch.zeros_like(coef))
        nretained = keep.sum(dim=(1, 2)).to(torch.float32)
        wgt = 1.0 / (1.0 + nretained)  # (R,)
        del keep
    else:
        both = block_rows([noisy, guide])[lin].reshape(-1, K, 2, nb3)
        coef_n = torch.matmul(mk, both[:, :, 0])
        coef_g = torch.matmul(mk, both[:, :, 1])
        del both
        g2 = coef_g ** 2
        shrink = g2 / (g2 + float(sigma * sigma) + 1e-12)
        coef = coef_n * shrink
        wgt = 1.0 / (1e-8 + (shrink ** 2).sum(dim=(1, 2)))
        del coef_n, coef_g, g2, shrink

    # Inverse: K-axis inverse (orthonormal, so the transpose), then one
    # inverse 3D DCT per row back to voxel space.
    filt = torch.matmul(mk.T, coef)
    filt = (filt.reshape(-1, nb3) @ m3).reshape(-1, K, nb3)
    del coef

    # Overlap-add aggregation: each value row carries its scalar weight
    # as an extra lane, so one row scatter accumulates both.
    w = wgt[:, None, None]
    nrow = nb3 + 1
    filt_rows = torch.cat([filt * w, w.expand(-1, K, 1)], dim=-1)
    filt_rows = filt_rows.reshape(-1, nrow)
    del filt
    acc_rows = torch.zeros((rz * ry * rx, nrow), device=dev)
    with _deterministic():
        acc_rows.index_add_(0, lin.reshape(-1), filt_rows)
    del filt_rows
    return _fold_rows(acc_rows.reshape(rz, ry, rx, nrow), agg,
                      B, Z, Y, X, Z0, Y0, X0, nrow)


def _fold_rows(acc_rows, agg, B, Z, Y, X, Z0, Y0, X0, nrow):
    """Fold rows back to voxel space: out[v] = Σ_δ rows[v − δ, flat(δ)]."""
    rz, ry, rx = acc_rows.shape[:3]
    if agg == "conv":
        # One conv: out channel 0 is the value col2im, channel 1 folds the
        # weight lane with an all-taps kernel.
        padded = F.pad(acc_rows, (0, 0) + (B - 1, B - 1) * 3)
        folded = _conv_ndhwc(padded, _col2im_agg_kernel_np(B))
        accum, weight = folded[..., 0], folded[..., 1]
    else:
        # B³ shifted adds, in the order of flat(δ), from a channel-major
        # copy so each add reads a contiguous volume.
        planes = acc_rows.permute(3, 0, 1, 2).contiguous()
        accum = torch.zeros((Z, Y, X), device=acc_rows.device)
        for dz in range(B):
            for dy in range(B):
                for dx in range(B):
                    flat = (dz * B + dy) * B + dx
                    accum[dz:dz + rz, dy:dy + ry, dx:dx + rx] += planes[flat]
        # The weight fold is a B-box sum of the weight lane, separably.
        weight = _box_sum3(
            F.pad(planes[nrow - 1], (B - 1, B - 1) * 3), B, 1)
    return (accum / (weight + 1e-12))[:Z0, :Y0, :X0]


def bm4d_batch(vols, sigma, block=4, group=16, step=3, search=9,
               two_stage=True, matcher="kernel", agg="slices", device="cuda"):
    """Denoise a batch of equal-shape volumes ``(N, Z, Y, X)``: a host
    loop of per-volume calls with single-volume peak memory, stacked on
    ``device``."""
    return torch.stack([
        bm4d(v, sigma, block=block, group=group, step=step, search=search,
             two_stage=two_stage, matcher=matcher, agg=agg, device=device)
        for v in vols
    ])


def bm4d(vol, sigma, block=4, group=16, step=3, search=9, two_stage=True,
         matcher="kernel", agg="slices", device="cuda"):
    """Denoise a 3D volume with BM4D.

    ``sigma`` is the noise standard deviation in the volume's intensity
    units. Returns an f32 tensor on ``device``; the caller rounds and
    clips to counts as needed.
    """
    vol = _as_volume(vol, device)
    if vol.dim() != 3:
        raise ValueError(f"expected 3D volume, got {tuple(vol.shape)}")
    kw = dict(block=block, group=group, step=step, search=search,
              matcher=matcher, agg=agg, device=device)
    basic = bm4d_stage(vol, vol, sigma, mode="hard", **kw)
    if not two_stage:
        return basic
    return bm4d_stage(vol, basic, sigma, mode="wiener", **kw)
