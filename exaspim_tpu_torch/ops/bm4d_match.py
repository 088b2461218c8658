"""BM4D block matching: the distance table and the top-K selection.

Counterpart of ``exaspim_tpu/ops/pallas_bm4d.py``. For every reference
block ``r`` on the stride-``step`` grid of a guide volume and every window
offset ``Δ ∈ [−half, half]³`` the table holds

    D[r, Δ] = Σ_{v ∈ B³} (g(r + v) − g(r + Δ + v))²

on the guide reflect-padded by ``half``, with the reference's three
rounding points (they decide who wins a near-tie): the squared
differences are summed over the block's z extent in f32 (t = 0..B−1, in
order) and rounded to bf16; those are summed over the block's y extent in
f32 and rounded to bf16; those over x in f32 and rounded to bf16 for the
table. The selection then takes, per reference, the ``group`` smallest
packed int32 keys

    key = bf16 bits << 16 | min(‖Δ‖², 15) << 12 | dy << 8 | dx << 4 | dz

(offset digits in [0, W); a non-negative bf16 orders as its bits, and the
low half prefers near offsets among equal distances, so flat regions do
not collapse to a window corner), and emits *unclipped* absolute block
starts ``step·g + digit − half`` per axis; the caller clips them.

The table's layout is this module's own: ``(R, W³)`` bf16, references
z-major, the offsets of one reference contiguous in (Δz, Δy, Δx) order
with Δx fastest.

Each of the two functions is one kernel: on a CUDA tensor
:func:`match_distances` launches ``csrc/bm4d_match.cu`` and
:func:`select_topk` launches ``csrc/bm4d_select.cu`` (or raise); on a CPU
tensor they run :func:`match_distances_plain` and
:func:`select_topk_plain`. Both count their launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

__all__ = [
    "match_topk",
    "match_distances",
    "match_distances_plain",
    "select_topk",
    "select_topk_plain",
    "grid_shape",
    "pad_guide",
    "strided_box_sum",
]

_MAX_SEARCH = 15  # offset digits are 4-bit fields of the key
_MAX_GROUP = 32  # one lane of the selecting warp keeps one member
_MAX_SHARED = 48 * 1024  # static limit of a block's shared memory


def grid_shape(shape, block, step):
    """Reference-grid extent ``(gz, gy, gx)`` of a guide of ``shape``;
    raises unless ``(dim − block) % step == 0`` on every axis."""
    for d in shape:
        if d < block or (d - block) % step:
            raise ValueError(
                f"guide {tuple(shape)} needs (dim - {block}) % {step} == 0 "
                "on every axis (callers pad; see bm4d_stage)")
    return tuple((d - block) // step + 1 for d in shape)


def pad_guide(guide, search):
    """f32 guide reflect-padded by ``search // 2`` on all three axes (no
    edge repeat)."""
    half = search // 2
    if guide.dim() != 3:
        raise ValueError(f"expected a 3D guide, got {tuple(guide.shape)}")
    if min(guide.shape) <= half:
        raise ValueError(
            f"volume too small for matching: {tuple(guide.shape)} with "
            f"search window {search}")
    g = guide.to(torch.float32)
    if half == 0:
        return g.contiguous()
    return F.pad(g[None, None], (half,) * 6, mode="reflect")[0, 0].contiguous()


def _bf16_round(x):
    return x.to(torch.bfloat16).to(torch.float32)


def strided_box_sum(x, axis, size, stride):
    """Valid-mode sum of ``size`` neighbours along ``axis`` at every
    ``stride``-th window start, added in order (t = 0..size−1) in f32."""
    span = stride * ((x.shape[axis] - size) // stride) + 1
    idx = [slice(None)] * x.dim()
    acc = None
    for t in range(size):
        idx[axis] = slice(t, t + span, stride)
        acc = x[tuple(idx)] if acc is None else acc + x[tuple(idx)]
    return acc


def match_distances_plain(guide, block=4, step=3, search=9):
    """Plain PyTorch version of the distance table: ``(R, W³)`` bf16 (see
    the module docstring for the function and the layout)."""
    B, W = block, search
    gz, gy, gx = grid_shape(guide.shape, B, step)
    Z, Y, X = guide.shape
    g = guide.to(torch.float32)
    gp = pad_guide(guide, W)
    table = torch.empty((gz, gy, gx, W, W, W), dtype=torch.bfloat16,
                        device=guide.device)
    for dyi in range(W):
        for dxi in range(W):
            # All W z-shifts of this (Δy, Δx) at once: (W, Z, Y, X).
            sh = gp[:, dyi:dyi + Y, dxi:dxi + X].unfold(0, Z, 1)
            sh = sh.permute(0, 3, 1, 2)
            d = (g[None] - sh) ** 2
            d = _bf16_round(strided_box_sum(d, 1, B, step))
            d = _bf16_round(strided_box_sum(d, 2, B, step))
            d = strided_box_sum(d, 3, B, step).to(torch.bfloat16)
            table[:, :, :, :, dyi, dxi] = d.permute(1, 2, 3, 0)
    return table.reshape(gz * gy * gx, W * W * W)


def _keys(table, search):
    """Packed int32 sort keys of a ``(R, W³)`` bf16 table."""
    W = search
    half = W // 2
    c = torch.arange(W * W * W, device=table.device, dtype=torch.int32)
    dz, dy, dx = c // (W * W), (c // W) % W, c % W
    norm2 = (dz - half) ** 2 + (dy - half) ** 2 + (dx - half) ** 2
    low = (torch.clamp(norm2, max=15) << 12) | (dy << 8) | (dx << 4) | dz
    bits = table.contiguous().view(torch.int16).to(torch.int32) & 0xFFFF
    return (bits << 16) | low[None]


def _starts(keys, grid, step, search):
    """Decode selected keys ``(R, K)`` into unclipped absolute starts."""
    gz, gy, gx = grid
    half = search // 2
    r = torch.arange(gz * gy * gx, device=keys.device, dtype=torch.int32)
    zb = step * (r // (gy * gx))[:, None]
    yb = step * ((r // gx) % gy)[:, None]
    xb = step * (r % gx)[:, None]
    return (zb + (keys & 15) - half,
            yb + ((keys >> 8) & 15) - half,
            xb + ((keys >> 4) & 15) - half)


def select_topk_plain(table, grid, group=16, step=3, search=9):
    """Plain PyTorch version of the selection: the ``group`` smallest keys
    per reference, in ascending order, decoded to three ``(R, K)`` int32
    tensors of unclipped starts (z, y, x)."""
    keys = _keys(table, search)
    best = torch.topk(keys, group, dim=1, largest=False, sorted=True).values
    return _starts(best, grid, step, search)


def _check_table(table, grid, group, search):
    gz, gy, gx = grid
    want = (gz * gy * gx, search ** 3)
    if table.dtype != torch.bfloat16 or tuple(table.shape) != want:
        raise ValueError(f"expected a bf16 table {want}, got {table.dtype} "
                         f"{tuple(table.shape)}")
    if not 1 <= group <= min(_MAX_GROUP, search ** 3):
        raise ValueError(f"group size {group} outside 1..{_MAX_GROUP}")


def _check_search(search):
    if search > _MAX_SEARCH:
        raise ValueError(
            "the kernel matcher packs window offsets into 4-bit key digits; "
            f"search window {search} > {_MAX_SEARCH} needs matcher='dense'")
    if search < 1 or search % 2 == 0:
        raise ValueError(f"search window must be odd, got {search}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _launch_match(guide, block, step, search):
    from exaspim_tpu_torch.ops._build import load_library

    grid = grid_shape(guide.shape, block, step)
    gp = pad_guide(guide, search)
    span = block + search - 1
    if 4 * span ** 3 > _MAX_SHARED:
        raise ValueError(f"block {block} + search {search} needs "
                         f"{4 * span ** 3} bytes of shared memory, more "
                         f"than {_MAX_SHARED}")
    r = grid[0] * grid[1] * grid[2]
    table = torch.empty((r, search ** 3), dtype=torch.bfloat16,
                        device=guide.device)
    fn = load_library("bm4d_match").bm4d_match_f32
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(guide.device):
        rc = fn(gp.data_ptr(), *gp.shape, *grid, block, step, search,
                table.data_ptr(), _stream(guide.device))
    if rc != 0:
        raise RuntimeError(f"bm4d_match kernel launch failed: cudaError {rc}")
    match_distances.launches += 1
    return table


def match_distances(guide, block=4, step=3, search=9):
    """Distance table ``(R, W³)`` bf16 of a 3D guide (any float dtype; it
    is matched in f32). CUDA tensors go through ``csrc/bm4d_match.cu`` and
    count one launch in ``match_distances.launches``; CPU tensors go
    through :func:`match_distances_plain`."""
    _check_search(search)
    if guide.device.type == "cpu":
        return match_distances_plain(guide, block, step, search)
    if guide.device.type != "cuda":
        raise ValueError(f"unsupported device {guide.device}")
    return _launch_match(guide, block, step, search)


match_distances.launches = 0


def _launch_select(table, grid, group, step, search):
    from exaspim_tpu_torch.ops._build import load_library

    r = table.shape[0]
    out = torch.empty((3, r, group), dtype=torch.int32, device=table.device)
    fn = load_library("bm4d_select").bm4d_select_bf16
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(table.device):
        rc = fn(table.data_ptr(), *grid, group, step, search,
                out.data_ptr(), _stream(table.device))
    if rc != 0:
        raise RuntimeError(f"bm4d_select kernel launch failed: cudaError {rc}")
    select_topk.launches += 1
    return out[0], out[1], out[2]


def select_topk(table, grid, group=16, step=3, search=9):
    """The ``group`` best offsets per reference of a distance table →
    three ``(R, K)`` int32 tensors of unclipped starts (z, y, x), best
    first. CUDA tensors go through ``csrc/bm4d_select.cu`` and count one
    launch in ``select_topk.launches``; CPU tensors go through
    :func:`select_topk_plain`."""
    _check_search(search)
    _check_table(table, grid, group, search)
    table = table.contiguous()
    if table.device.type == "cpu":
        return select_topk_plain(table, grid, group, step, search)
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    return _launch_select(table, grid, group, step, search)


select_topk.launches = 0


def match_topk(guide, block=4, group=16, step=3, search=9):
    """Block matching on a (tail-regularized) guide volume.

    Returns ``(sz, sy, sx)``: three ``(R, K)`` int32 tensors of unclipped
    absolute block starts, the reference-grid start plus the selected
    window offset per group member, best first; member 0 is the reference
    itself. ``guide`` must satisfy ``(dim − block) % step == 0`` per axis.
    Two kernel launches on a CUDA tensor; the table is freed on return.
    """
    grid = grid_shape(guide.shape, block, step)
    table = match_distances(guide, block, step, search)
    return select_topk(table, grid, group, step, search)
