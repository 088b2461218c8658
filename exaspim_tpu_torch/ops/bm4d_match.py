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

:func:`match_topk` is the path's entry: on a CUDA tensor, one guide or a
batch of guides is one launch of the fused kernel of
``csrc/bm4d_match.cu`` (matching and selection in one tile loop; the table
never reaches device memory), counted in ``match_topk.launches``; on a CPU
tensor it runs :func:`match_topk_plain`. The two halves stay callable on
their own, each one kernel held against its plain version:
:func:`match_distances` (the table instance of ``csrc/bm4d_match.cu``)
and :func:`select_topk` (``csrc/bm4d_select.cu``, the fused kernel's
selection routine over a table in device memory), each with its own
launch count. No wrapper falls back: a launch that fails raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

__all__ = [
    "match_topk",
    "match_topk_plain",
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
# The matching kernel's tile plan (csrc/bm4d_match.cu): a block's shared
# memory on an H100, the threads of a block, and the register arrays of
# the instance for any block size (blocks up to 16, tiles up to 4 rows).
_SHARED_LIMIT = 227 * 1024
_THREADS = 256
_MAX_BLOCK, _MAX_GENERIC_ROWS = 16, 4


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
    if guide.dim() != 3:
        raise ValueError(f"expected a 3D guide, got {tuple(guide.shape)}")
    return _pad_guides(guide[None], search)[0]


def _pad_guides(guides, search):
    """``(N, Z, Y, X)`` guides as one contiguous f32 batch, each
    reflect-padded by ``search // 2``."""
    half = search // 2
    if min(guides.shape[1:]) <= half:
        raise ValueError(
            f"volume too small for matching: {tuple(guides.shape[1:])} with "
            f"search window {search}")
    g = guides.to(torch.float32)
    if half == 0:
        return g.contiguous()
    return F.pad(g[:, None], (half,) * 6, mode="reflect")[:, 0].contiguous()


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


def match_topk_plain(guides, block=4, group=16, step=3, search=9):
    """Plain PyTorch version of :func:`match_topk`:
    :func:`select_topk_plain` of :func:`match_distances_plain`, volume by
    volume; the same shapes as :func:`match_topk`."""
    g = guides[None] if guides.dim() == 3 else guides
    grid = grid_shape(g.shape[1:], block, step)
    per = [select_topk_plain(match_distances_plain(v, block, step, search),
                             grid, group, step, search) for v in g]
    out = [torch.stack([p[a] for p in per]) for a in range(3)]
    return tuple(o[0] for o in out) if guides.dim() == 3 else tuple(out)


def _check_group(group, search):
    if not 1 <= group <= min(_MAX_GROUP, search ** 3):
        raise ValueError(f"group size {group} outside 1..{_MAX_GROUP}")


def _check_table(table, grid, group, search):
    gz, gy, gx = grid
    want = (gz * gy * gx, search ** 3)
    if table.dtype != torch.bfloat16 or tuple(table.shape) != want:
        raise ValueError(f"expected a bf16 table {want}, got {table.dtype} "
                         f"{tuple(table.shape)}")
    _check_group(group, search)


def _check_search(search):
    if search > _MAX_SEARCH:
        raise ValueError(
            "the kernel matcher packs window offsets into 4-bit key digits; "
            f"search window {search} > {_MAX_SEARCH} needs matcher='dense'")
    if search < 1 or search % 2 == 0:
        raise ValueError(f"search window must be odd, got {search}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _pitch(minimum, residue):
    """The least pitch ≥ ``minimum`` that is ``residue`` modulo 32."""
    return minimum + (residue - minimum) % 32


def _shared_bytes(B, S, W, ty, tx, sz, table):
    """A matching block's shared memory (csrc/bm4d_match.cu run()): the
    union of ``B + W − 1`` planes of pitch ``sz``; at block 4, step 3 (the
    instances with tiles of 3 or 4 rows) 16-byte aligned and followed by the
    tile's reference rows as float4; for the fused kernel, the W³ low
    halves of the keys (rounded up to 8) and the tile's 16-bit keys."""
    shared = 4 * (B + W - 1) * sz
    if B == 4 and S == 3 and ty in (3, 4):
        shared = -(-shared // 16) * 16 + 16 * ((tx - 1) * S + B) * (
            (ty - 1) * S + B)
    if not table:
        w3 = W ** 3
        shared += 2 * (-(-w3 // 8) * 8 + ty * tx * w3)
    return shared


@functools.lru_cache(maxsize=None)
def _match_plan(grid, block, step, search, table=False):
    """The matching kernel's tile plan for a reference grid ``(gz, gy,
    gx)``: a block owns ``ty × tx`` references of one z row and stages
    their union search region; ``d`` window offsets per lane (3 where the
    block is 4, the step 3 and W a multiple of 3, else 1); the shared
    pitches ``sy``, ``sz`` put a warp's 32 consecutive offset tasks on 32
    banks; ``shared`` bytes (:func:`_shared_bytes`). Among the tiles that
    fit half of a block's shared memory (two blocks per SM), else all of
    it, the one with the fewest voxels of reference rows to walk, counting
    the ragged tiles at the grid's edge; at the defaults, at most 7
    columns, whose pitches an instance takes as constants. Raises when no
    tile fits. Cached: the caller must not change the dict."""
    gz, gy, gx = grid
    B, S, W = block, step, search
    fast = B == 4 and S == 3
    if not fast and B > _MAX_BLOCK:
        raise ValueError(f"the matching kernel takes blocks up to "
                         f"{_MAX_BLOCK}, not {B}; use matcher='dense'")
    d = 3 if fast and W % 3 == 0 else 1
    groups, w3 = W // d, W ** 3
    sy_mod = W * pow(d, -1, 32) % 32
    best = None
    for limit in (_SHARED_LIMIT // 2, _SHARED_LIMIT):
        for ty in (3, 4) if fast else range(1, _MAX_GENERIC_ROWS + 1):
            for tx in range(1, 8 if fast and W == 9 else 33):
                uy = (ty - 1) * S + B + W - 1
                ux = (tx - 1) * S + B + W - 1
                sy = _pitch(ux, sy_mod)
                sz = _pitch(uy * sy, groups * W % 32)
                shared = _shared_bytes(B, S, W, ty, tx, sz, table)
                if shared > limit:
                    continue
                tiles = (gz, -(-gy // ty), -(-gx // tx))
                cost = (tiles[1] * tiles[2] * ((ty - 1) * S + B)
                        * ((tx - 1) * S + B), shared)
                if best is None or cost < best[0]:
                    best = (cost, dict(ty=ty, tx=tx, d=d, sy=sy, sz=sz,
                                       shared=shared, tiles=tiles))
        if best is not None:
            break
    if best is None:
        raise ValueError(f"no tile of the matching kernel fits "
                         f"{_SHARED_LIMIT} bytes of shared memory at block "
                         f"{B}, step {S}, search {W}")
    plan = best[1]
    plan["threads"] = min(_THREADS, 32 * -(-(W * groups * W) // 32))
    return plan


def _launch(name, gp, grid, block, step, search, plan, extra, out):
    from exaspim_tpu_torch.ops._build import load_library

    fn = getattr(load_library("bm4d_match"), name)
    args = [gp.shape[0], *gp.shape[1:], *grid, block, step, search, *extra,
            plan["ty"], plan["tx"], plan["d"], plan["sy"], plan["sz"],
            plan["threads"]]
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * len(args) + [
        ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(gp.device):
        rc = fn(gp.data_ptr(), *args, out.data_ptr(), _stream(gp.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


def match_distances(guide, block=4, step=3, search=9):
    """Distance table ``(R, W³)`` bf16 of a 3D guide (any float dtype; it
    is matched in f32). CUDA tensors go through the table instance of
    ``csrc/bm4d_match.cu`` and count one launch in
    ``match_distances.launches``; CPU tensors go through
    :func:`match_distances_plain`."""
    _check_search(search)
    if guide.device.type == "cpu":
        return match_distances_plain(guide, block, step, search)
    if guide.device.type != "cuda":
        raise ValueError(f"unsupported device {guide.device}")
    grid = grid_shape(guide.shape, block, step)
    gp = _pad_guides(guide[None], search)
    plan = _match_plan(grid, block, step, search, table=True)
    table = torch.empty((grid[0] * grid[1] * grid[2], search ** 3),
                        dtype=torch.bfloat16, device=guide.device)
    _launch("bm4d_match_table_f32", gp, grid, block, step, search, plan, (),
            table)
    match_distances.launches += 1
    return table


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


def match_topk(guides, block=4, group=16, step=3, search=9):
    """Block matching on a (tail-regularized) guide volume ``(Z, Y, X)``
    or a batch of them ``(N, Z, Y, X)``.

    Returns ``(sz, sy, sx)``: int32 tensors of unclipped absolute block
    starts, the reference-grid start plus the selected window offset per
    group member, best first, ``(R, K)`` for one guide and ``(N, R, K)``
    for a batch; member 0 is the reference itself. Each guide must satisfy
    ``(dim − block) % step == 0`` per axis. On a CUDA tensor: one launch
    of the fused kernel for the whole batch, counted in
    ``match_topk.launches``; no distance table is allocated. On a CPU
    tensor: :func:`match_topk_plain`.
    """
    _check_search(search)
    _check_group(group, search)
    if guides.dim() not in (3, 4):
        raise ValueError(f"expected a 3D guide or a 4D batch of guides, got "
                         f"{tuple(guides.shape)}")
    g = guides[None] if guides.dim() == 3 else guides
    grid = grid_shape(g.shape[1:], block, step)
    if g.device.type == "cpu":
        return match_topk_plain(guides, block, group, step, search)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    gp = _pad_guides(g, search)
    plan = _match_plan(grid, block, step, search)
    n, r = g.shape[0], grid[0] * grid[1] * grid[2]
    out = torch.empty((3, n * r, group), dtype=torch.int32, device=g.device)
    _launch("bm4d_match_topk_f32", gp, grid, block, step, search, plan,
            (group,), out)
    match_topk.launches += 1
    out = out.view(3, n, r, group)
    return tuple(o[0] if guides.dim() == 3 else o for o in out)


match_topk.launches = 0
