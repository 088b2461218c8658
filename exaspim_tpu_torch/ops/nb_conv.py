"""3³ SAME conv (no bias) with an optional GroupNorm-statistics epilogue.

PyTorch counterpart of ``exaspim_tpu/ops/nb_conv.py`` (``nb_conv3d:778``,
``nb_conv3d_stats:896``). The function is the same; the layout is not:
activations stay plain channels-last ``(B, D, H, W, C)`` and the taps
are DHWIO ``(3, 3, 3, Cin, Cout)`` (or the same taps already reshaped to
``(27, Cin, Cout)``). The input may be one tensor or two whose channels
concatenate (the decoder's ``[skip, up]``), consumed as K-segments.

On a CUDA tensor the wrapper launches the hand-written Hopper kernel in
``csrc/nb_conv3d.cu`` (bf16 only) or raises. On a CPU tensor it runs
:func:`nb_conv3d_plain`, the plain PyTorch version of the same function,
which the CPU tests and the kernel check in ``chip_smoke.py`` use.

Both are differentiable (``torch.autograd.Function``s, the counterparts
of ``_nb_conv3d_core`` / ``_nb_conv3d_stats_core``, ``nb_conv.py:798-961``).
The backward folds the stats cotangents into the output cotangent, runs
dL/dx as the same forward conv with flipped, channel-transposed taps, and
dL/dW through :func:`nb_conv3d_dw` (``csrc/nb_conv3d_dw.cu`` on the card,
:func:`nb_conv3d_dw_plain` on the CPU).
"""

from __future__ import annotations

import ctypes
import functools
import types

import torch
import torch.nn.functional as F

__all__ = [
    "nb_conv3d",
    "nb_conv3d_stats",
    "nb_conv3d_plain",
    "nb_conv3d_dw",
    "nb_conv3d_dw_plain",
]

_FWD_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]
_DW_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
    ctypes.c_void_p,
]


def _segments(xs):
    xs = (xs,) if isinstance(xs, torch.Tensor) else tuple(xs)
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"expected 1 or 2 input segments, got {len(xs)}")
    lead = xs[0].shape[:4]
    for x in xs:
        if x.dim() != 5 or x.shape[:4] != lead:
            raise ValueError(
                "segments must be (B, D, H, W, C_i) with equal B, D, H, W; "
                f"got {[tuple(s.shape) for s in xs]}"
            )
        if x.device != xs[0].device or x.dtype != xs[0].dtype:
            raise ValueError("segments must share one device and dtype")
    return xs


def _taps(k3, cin):
    if k3.dim() not in (3, 5) or k3.shape[-2] != cin or (
        k3.dim() == 5 and tuple(k3.shape[:3]) != (3, 3, 3)
    ) or (k3.dim() == 3 and k3.shape[0] != 27):
        raise ValueError(
            f"taps must be (3, 3, 3, {cin}, Cout) or (27, {cin}, Cout); "
            f"got {tuple(k3.shape)}"
        )
    return k3.reshape(27, cin, k3.shape[-1])


def nb_conv3d_plain(xs, k3, with_stats=False):
    """Plain PyTorch version: concat the segments, ``F.conv3d`` in f32,
    round to the input dtype; the stats are Σy and Σy² per
    ``(batch, channel)`` of the ROUNDED output, in f32."""
    xs = _segments(xs)
    x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    k = _taps(k3, x.shape[-1])
    w = k.reshape(3, 3, 3, k.shape[1], k.shape[2]).permute(4, 3, 0, 1, 2)
    y = F.conv3d(
        x.permute(0, 4, 1, 2, 3).float(), w.float(), padding=1
    ).permute(0, 2, 3, 4, 1).to(x.dtype)
    if not with_stats:
        return y
    yf = y.float()
    return y, yf.sum(dim=(1, 2, 3)), (yf * yf).sum(dim=(1, 2, 3))


def nb_conv3d_dw_plain(xs, g):
    """Plain PyTorch dL/dW: f32 ``conv3d_weight`` of the concatenated
    segments against the output cotangent ``g``; returns f32
    ``(27, Cin, Cout)``."""
    xs = _segments(xs)
    x = torch.cat(xs, dim=-1) if len(xs) > 1 else xs[0]
    cin, cout = x.shape[-1], g.shape[-1]
    dw = torch.nn.grad.conv3d_weight(
        x.permute(0, 4, 1, 2, 3).float(), (cout, cin, 3, 3, 3),
        g.permute(0, 4, 1, 2, 3).float(), padding=1,
    )
    return dw.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)


def _check_cuda(tensors, what):
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(
            f"the CUDA {what} kernel takes bf16 tensors; got "
            f"{[t.dtype for t in tensors]}"
        )
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: tensors are on different devices")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in tensors):
        raise ValueError(f"the CUDA {what} kernel needs contiguous, "
                         "16-byte aligned tensors")


# The card's streaming multiprocessors (H100 SXM): a plan aims for at least
# this many blocks, so that no SM idles at the deep levels.
SMS = 132
# HALO needs the 8 x 8 plane tile to be at least this full (12^3: 0.5625);
# smaller planes (4^3: 0.25) gather their rows (FLAT) instead.
_HALO_MIN_FILL = 0.5
_MODES = {"halo": 0, "flat": 1, "panel": 2, "res": 3}
# "res" needs this many tiles per SM to be worth its weight load.
_RES_MIN_TILES = 4
_RES_STAGES = 4  # csrc/nb_conv3d.cu: RES_HS, the halo ring


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=512)
def _plan(b, d, h, w, segs, cout):
    """Tile plan of ``csrc/nb_conv3d.cu`` for one conv (``segs`` a tuple;
    cached per shape, so the result is read-only).

    Returns a mapping: ``mode`` (``"halo"``: 8 (x) × 8 (y) × ``wg`` (z)
    voxel tiles with a staged halo; ``"res"``: the same tiles at ``wg`` 2
    and ``bn`` 32, walked by ``pblocks`` persistent blocks per channel tile
    that keep all their weights in shared memory; ``"flat"``: 64·``wg``
    consecutive voxels of one batch element, rows gathered per tap;
    ``"panel"``: the Cin = 1 entry conv, halo tiles with an im2col panel),
    ``wg`` (consumer warpgroups per block, 1 or 2), ``bn`` (output channels
    per block, 32, 64 or 128), ``tiles`` (voxel tiles per batch element),
    ``ntiles`` (channel tiles), ``pblocks`` (0 unless ``"res"``),
    ``ws_rows`` (the statistics' workspace is ``(b, ws_rows, cout)``: a row
    per unit, see :func:`_ws_row_voxels`; it depends on the extents only),
    ``blocks`` and ``stages``.

    Narrow convs (Cout 32 or 64, at most two 32-channel input chunks, all
    widths multiples of 8) with at least :data:`_RES_MIN_TILES` tiles per
    SM go ``"res"``. Otherwise the widest BN that divides Cout (at most
    128) is preferred, and a block of two warpgroups; narrower BN, then one
    warpgroup are taken while the grid has fewer than :data:`SMS` blocks.
    A plane that fills less than half of its 8 × 8 tiles goes FLAT when
    every segment's width is a multiple of 8 (the gathered rows are 16-byte
    copies). Whatever the plan, a batch element's output and statistics are
    the same bits (the kernel's note says why).
    """
    segs = tuple(int(c) for c in segs)
    bn0 = 128 if cout % 128 == 0 else 64 if cout % 64 == 0 else 32
    bns = [n for n in (128, 64, 32) if n <= bn0]
    fill = h * w / (_cdiv(h, 8) * 8 * _cdiv(w, 8) * 8)
    vec = all(c % 8 == 0 for c in segs)

    def halo(wg):
        return _cdiv(d, wg) * _cdiv(h, 8) * _cdiv(w, 8)

    # Statistics units (:func:`_ws_row_voxels`): FLAT's 64 voxels, or the
    # z planes of the 8 x 8 tiles; which, the extents and widths decide.
    flat = fill < _HALO_MIN_FILL and vec
    units = _cdiv(d * h * w, 64) if flat else d * _cdiv(h, 8) * _cdiv(w, 8)
    chunks = sum(_cdiv(c, 32) for c in segs)
    if (segs != (1,) and vec and not flat and chunks <= 2
            and cout in (32, 64)
            and b * halo(2) * (cout // 32) >= _RES_MIN_TILES * SMS):
        ntiles = cout // 32
        pblocks = min(b * halo(2), max(1, SMS // ntiles))
        return types.MappingProxyType({
            "mode": "res", "wg": 2, "bn": 32, "tiles": halo(2),
            "ntiles": ntiles, "pblocks": pblocks, "ws_rows": units,
            "blocks": pblocks * ntiles, "stages": _RES_STAGES})

    if segs == (1,):
        cands = [("panel", 2, halo(2))]
    elif flat:
        cands = [("flat", 1, units)]
    else:
        cands = [("halo", 2, halo(2)), ("halo", 1, halo(1))]
    options = [(mode, wg, tiles, bn) for mode, wg, tiles in cands
               for bn in bns]
    best = None
    for mode, wg, tiles, bn in options:
        blocks = b * tiles * _cdiv(cout, bn)
        if blocks >= SMS:
            best = (mode, wg, tiles, bn)
            break
        if best is None or blocks > b * best[2] * _cdiv(cout, best[3]):
            best = (mode, wg, tiles, bn)
    mode, wg, tiles, bn = best
    return types.MappingProxyType({
        "mode": mode, "wg": wg, "bn": bn, "tiles": tiles,
        "ntiles": _cdiv(cout, bn), "pblocks": 0, "ws_rows": units,
        "blocks": b * tiles * _cdiv(cout, bn),
        "stages": 5 if bn == 32 else 4})


def _tile_voxels(plan, d, h, w, t):
    """Flat voxel indices (within one batch element) of tile ``t`` of
    ``plan`` that lie in the volume, in the kernel's row order."""
    wg = plan["wg"]
    if plan["mode"] == "flat":
        v = torch.arange(t * 64 * wg, (t + 1) * 64 * wg)
        return v[v < d * h * w]
    tx, ty = _cdiv(w, 8), _cdiv(h, 8)
    x0, y0, z0 = (t % tx) * 8, (t // tx % ty) * 8, t // (tx * ty) * wg
    r = torch.arange(64 * wg)
    z, y, x = z0 + r // 64, y0 + r // 8 % 8, x0 + r % 8
    ok = (z < d) & (y < h) & (x < w)
    return ((z * h + y) * w + x)[ok]


def _entry():
    """The C entry point of ``csrc/nb_conv3d.cu``, typed once."""
    from exaspim_tpu_torch.ops._build import load_library

    fn = load_library("nb_conv3d").nb_conv3d_bf16
    if fn.argtypes is None:
        fn.argtypes = _FWD_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _ws_row_voxels(plan, d, h, w, row):
    """Flat voxel indices (within one batch element) of statistics unit
    ``row``, the workspace row the kernel sums them into: 64 consecutive
    voxels for ``"flat"``, else the z plane ``row // (⌈H/8⌉·⌈W/8⌉)`` of an
    8 × 8 tile, in the kernel's row order. The same for every batch
    element and batch size."""
    if plan["mode"] == "flat":
        v = torch.arange(row * 64, (row + 1) * 64)
        return v[v < d * h * w]
    tx, ty = _cdiv(w, 8), _cdiv(h, 8)
    z, y0, x0 = row // (tx * ty), (row // tx % ty) * 8, (row % tx) * 8
    r = torch.arange(64)
    y, x = y0 + r // 8, x0 + r % 8
    ok = (z < d) & (y < h) & (x < w)
    return ((z * h + y) * w + x)[ok]


def _launch(xs, k, with_stats, debug=0):
    _check_cuda((*xs, k), "conv")
    x0 = xs[0]
    b, d, h, w = x0.shape[:4]
    cout = k.shape[-1]
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    segs = tuple(x.shape[-1] for x in xs)
    plan = _plan(b, d, h, w, segs, cout)
    fn = _entry()
    dev = x0.device
    out = torch.empty((b, d, h, w, cout), dtype=torch.bfloat16, device=dev)
    s1 = s2 = ws = None
    if with_stats and plan["ws_rows"] > 1:  # one row: the kernel writes s1
        ws = torch.empty((2, b, plan["ws_rows"], cout), dtype=torch.float32,
                         device=dev)
    if with_stats:
        s1 = torch.empty((b, cout), dtype=torch.float32, device=dev)
        s2 = torch.empty_like(s1)
    xa = xs[0]
    xb = xs[1] if len(xs) > 1 else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            xa.data_ptr(), None if xb is None else xb.data_ptr(),
            segs[0], 0 if xb is None else segs[1],
            k.data_ptr(), out.data_ptr(),
            None if ws is None else ws[0].data_ptr(),
            None if ws is None else ws[1].data_ptr(),
            None if s1 is None else s1.data_ptr(),
            None if s2 is None else s2.data_ptr(),
            b, d, h, w, cout, _MODES[plan["mode"]], plan["bn"], plan["wg"],
            plan["tiles"], plan["pblocks"], int(debug), stream,
        )
    if rc != 0:
        raise RuntimeError(f"nb_conv3d kernel launch failed: cudaError {rc}")
    nb_conv3d.launches += 1
    if ws is not None:  # the C entry point also launched the reduce kernel
        nb_conv3d.reduce_launches += 1
    return (out, s1, s2) if with_stats else out


def _conv(xs, k, with_stats):
    """One forward conv on the tensors' device, outside autograd."""
    if xs[0].device.type == "cpu":
        return nb_conv3d_plain(xs, k, with_stats)
    if xs[0].device.type != "cuda":
        raise ValueError(f"unsupported device {xs[0].device}")
    return _launch(xs, k, with_stats)


# dL/dW plan (csrc/nb_conv3d_dw.cu): voxel tiles of 8 x 8 x _DW_ZT[mode]
# (FLAT: _DW_ZT whole planes of 16 voxels), a Cout tile of 32 (FLAT: two,
# one per warpgroup), and a Cin slice of two 32-channel chunks with one
# block per dz plane (HALO, FLAT), or of one chunk whose block takes all 27
# taps (ZSTACK). The split count is chosen by a cost model: waves of blocks
# (two HALO blocks per SM, one ZSTACK or FLAT, four PANEL)
# times the tiles each block walks, at _DW_TILE_US a tile, plus the
# reduce's read of every split's workspace slice (FLAT: as many splits as
# run in one wave). The tile cost is the
# model's constant, not a measurement; the cap keeps the workspace under
# 256 MiB.
_DW_ZT = {"halo": 2, "panel": 4, "zstack": 2, "flat": 8}
_DW_BN = {"halo": 32, "panel": 32, "zstack": 32, "flat": 64}
_DW_MODES = {"halo": 0, "panel": 1, "zstack": 2, "flat": 3}
_DW_TILE_US = 1.0
_DW_PER_SM = {"halo": 2, "panel": 4, "zstack": 1, "flat": 1}
_DW_BYTES_PER_US = 3.0e6
_DW_WS_CAP = 2 ** 28
# FLAT: a padded plane ((H + 2) x W) of at most this many voxels.
_DW_FLAT_PW = 24


@functools.lru_cache(maxsize=512)
def _dw_plan(b, d, h, w, segs, cout):
    """Plan of ``csrc/nb_conv3d_dw.cu`` for one dL/dW launch (``segs`` a
    tuple; cached per shape, so the result is read-only).

    Returns a mapping: ``mode`` (``"panel"`` for the Cin = 1 entry conv;
    ``"flat"`` for planes of 16 voxels (4 × 4, 8 × 2; every width a
    multiple of 8), whose tiles are whole planes with no padded row;
    ``"zstack"`` for one segment of at most 32 channels, a multiple of 8,
    whose m64 block stacks two dz planes; else ``"halo"``), ``tiles``
    (voxel tiles of one batch element: 8 × 8 × 4 voxels in ``"panel"``,
    8 × 8 × 2 otherwise; in ``"flat"`` tiles of 8 whole planes of the
    batch's ``b · d``, in order, which may span batch elements), ``total``
    (``b * tiles``; ``tiles`` in ``"flat"``), ``slices`` (Cin slices: two 32-channel chunks of the
    segments in ``"halo"`` and ``"flat"``, the one chunk in ``"zstack"``),
    ``bn`` (Cout columns of a block: 64 in ``"flat"``, else 32),
    ``ctiles`` (Cout tiles of ``bn``), ``dz`` (blocks per (slice, Cout
    tile): 3 in ``"halo"`` and ``"flat"``, one per dz plane of 9 taps; else
    1), ``splits`` (contiguous ranges of the ``total`` tiles, one per block
    row, none empty), ``per`` (tiles per split; the last split may hold
    fewer) and ``blocks``. The grid reaches :data:`SMS` blocks whenever
    ``dz · slices · ctiles · total`` does, at the cheapest split count by
    the cost model; FLAT (one block per SM) takes as many splits as run in
    one wave instead.
    """
    segs = tuple(int(c) for c in segs)
    chunks = sum(_cdiv(c, 32) for c in segs)
    vec = all(c % 8 == 0 for c in segs) and cout % 8 == 0
    if segs == (1,):
        mode = "panel"
    elif vec and h * w == 16 and (h + 2) * w <= _DW_FLAT_PW:
        mode = "flat"
    elif chunks == 1 and segs[0] % 8 == 0:
        mode = "zstack"
    else:
        mode = "halo"
    if mode == "flat":  # tiles of the batch's planes, in order
        tiles = total = _cdiv(b * d, _DW_ZT[mode])
    else:
        tiles = _cdiv(d, _DW_ZT[mode]) * _cdiv(h, 8) * _cdiv(w, 8)
        total = b * tiles
    bn = _DW_BN[mode]
    ctiles = _cdiv(cout, bn)
    slices = (1 if mode == "panel" else chunks if mode == "zstack"
              else _cdiv(chunks, 2))
    dz = 3 if mode in ("halo", "flat") else 1
    base = dz * slices * ctiles
    ws_split = 4 * 27 * sum(segs) * cout
    slots = SMS * _DW_PER_SM[mode]
    # More than eight waves only shortens the last one.
    s_max = max(1, min(total, 65535, _DW_WS_CAP // ws_split,
                       8 * slots // base))
    best = None
    for s in range(1, s_max + 1):
        per = _cdiv(total, s)
        s = _cdiv(total, per)  # no empty split
        if mode == "flat":
            # One block per SM: as many splits as run in one wave (a
            # second wave costs a whole block; 4³ on an H100: 2 splits,
            # 96 blocks, faster than 3 in two waves, PERF.md).
            if s == 1 or base * s <= SMS:
                best = (0.0, s, per)
            continue
        if base * s < min(SMS, base * s_max):  # the card could be filled
            continue
        cost = (_cdiv(base * s, slots) * per * _DW_TILE_US
                + (s * ws_split / _DW_BYTES_PER_US if s > 1 else 0.0))
        if best is None or cost < best[0]:
            best = (cost, s, per)
    _, splits, per = best
    return types.MappingProxyType({
        "mode": mode, "tiles": tiles, "total": total, "slices": slices,
        "bn": bn, "ctiles": ctiles, "dz": dz, "splits": splits, "per": per,
        "blocks": base * splits})


def _dw_entry():
    """The C entry point of ``csrc/nb_conv3d_dw.cu``, typed once."""
    from exaspim_tpu_torch.ops._build import load_library

    fn = load_library("nb_conv3d_dw").nb_conv3d_dw_bf16
    if fn.argtypes is None:
        fn.argtypes = _DW_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _launch_dw(xs, g, debug=0):
    _check_cuda((*xs, g), "dL/dW")
    b, d, h, w = g.shape[:4]
    cout = g.shape[-1]
    if d * h * w >= 2 ** 31:
        raise ValueError("D·H·W must fit a 32-bit index")
    segs = tuple(x.shape[-1] for x in xs)
    cin = sum(segs)
    plan = _dw_plan(b, d, h, w, segs, cout)
    out = torch.empty((27, cin, cout), dtype=torch.float32, device=g.device)
    ws = None if plan["splits"] == 1 else torch.empty(
        (plan["splits"] - 1, 27, cin, cout), dtype=torch.float32,
        device=g.device)
    fn = _dw_entry()
    xa = xs[0]
    xb = xs[1] if len(xs) > 1 else None
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(
            xa.data_ptr(), None if xb is None else xb.data_ptr(),
            segs[0], 0 if xb is None else segs[1], g.data_ptr(),
            None if ws is None else ws.data_ptr(), out.data_ptr(), b, d, h,
            w, cout,
            _DW_MODES[plan["mode"]], plan["splits"], plan["per"],
            int(debug), stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"nb_conv3d_dw kernel launch failed: cudaError {rc}")
    nb_conv3d_dw.launches += 1
    return out


def nb_conv3d_dw(xs, g):
    """dL/dW of the 3³ SAME conv: f32 ``(27, Cin, Cout)`` with
    ``dW[tap, c, n] = Σ_{b, v} x[b, v + δ_tap, c] · g[b, v, n]`` (taps
    outside the volume read zero).

    ``xs`` are the conv's input segments, ``g`` the output cotangent
    ``(B, D, H, W, Cout)``. CUDA tensors go through ``csrc/nb_conv3d_dw.cu``
    (bf16, contiguous) and count one launch in ``nb_conv3d_dw.launches``;
    CPU tensors go through :func:`nb_conv3d_dw_plain`.
    """
    xs = _segments(xs)
    if g.dim() != 5 or g.shape[:4] != xs[0].shape[:4]:
        raise ValueError(f"g {tuple(g.shape)} does not match the input "
                         f"{tuple(xs[0].shape)}")
    if g.device.type == "cpu":
        return nb_conv3d_dw_plain(xs, g)
    if g.device.type != "cuda":
        raise ValueError(f"unsupported device {g.device}")
    return _launch_dw(xs, g)


nb_conv3d_dw.launches = 0


class _Conv3d(torch.autograd.Function):
    """3³ SAME conv with a backward on the same kernels.

    ``forward(with_stats, k, *xs)`` saves the segments and the taps (and
    ``y`` with stats). Backward, as ``_bwd_from_g`` and ``_stats_vjp_bwd``
    (``exaspim_tpu/ops/nb_conv.py:848, 943``):

    * g = (ḡ_y + ḡ₁ + 2·y·ḡ₂) in f32, cast to y's dtype (stats only);
    * dL/dx = the forward conv of g with the taps flipped over the 27 taps
      and transposed to ``(27, Cout, Cin)``, split back onto the segments;
      skipped for segments that need no gradient;
    * dL/dW = :func:`nb_conv3d_dw` (f32), cast to the taps' dtype.
    """

    @staticmethod
    def forward(ctx, with_stats, k, *xs):
        res = _conv(xs, k, with_stats)
        ctx.with_stats = with_stats
        ctx.save_for_backward(k, *xs, *((res[0],) if with_stats else ()))
        return res

    @staticmethod
    def backward(ctx, g_y, g_s1=None, g_s2=None):
        k, *xs = ctx.saved_tensors
        if ctx.with_stats:
            y = xs.pop()
            g = (g_y.float() + g_s1.float()[:, None, None, None, :]
                 + 2.0 * y.float() * g_s2.float()[:, None, None, None, :])
            g = g.to(y.dtype)
        else:
            g = g_y.to(xs[0].dtype)
        g = g.contiguous()
        need_dk = ctx.needs_input_grad[1]
        need_dx = ctx.needs_input_grad[2:]
        dxs = [None] * len(xs)
        if any(need_dx):
            k_t = k.flip(0).transpose(1, 2).contiguous()
            dx_all = _conv((g,), k_t, False)
            o = 0
            for i, x in enumerate(xs):
                c = x.shape[-1]
                if need_dx[i]:
                    dxs[i] = dx_all[..., o:o + c].contiguous()
                o += c
        dk = nb_conv3d_dw(xs, g).to(k.dtype) if need_dk else None
        return (None, dk, *dxs)


def nb_conv3d(xs, k3, with_stats=False):
    """3³ SAME conv, no bias, f32 accumulation, output in the input dtype.

    Args:
      xs: a ``(B, D, H, W, C)`` tensor or a tuple of two whose channels
        concatenate.
      k3: taps ``(3, 3, 3, Cin, Cout)`` or ``(27, Cin, Cout)``.
      with_stats: also return f32 ``(B, Cout)`` Σy and Σy² of the rounded
        output (what GroupNorm needs).

    CUDA tensors go through the Hopper kernel (bf16, contiguous) and
    count one launch in ``nb_conv3d.launches``; with statistics over more
    than one unit the kernel's fixed-order reduce runs too and counts one
    in ``nb_conv3d.reduce_launches``. CPU tensors go through
    :func:`nb_conv3d_plain`. Differentiable in ``xs`` and ``k3``: the
    backward runs on the same kernels (see :class:`_Conv3d`).
    """
    xs = _segments(xs)
    k = _taps(k3, sum(x.shape[-1] for x in xs))
    return _Conv3d.apply(bool(with_stats), k, *xs)


nb_conv3d.launches = 0
nb_conv3d.reduce_launches = 0


def nb_conv3d_stats(xs, k3):
    """``nb_conv3d(xs, k3, with_stats=True)``: returns ``(y, s1, s2)``."""
    return nb_conv3d(xs, k3, with_stats=True)
