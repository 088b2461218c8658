"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes of each kernel's work, and the tiling plans they are counted on.

These are copies, taken once, of the counts the port's own benches use
(``ops/nb_bench.unet_conv_shapes``, ``chip_smoke.py``'s conv and dL/dW
bytes, ``ops/match_bench.match_operations``, ``pipeline._tile_plan``,
``inference.generate_patch_starts``). They live here so that a change to
the program cannot move the yardstick: every roofline share and every MFU
of the benchmark is computed from these functions alone, for the work the
shapes need, whatever kernel the program runs.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, published dense peaks (data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12


def channels(width, base=(32, 64, 128, 256, 512)):
    return tuple(int(c * width) for c in base)


def unet_conv_shapes(n, width=1.0, base=(32, 64, 128, 256, 512),
                     top_skip=True):
    """The 3³ convs of one forward and backward of the U-Net on an ``n``³
    input: ``(kind, n_i, segments, Cout)``, kind ``fwd`` (18) or ``dx``
    (17: every conv but the entry conv, whose input needs no gradient).
    The encoder halves every stage and the decoder doubles it, in
    ``UNet`` and ``N2V2UNet`` alike; ``top_skip=False`` is N2V2's last
    ``Up``, which convolves the upsampled segment alone (trilinear: its
    mid conv halves the channels)."""
    c1, c2, c3, c4, c5 = channels(width, base)
    fwd = []
    for i, (cin, cout) in enumerate(((1, c1), (c1, c2), (c2, c3), (c3, c4),
                                     (c4, c5 // 2))):
        fwd += [(n >> i, (cin,), cout), (n >> i, (cout,), cout)]
    ups = [(c4, c5 // 2, c4 // 2), (c3, c4 // 2, c3 // 2),
           (c2, c3 // 2, c2 // 2), (c1 if top_skip else 0, c2 // 2, c1)]
    for i, (cs, cu, cout) in enumerate(ups):
        m = n >> (3 - i)
        segs = (cs, cu) if cs else (cu,)
        fwd += [(m, segs, (cs + cu) // 2), (m, ((cs + cu) // 2,), cout)]
    out = [("fwd", *f) for f in fwd]
    out += [("dx", m, (cout,), sum(segs)) for m, segs, cout in fwd[1:]]
    return out


def conv_shapes(model, n, width):
    """The 3³ convs of ``UNet`` or ``N2V2UNet`` (no top skip)."""
    return unet_conv_shapes(n, width, top_skip=model != "N2V2UNet")


def conv_work(b, n, segs, cout, kind):
    """``(flops, bytes)`` of one 3³ conv launch over a batch of ``b``
    ``n``³ volumes: the forward with statistics (``fwd``), the forward
    without them (``dx``: the cotangent through transposed taps) or the
    weight gradient (``dw``). Each input byte read once, each output byte
    written once: bf16 activations, bf16 taps (f32 for dL/dW), and the
    f32 Σy, Σy² per (batch, channel) of a forward."""
    cin = sum(segs)
    vox = b * n ** 3
    flops = 2.0 * 27 * cin * cout * vox
    if kind == "dw":
        return flops, 2 * vox * (cin + cout) + 4 * 27 * cin * cout
    nbytes = 2 * vox * (cin + cout) + 2 * 27 * cin * cout
    if kind == "fwd":
        nbytes += 8 * b * cout
    return flops, nbytes


def bound_s(flops, nbytes, peak_flops=PEAK_BF16_FLOPS):
    """The least time the card could take: operations at ``peak_flops``
    or bytes at the memory rate, the larger."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def forward_conv_bound_s(model, b, n, width):
    """Σ bound of the forward's 3³ convs of one batch."""
    return sum(bound_s(*conv_work(b, m, segs, cout, "fwd"))
               for kind, m, segs, cout in conv_shapes(model, n, width)
               if kind == "fwd")


def step_conv_bound_s(model, b, n, width):
    """Σ bound of one training step's 3³ convs: the forwards, the dL/dx
    and the dL/dW of every forward conv; ``(rows 1-2, row 3)``."""
    shapes = conv_shapes(model, n, width)
    fwd_dx = sum(bound_s(*conv_work(b, m, segs, cout, kind))
                 for kind, m, segs, cout in shapes)
    dw = sum(bound_s(*conv_work(b, m, segs, cout, "dw"))
             for kind, m, segs, cout in shapes if kind == "fwd")
    return fwd_dx, dw


def forward_flops(model, b, n, width):
    """Model FLOPs of one forward: its 3³ convs (the 1×1 head, the resize
    and the norms are below a thousandth of them)."""
    return sum(conv_work(b, m, segs, cout, "fwd")[0]
               for kind, m, segs, cout in conv_shapes(model, n, width)
               if kind == "fwd")


def step_flops(model, b, n, width):
    """Model FLOPs of one training step: forward, dL/dx and dL/dW."""
    shapes = conv_shapes(model, n, width)
    return sum(conv_work(b, m, segs, cout, kind)[0]
               for kind, m, segs, cout in shapes) + sum(
        conv_work(b, m, segs, cout, "dw")[0]
        for kind, m, segs, cout in shapes if kind == "fwd")


# ---- tiling (copies of inference.generate_patch_starts / pipeline._tile_plan)

def axis_starts(dim, patch, overlap):
    stride = patch - overlap
    return list(range(0, max(dim - patch + stride, 1), stride))


def count_patches(shape, patch, overlap):
    return math.prod(len(axis_starts(d, patch, overlap)) for d in shape)


def slab_plan(shape, slab_z, patch, overlap):
    """The streamed volume's super-tiles of full planes: per tile the
    halo'd, grid-aligned extent ``(z, y, x)`` that is forwarded."""
    stride = patch - overlap
    slab_z = max(int(slab_z), patch)
    tiles = []
    for z0 in range(0, shape[0], slab_z):
        z1 = min(z0 + slab_z, shape[0])
        lo = max(z0 - patch, 0)
        lo -= lo % stride
        hi = min(z1 + patch, shape[0])
        tiles.append((hi - lo, shape[1], shape[2]))
    return tiles


def streamed_patches(shape, slab_z, patch, overlap, batch):
    """Patch slots the streamed volume forwards: each super-tile's grid,
    its last batch filled to ``batch``."""
    return sum(-(-count_patches(t, patch, overlap) // batch) * batch
               for t in slab_plan(shape, slab_z, patch, overlap))


# ---- BM4D block matching (copy of ops/match_bench.match_operations)

def match_grid(shape, block, step):
    return tuple((d - block) // step + 1 for d in shape)


def match_operations(shape, grid, block, search):
    """f32 operations of a guide's distance table when nothing is computed
    twice: a squared difference once per unordered voxel pair within the
    window, then per offset three strided box sums of ``block − 1`` adds."""
    Z, Y, X = shape
    gz, gy, gx = grid
    w3 = search ** 3
    squares = 2.0 * Z * Y * X * (w3 - 1) / 2
    sums = (block - 1.0) * w3 * (gz * Y * X + gz * gy * X + gz * gy * gx)
    return squares + sums


def match_bound_s(shape, block, step, search, group):
    """Bound of the fused matcher on one guide of ``shape`` (already
    padded to the stride grid): its operations at the FP32 peak, or the
    guide read once and the ``3·R·K`` int32 starts written once."""
    grid = match_grid(shape, block, step)
    refs = grid[0] * grid[1] * grid[2]
    return bound_s(match_operations(shape, grid, block, search),
                   4 * math.prod(shape) + 12 * refs * group, PEAK_F32_FLOPS)
