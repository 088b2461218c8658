"""The benchmark's frozen arithmetic: the card's peaks, the operations and
bytes of each kernel's work, and the tiling plans they are counted on.

These are copies, taken once, of the counts the port's own benches use
(``ops/nb_bench.unet_conv_shapes``, kept in ``counts/UNet.py``: each
model's conv list is a file of its own; ``chip_smoke.py``'s conv and
dL/dW bytes, ``ops/match_bench.match_operations``, ``pipeline._tile_plan``,
``inference.generate_patch_starts``). They live here so that a change to
the program cannot move the yardstick: every roofline share and every MFU
of the benchmark is computed from these functions alone, for the work the
shapes need, whatever kernel the program runs.
"""

from __future__ import annotations

import importlib.util
import math
import os

# NVIDIA H100 SXM, published dense peaks (data sheet, 700 W).
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores
PEAK_BYTES = 3.35e12

# One file a model, ``counts/<model>.py`` with ``conv_shapes(n,
# model_config)``: a new architecture brings its own.
COUNTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "counts")
_LOADED = {}


def model_config(model, width=None):
    """A model configuration: ``model`` itself where it is one, or the
    U-Net family's name and width (``("UNet", 1.0)``)."""
    if isinstance(model, dict):
        return model
    return {"model": model, "width_multiplier": width}


def counts_module(name, counts_dir=COUNTS):
    """The counts file ``<counts_dir>/<name>.py`` of model ``name``, or
    None where the benchmark has none."""
    path = os.path.join(counts_dir, f"{name}.py")
    if not os.path.exists(path):
        return None
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"bench_counts_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def conv_shapes(model, n, width=None, counts_dir=COUNTS):
    """The 3³ convs of one forward and backward of ``model`` (a model
    configuration, or a U-Net's name and ``width``) on an ``n``³ input,
    ``(kind, n_i, segments, Cout)`` with kind ``fwd`` or ``dx``, from the
    model's counts file. A model without one raises ``LookupError``."""
    cfg = model_config(model, width)
    mod = counts_module(cfg["model"], counts_dir)
    if mod is None:
        raise LookupError(f"no counts file for the model {cfg['model']!r} "
                          f"in {counts_dir}")
    return mod.conv_shapes(n, cfg)


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


def forward_conv_bound_s(model, b, n, width=None, counts_dir=COUNTS):
    """Σ bound of the forward's 3³ convs of one batch."""
    return sum(bound_s(*conv_work(b, m, segs, cout, "fwd"))
               for kind, m, segs, cout in conv_shapes(model, n, width,
                                                      counts_dir)
               if kind == "fwd")


def step_conv_bound_s(model, b, n, width=None, counts_dir=COUNTS):
    """Σ bound of one training step's 3³ convs: the forwards, the dL/dx
    and the dL/dW of every forward conv; ``(rows 1-2, row 3)``."""
    shapes = conv_shapes(model, n, width, counts_dir)
    fwd_dx = sum(bound_s(*conv_work(b, m, segs, cout, kind))
                 for kind, m, segs, cout in shapes)
    dw = sum(bound_s(*conv_work(b, m, segs, cout, "dw"))
             for kind, m, segs, cout in shapes if kind == "fwd")
    return fwd_dx, dw


def forward_flops(model, b, n, width=None, counts_dir=COUNTS):
    """Model FLOPs of one forward: its 3³ convs (the U-Net's 1×1 head,
    resize and norms are below a thousandth of them)."""
    return sum(conv_work(b, m, segs, cout, "fwd")[0]
               for kind, m, segs, cout in conv_shapes(model, n, width,
                                                      counts_dir)
               if kind == "fwd")


def step_flops(model, b, n, width=None, counts_dir=COUNTS):
    """Model FLOPs of one training step: forward, dL/dx and dL/dW."""
    shapes = conv_shapes(model, n, width, counts_dir)
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
