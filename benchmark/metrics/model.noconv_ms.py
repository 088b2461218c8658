"""Device ms a unit (a volume, a step) in every kernel that is not a 3³
conv of the sources the cell builds (forward, dL/dx, dL/dW, statistics
reduce): GroupNorm, LeakyReLU, resize, casts, the overlap-average stitch,
the transforms, the loss, AdamW (copies left out)."""

from benchmark import readers


def read(run):
    if run.trace is None or not run.units:
        return None
    s = readers.other_seconds(run, readers.conv_kernels(run))
    return 1e3 * s / len(run.units) if s > 0 else None
