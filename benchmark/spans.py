"""What the readers of the program's own spans share.

The port records named spans on the thread that launches its CUDA work
(``exaspim_tpu_torch.utils.profiling.span``: ``pipeline.wait``,
``inference.cast``, ``trainer.step``, ...) into the profiler session that
``--trace 1`` runs over the window, so they sit in ``run.trace.host`` on
the clock of the device's operations. Two readings of them: how long the
host spent inside spans of some names, and how much of that time the
device had nothing to run. Both are None where no such span was traced:
a program without the spans reports nothing.
"""

from __future__ import annotations

from benchmark import trace as trace_mod


def _intervals(run, names):
    if run.trace is None:
        return []
    return [(a, b) for a, b, name in run.trace.host if name in names]


def overlap(xs, ys):
    """Measure of the intersection of two merged, sorted interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_seconds(run, names):
    """Σ seconds of the host spans named in ``names`` (each occurrence
    counted), or None where none was traced."""
    spans = _intervals(run, names)
    if not spans:
        return None
    return sum(b - a for a, b in spans) / 1e6


def idle_seconds_in(run, names):
    """Seconds in which the device ran nothing while the host was inside a
    span named in ``names``: the measure of the spans' union less its
    intersection with the union of the device's operations (streams that
    overlap, and spans nested or repeated, count once). None where no such
    span or no device operation was traced."""
    spans = _intervals(run, names)
    if not spans or not run.trace.device:
        return None
    merged = trace_mod.union(spans)
    busy = trace_mod.union(run.trace.device)
    return (sum(b - a for a, b in merged) - overlap(merged, busy)) / 1e6


def per_unit_ms(run, seconds):
    """``seconds`` in ms a unit of the window (a volume, a step), or None."""
    if seconds is None or not run.units:
        return None
    return 1e3 * seconds / len(run.units)
