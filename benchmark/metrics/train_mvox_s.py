"""Patch voxels of every step the window ran (batch × patch³) over the
window's whole time, in millions a second (host clock; the step in flight
at the deadline is finished and counted)."""


def read(run):
    return sum(size for size, _ in run.units) / run.window_s / 1e6
