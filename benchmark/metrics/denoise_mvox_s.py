"""Output voxels of every volume the window completed over the window's
whole time, in millions a second (host clock; the volume in flight at the
deadline is finished and counted)."""


def read(run):
    return sum(size for size, _ in run.units) / run.window_s / 1e6
