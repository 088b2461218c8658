"""BM4D teacher patches of every batch the window completed over the
window's whole time (host clock; the batch in flight at the deadline is
finished and counted)."""


def read(run):
    return sum(size for size, _ in run.units) / run.window_s
