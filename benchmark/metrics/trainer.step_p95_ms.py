"""95th percentile (linear interpolation) of every step of the traced
window: a step is the interval between consecutive end-of-step CUDA events
on the compute stream (the first from the window's start), with no
synchronisation added. Loader and host stalls show here; so does the
profiler's own cost on the host, which makes the traced steps slower than
untraced ones."""

import numpy as np


def read(run):
    return float(np.percentile(run.step_ms, 95)) if run.step_ms else None
