"""Device ms a batch outside the matcher kernel: the patch DCT conv, the
group transforms, thresholding and Wiener, the scatter and the fold
(copies left out)."""

from benchmark import readers


def read(run):
    if run.trace is None or not run.units:
        return None
    s = readers.other_seconds(run, readers.MATCH)
    return 1e3 * s / len(run.units) if s > 0 else None
