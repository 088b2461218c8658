"""Rows 4-5 against their bound: the frozen bound of the fused matcher
(the separable distance table's FP32 operations, or the guide read and the
starts written once) on every guide of the window (two stages a patch),
over the device time of the matcher kernel, in %."""

from benchmark import readers, yardstick


def read(run):
    if run.trace is None or not run.units:
        return None
    t = run.config["teacher"]
    p = run.traffic["inputs"]["patch"]
    guides = 2 * sum(size for size, _ in run.units)
    bound = guides * yardstick.match_bound_s((p,) * 3, t["block"], t["step"],
                                             t["search"], t["group"])
    return readers.share(bound, readers.conv_seconds(run, readers.MATCH))
