"""The matcher's FP32 operations (the frozen count of the separable
distance table, two stages a patch) of every patch of the window, over the
window's time, as a share of the card's FP32 peak, in %: the whole stage's
share of the peak, which bounds the matcher's roofline gains."""

from benchmark import yardstick


def read(run):
    if not run.units:
        return None
    t = run.config["teacher"]
    p = run.traffic["inputs"]["patch"]
    shape = (p,) * 3
    grid = yardstick.match_grid(shape, t["block"], t["step"])
    ops = 2 * sum(size for size, _ in run.units) * yardstick.match_operations(
        shape, grid, t["block"], t["search"])
    return 100.0 * ops / run.window_s / yardstick.PEAK_F32_FLOPS
