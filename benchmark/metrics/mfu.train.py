"""Model FLOPs of a step (forward, dL/dx and dL/dW of the configuration's
3³ convs at the cell's batch) times the window's steps, over the window's
time, as a share of the card's bf16 peak, in %."""

from benchmark import readers, yardstick


def read(run):
    if not run.units:
        return None
    model, width = readers.model_width(run)
    b, n = run.traffic["batch_size"], run.traffic["inputs"]["patch"]
    flops = len(run.units) * yardstick.step_flops(model, b, n, width)
    return 100.0 * flops / run.window_s / yardstick.PEAK_BF16_FLOPS
