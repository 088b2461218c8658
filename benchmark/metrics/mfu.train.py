"""Model FLOPs of a step (forward, dL/dx and dL/dW of the configuration's
3³ convs at the whole batch of every rank) times the window's steps, over
the window's time, as a share of the bf16 peak of the cards the cell ran
on, in %. A cell on several cards reads it as ``mfu.train.<cards>``."""

from benchmark import readers, yardstick


def read(run):
    if not run.units or readers.counted_model(run) is None:
        return None
    b, n = run.traffic["batch_size"], run.traffic["inputs"]["patch"]
    flops = len(run.units) * yardstick.step_flops(
        run.config["model_config"], b, n, counts_dir=readers.counts_dir(run))
    return 100.0 * flops / run.window_s / (
        yardstick.PEAK_BF16_FLOPS * run.world)
