"""Rows 1-3 against their bound: the frozen bound of a step's forward,
dL/dx and dL/dW convs at one rank's share of the batch, times the steps
the program's dL/dW counter saw on the traced rank, over the device time
there of the conv, statistics-reduce and dL/dW kernels, in %. A cell on
several cards reads it as ``kernel.conv_roofline.train.<cards>``."""

from benchmark import readers, yardstick


def read(run):
    launches = run.counters.get("nb_conv3d_dw.launches")
    per = readers.forwards_per_launch(run)
    if run.trace is None or not launches or not per:
        return None
    steps = launches / per
    b = run.traffic["batch_size"] // run.world
    n = run.traffic["inputs"]["patch"]
    bound = steps * sum(yardstick.step_conv_bound_s(
        run.config["model_config"], b, n,
        counts_dir=readers.counts_dir(run)))
    return readers.share(bound, readers.conv_seconds(
        run, readers.conv_kernels(run)))
