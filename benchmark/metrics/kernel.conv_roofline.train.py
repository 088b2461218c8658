"""Rows 1-3 against their bound: the frozen bound of a step's forward,
dL/dx and dL/dW convs, times the steps the program's dL/dW counter saw,
over the device time of the conv, statistics-reduce and dL/dW kernels,
in %."""

from benchmark import readers, yardstick


def read(run):
    launches = run.counters.get("nb_conv3d_dw.launches")
    if run.trace is None or not launches:
        return None
    model, width = readers.model_width(run)
    steps = launches / readers.forwards_per_launch(run)
    b, n = run.traffic["batch_size"], run.traffic["inputs"]["patch"]
    bound = steps * sum(yardstick.step_conv_bound_s(model, b, n, width))
    dev = readers.conv_seconds(run, readers.conv_kernels(run))
    return readers.share(bound, dev)
