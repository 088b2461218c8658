"""Rows 1-2 against their bound: the frozen bound of the forward convs of
every batch the window forwarded (counted by the program's launch
counter) over the device time of the conv and statistics-reduce kernels,
in %."""

from benchmark import readers, yardstick


def read(run):
    launches = run.counters.get("nb_conv3d.launches")
    if run.trace is None or not launches:
        return None
    model, width = readers.model_width(run)
    d = run.traffic["denoise"]
    batches = launches / readers.forwards_per_launch(run)
    bound = batches * yardstick.forward_conv_bound_s(
        model, d["batch_size"], d["patch_size"], width)
    dev = readers.conv_seconds(run, readers.conv_kernels(run))
    return readers.share(bound, dev)
