"""Rows 1-2 against their bound: the frozen bound of the forward convs of
every batch the window forwarded (counted by the program's launch
counter) over the device time of the conv and statistics-reduce kernels,
in %."""

from benchmark import readers, yardstick


def read(run):
    launches = run.counters.get("nb_conv3d.launches")
    per = readers.forwards_per_launch(run)
    if run.trace is None or not launches or not per:
        return None
    d = run.traffic["denoise"]
    bound = launches / per * yardstick.forward_conv_bound_s(
        run.config["model_config"], d["batch_size"], d["patch_size"],
        counts_dir=readers.counts_dir(run))
    dev = readers.conv_seconds(run, readers.conv_kernels(run))
    return readers.share(bound, dev)
