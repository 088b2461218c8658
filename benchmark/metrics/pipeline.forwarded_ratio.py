"""Voxels forwarded through the model over output voxels: the program's
forward-conv launch counter, at a model forward's launches, times the
batch of patches, over the volumes' voxels. Halos, grid padding and the
last batches' filler slots all raise it."""

from benchmark import readers


def read(run):
    launches = run.counters.get("nb_conv3d.launches")
    per = readers.forwards_per_launch(run)
    if not launches or not per:
        return None
    d = run.traffic["denoise"]
    forwarded = launches / per * d["batch_size"] * d["patch_size"] ** 3
    return forwarded / sum(size for size, _ in run.units)
