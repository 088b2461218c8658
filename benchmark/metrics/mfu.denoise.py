"""Model FLOPs of the cell's patch plan (the streamed volume's slab
tiling at the cell's parameters, frozen in the benchmark: a program that
forwards fewer patches reads higher) for every volume of the window, over
the window's time, as a share of the card's bf16 peak, in %."""

from benchmark import readers, yardstick


def read(run):
    if not run.units or readers.counted_model(run) is None:
        return None
    d = run.traffic["denoise"]
    shape = run.traffic["inputs"]["shape"]
    patches = yardstick.streamed_patches(shape, d["slab_z"], d["patch_size"],
                                         d["overlap"], d["batch_size"])
    flops = len(run.units) * yardstick.forward_flops(
        run.config["model_config"], patches, d["patch_size"],
        counts_dir=readers.counts_dir(run))
    return 100.0 * flops / run.window_s / yardstick.PEAK_BF16_FLOPS
