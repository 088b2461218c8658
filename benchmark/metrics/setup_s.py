"""Seconds from process start to the window's start: imports, CUDA, the
kernels' build or load, inputs and weights from the seed, warm-up."""


def read(run):
    return run.setup_s
