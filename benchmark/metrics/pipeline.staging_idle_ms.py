"""Device idle ms a volume while the host stages data: inside the
program's spans of the wait on the reader, the core's write into the
output, the host cast of a slab to float32, its upload and the result's
download (each instant counted once)."""

from benchmark import spans

STAGING = ("pipeline.wait", "pipeline.write", "inference.cast",
           "inference.upload", "inference.download")


def read(run):
    return spans.per_unit_ms(run, spans.idle_seconds_in(run, STAGING))
