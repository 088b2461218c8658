"""Host ms a volume in which the main thread waits on the pipeline's
reader thread for the next super-tile (the program's ``pipeline.wait``
spans, summed)."""

from benchmark import spans


def read(run):
    return spans.per_unit_ms(run, spans.span_seconds(run, ("pipeline.wait",)))
