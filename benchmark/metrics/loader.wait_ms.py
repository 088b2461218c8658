"""Host ms a step in which the main thread waits on the loader's producer
thread or worker processes for the next batch (the program's
``loader.wait`` spans, summed)."""

from benchmark import spans


def read(run):
    return spans.per_unit_ms(run, spans.span_seconds(run, ("loader.wait",)))
