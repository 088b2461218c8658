"""Device ms a step in the collectives' kernels on the traced rank (rank
0): the data-parallel step's gradient all-reduce over NCCL, with the
time its kernel waits for the other ranks to join. None where no
collective ran (one card)."""

from benchmark import readers, spans, trace


def read(run):
    found = readers.comm_intervals(run)
    if found is None:
        return None
    s = trace.device_seconds(run.trace, readers.is_comm)
    return spans.per_unit_ms(run, s)
