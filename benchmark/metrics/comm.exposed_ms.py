"""Device ms a step in which a collective's kernel ran on the traced rank
(rank 0) and no compute kernel did: the union of the NCCL kernels'
intervals less its intersection with the union of every other kernel's
(copies left out). The all-reduce hidden behind the backward is not
counted; None where no collective ran (one card)."""

from benchmark import readers, spans, trace


def read(run):
    found = readers.comm_intervals(run)
    if found is None:
        return None
    comm, compute = (trace.union(x) for x in found)
    exposed = sum(b - a for a, b in comm) - spans.overlap(comm, compute)
    return spans.per_unit_ms(run, exposed / 1e6)
