"""Host ms a volume inside the program's ``rcan.attention`` spans, less
the time spent there inside the CUDA runtime's calls: what preparing
3D-RCAN's channel attentions costs the launching thread (Python, the
dispatcher, the small operations' set-up). The runtime's calls are left
out because a launch blocks in them while the device's queue is full, and
in this cell the convs keep it full: with them the number reads the
convs' back-pressure (about four fifths of the spans' time on an H100),
not the attentions. None for a model without the spans."""

from benchmark import spans
from benchmark import trace as trace_mod


def _runtime(name):
    """A CUDA runtime or driver call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...)."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def read(run):
    total = spans.span_seconds(run, ("rcan.attention",))
    if total is None:
        return None
    inside = trace_mod.union(
        [(a, b) for a, b, n in run.trace.host if n == "rcan.attention"])
    calls = trace_mod.union(
        [(a, b) for a, b, n in run.trace.host if _runtime(n)])
    return spans.per_unit_ms(run, total - spans.overlap(inside, calls) / 1e6)
