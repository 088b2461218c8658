"""Device ms a volume in host-device copies (HtoD and DtoH memcpy)."""

from benchmark import trace


def read(run):
    if run.trace is None or not run.units:
        return None
    s = trace.device_seconds(run.trace, lambda n: n.startswith("Memcpy HtoD")
                             or n.startswith("Memcpy DtoH"))
    return 1e3 * s / len(run.units) if s > 0 else None
