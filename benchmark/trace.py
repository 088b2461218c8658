"""Reduction of a ``torch.profiler`` trace of the window to what the
per-layer metrics read: the device's operations (kernels, copies,
memsets) with their times, the device's busy time (the union of their
intervals, so overlapping streams count once), the longest idle gaps of
the device with the host operation that was running in each, and the
benchmark's own spans (``record_function`` around its calls into each
layer)."""

from __future__ import annotations

from types import SimpleNamespace

import torch

_CUDA = torch.autograd.DeviceType.CUDA


def _events(prof):
    """``(device, host)``: device operations ``(start_us, end_us, name)``
    and host operations ``(start_us, end_us, name)`` on one clock."""
    dev, host = [], []
    evs = prof.profiler.kineto_results.events()
    for ev in evs:
        name = ev.name()
        a = ev.start_ns() / 1e3
        b = a + ev.duration_ns() / 1e3
        if ev.device_type() == _CUDA:
            if ev.is_user_annotation() or name.startswith("ProfilerStep"):
                continue
            dev.append((a, b, name))
        else:
            host.append((a, b, name))
    return dev, host


def union(intervals):
    """Merged ``[(a, b)]`` of µs intervals."""
    out = []
    for a, b, *_ in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def _host_at(host, t):
    """The innermost host operation running at ``t`` (µs)."""
    best = None
    for a, b, name in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, name)
    return best[2] if best else "(no host operation)"


def read(prof, window_s):
    dev, host = _events(prof)
    merged = union(dev)
    busy_us = sum(b - a for a, b in merged)
    by_name = {}
    for a, b, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])),
                  key=lambda g: g[0] - g[1])[:10]
    host.sort()
    idle = {}
    for a, b in gaps:
        name = _host_at(host, 0.5 * (a + b))
        idle[name] = idle.get(name, 0.0) + (b - a) / 1e6
    idle_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return SimpleNamespace(
        device=dev, host=host, busy_s=busy_us / 1e6, window_s=window_s,
        breakdown={"device_ops": [[n, s] for n, s in top],
                   "idle_gaps": [[n, s] for n, s in idle_top]})


def device_seconds(trace, match):
    """Σ seconds of the device operations whose name ``match`` accepts."""
    return sum(b - a for a, b, name in trace.device if match(name)) / 1e6

