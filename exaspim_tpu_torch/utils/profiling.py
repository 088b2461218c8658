"""Profiling and step observability.

Counterpart of ``exaspim_tpu/utils/profiling.py``:

* :func:`trace` — context manager around ``torch.profiler`` that writes a
  trace of the host and (on the card) the device into ``log_dir``, as
  ``<host>_<pid>.<timestamp>.pt.trace.json``: Chrome's ``about:tracing`` (or
  Perfetto) and TensorBoard's PyTorch profiler plugin load it.
* :func:`span` — a named span of the calling thread's time inside the
  pipeline, inference, the loader and the trainer, recorded into whichever
  ``torch.profiler`` session is running, beside the device's activity on
  one clock; one flag check when none is.
* :class:`StepTimer` — wall-clock step / throughput counters with EMA
  smoothing, reporting steps/s and voxels/s. The times are host clock
  between calls; on the card a step's time is its device time only where
  the caller synchronises (a loss read does).
* :func:`device_memory_stats` — device memory in use and its limit, per
  CUDA device, with the JAX package's keys.
* :func:`log_jsonl` — append one JSON record to a ``.jsonl`` file.

Nothing here touches the card at import.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["trace", "span", "StepTimer", "device_memory_stats", "log_jsonl"]

_NO_SPAN = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir, enabled=True):
    """Capture a ``torch.profiler`` trace (CPU, plus CUDA where a card is
    present) of the enclosed block into ``log_dir``; yields the profiler
    (``key_averages()`` for a table) or None when disabled, so call sites
    can leave it in production code."""
    if not enabled:
        yield None
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(log_dir))) \
            as prof:
        yield prof


def span(name):
    """A context that records the enclosed block as the span ``name`` in
    the running ``torch.profiler`` session (:func:`trace`, or any other):
    ``torch.profiler.record_function(name)``, whose host event shares the
    session's clock with the device's operations, so a span says what the
    host was doing while the device ran or idled. Spans nest.

    With no profiler running it returns one shared null context after a
    single flag check: a span costs nothing worth counting in production.
    A span entered before the profiler starts records nothing; one still
    open when it stops ends there. The profiler records only the threads it
    was started on, so spans go on the thread that launches the CUDA work,
    and a worker thread shows as that thread's wait on it."""
    if not torch._C._autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class StepTimer:
    """Step-time / throughput counters with exponential smoothing.

    >>> timer = StepTimer(voxels_per_step=32 * 64**3)
    >>> for batch in loader:
    ...     train_step(...)
    ...     stats = timer.step()
    """

    def __init__(self, voxels_per_step=None, ema=0.9):
        self.voxels_per_step = voxels_per_step
        self.ema = float(ema)
        self._last = None
        self._smoothed = None
        self.count = 0

    def step(self):
        """Mark one step; returns a stats dict (None on the first call)."""
        now = time.perf_counter()
        self.count += 1
        if self._last is None:
            self._last = now
            return None
        dt = now - self._last
        self._last = now
        self._smoothed = (
            dt if self._smoothed is None
            else self.ema * self._smoothed + (1 - self.ema) * dt
        )
        stats = {
            "step": self.count,
            "step_time_s": round(dt, 5),
            "step_time_ema_s": round(self._smoothed, 5),
            "steps_per_sec": round(1.0 / max(self._smoothed, 1e-9), 3),
        }
        if self.voxels_per_step:
            stats["voxels_per_sec"] = round(
                self.voxels_per_step / max(self._smoothed, 1e-9), 1
            )
        return stats


def device_memory_stats():
    """``{"cuda:<i>": {"bytes_in_use", "bytes_limit"}}`` for every CUDA
    device: the bytes the caching allocator holds for tensors and the
    card's total memory. Without a card, ``{"cpu": None}``: no device
    reports memory there, as the JAX package's CPU devices report none."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    out = {}
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": int(torch.cuda.memory_allocated(i)),
            "bytes_limit": int(torch.cuda.get_device_properties(i)
                               .total_memory),
        }
    return out


def log_jsonl(path, record):
    """Append one JSON record to a .jsonl file (shared logging helper)."""
    with open(path, "a") as f:
        f.write(json.dumps(record, default=float) + "\n")
