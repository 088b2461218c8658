"""Step observability: wall-clock step and throughput counters.

Copy of ``exaspim_tpu/utils/profiling.py:StepTimer``. The times are host
clock between calls; on the card a step's time is its device time only
where the caller synchronises (a loss read does).
"""

from __future__ import annotations

import time

__all__ = ["StepTimer"]


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
