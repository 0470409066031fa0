"""Step timing for the logged metrics.

Port of ``StepTimer`` from ``workoutdetector_tpu/utils/profiling.py``.
It times on the host clock, so a step is timed to its end only where the
caller synchronises with the device (the trainer's metric fetch does).
"""

from __future__ import annotations

import time
from typing import Dict, Optional


class StepTimer:
    """Rolling step timing: tick() once per step; stats() gives steps/s and
    examples/s over the last ``window`` intervals."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list = []
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    def stats(self, batch_size: int = 1) -> Dict[str, float]:
        if not self._times:
            return {"steps_per_sec": 0.0, "examples_per_sec": 0.0}
        mean = sum(self._times) / len(self._times)
        return {"steps_per_sec": 1.0 / mean,
                "examples_per_sec": batch_size / mean}
