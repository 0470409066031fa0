"""Tracing and step timing.

Port of ``workoutdetector_tpu/utils/profiling.py``. JAX's
``jax.profiler`` traces become ``torch.profiler`` traces:

* ``trace(log_dir)`` profiles the enclosed block (CPU activity, and CUDA
  kernels and copies when a CUDA device is in use) and writes a Chrome
  trace ``<host>_<pid>.<ms>.pt.trace.json`` under ``log_dir``; open it in
  Perfetto (ui.perfetto.dev) or ``chrome://tracing``. The device is
  synchronised before the profiler stops, so no queued kernel is lost.
* ``Tracer`` is the same trace as start / step / stop calls, for a loop
  that opens and closes it between iterations (the trainer's
  ``log.profile_steps``): each ``step()`` closes one ``ProfilerStep#k``
  range and opens the next, so each traced iteration is one range. Its
  ``warmup`` first iterations run with the profiler prepared but not
  recording, so the device's activity tracing is up before the first
  recorded kernel (``torch.profiler.schedule``'s warm-up).
* ``annotate(name)`` names a region of the timeline
  (``torch.profiler.record_function``).
* ``StepTimer`` times steps on the host clock, so a step is timed to its
  end only where the caller synchronises with the device (the trainer's
  metric fetch does).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
import warnings
from typing import Dict, Iterator, Optional, Union

import torch


def _cuda_in_use(device) -> bool:
    if device is None:
        return torch.cuda.is_available() and torch.cuda.is_initialized()
    return torch.device(device).type == "cuda"


class Tracer:
    """A ``torch.profiler`` trace of the calls between ``start()`` and
    ``stop()``, written to ``log_dir`` as a Chrome trace, the first
    ``warmup`` steps left out. ``device`` (None: CUDA when this process has
    initialised CUDA) decides whether CUDA activity is recorded."""

    def __init__(self, log_dir: str,
                 device: Union[str, torch.device, None] = None,
                 warmup: int = 0):
        self.log_dir = log_dir
        self.cuda = _cuda_in_use(device)
        self.warmup = warmup
        self.prof: Optional[torch.profiler.profile] = None

    def start(self) -> "torch.profiler.profile":
        from torch.profiler import ProfilerAction, ProfilerActivity, profile
        os.makedirs(self.log_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.cuda:
            activities.append(ProfilerActivity.CUDA)
        # a schedule that records from step ``warmup`` on: only a scheduled
        # profiler marks its steps (ProfilerStep#k ranges)
        self.prof = profile(
            activities=activities,
            schedule=lambda step: ProfilerAction.WARMUP
            if step < self.warmup else ProfilerAction.RECORD)
        self.prof.start()
        return self.prof

    def step(self) -> None:
        """Close this iteration's ``ProfilerStep`` range, open the next."""
        self.prof.step()

    def stop(self) -> Optional[str]:
        """Synchronise the device, stop and write the trace; its path (None,
        and nothing written, when it stops in its warm-up)."""
        if self.cuda:
            torch.cuda.synchronize()
        prof, self.prof = self.prof, None
        if prof.step_num < self.warmup:
            with warnings.catch_warnings():  # "WARMUP followed by NONE"
                warnings.simplefilter("ignore")
                prof.stop()
            return None
        prof.stop()
        name = f"{socket.gethostname()}_{os.getpid()}." \
               f"{int(time.time() * 1000)}.pt.trace.json"
        path = os.path.join(self.log_dir, name)
        prof.export_chrome_trace(path)
        return path


@contextlib.contextmanager
def trace(log_dir: str, device: Union[str, torch.device, None] = None
          ) -> Iterator["torch.profiler.profile"]:
    """Trace the enclosed block into ``log_dir`` (module docstring); yields
    the profiler, whose ``events()`` the caller may read after the block."""
    tracer = Tracer(log_dir, device)
    prof = tracer.start()
    try:
        yield prof
    finally:
        tracer.stop()


def annotate(name: str):
    """A named region of the profiler's timeline."""
    return torch.profiler.record_function(name)


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
