"""Cross-connection async batcher for serving.

Port of ``workoutdetector_tpu/serve/batcher.py`` (a copy). The reference
scores one 8-frame window per ONNX call per websocket
(app/inference.py:87-111). On the card a single window is a tiny batch
and every call pays its launches, so this batcher coalesces windows from
ALL live connections into one device call: requests are queued, and a
collector flushes when either ``max_batch`` windows are waiting or the
rolling ``max_delay_ms`` quiet window has passed since the last arrival
— deadline batching, giving near-single-request latency when idle and
full batches under load.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

log = logging.getLogger("workoutdetector_tpu_torch.serve")


class AsyncBatcher:
    """Deadline-based micro-batcher around a batched scoring function.

    The deadline is ROLLING: every arrival renews a ``max_delay_ms``
    quiet window (capped at ``stretch`` × the base delay from the first
    request), so a wave of staggered arrivals — e.g. per-connection
    decode threads finishing a few ms apart — coalesces into ONE device
    batch instead of splitting at the fixed deadline. An idle single
    request still flushes after exactly ``max_delay_ms``.

    Args:
        score_fn: (N, ...) uint8 → (N, num_class) — e.g.
            InferenceEngine.score_windows (handles padding internally).
        max_batch: flush threshold (windows).
        max_delay_ms: quiet window a request waits for company.
        stretch: hard cap on total wait, in units of max_delay_ms.
    """

    def __init__(self, score_fn: Callable[[np.ndarray], np.ndarray],
                 max_batch: int = 16, max_delay_ms: float = 10.0,
                 stretch: float = 4.0):
        self.score_fn = score_fn
        self.max_batch = max_batch
        self.max_delay = max_delay_ms / 1000.0
        self.stretch = stretch
        self._queue: "asyncio.Queue[Tuple[np.ndarray, asyncio.Future]]" = \
            asyncio.Queue()
        self._task: Optional[asyncio.Task] = None
        self.n_flushes = 0
        self.n_requests = 0
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        if self._task is not None and self._loop is loop and \
                self._task.done():
            # the collector crashed (surface it once, then rebuild) —
            # leaving _task set would wedge every future score() on a
            # queue nothing drains. KEEP the queue: pending
            # (window, future) pairs from other clients drain into the
            # fresh collector instead of awaiting forever.
            exc = self._task.exception() if not self._task.cancelled() \
                else None
            if exc is not None:
                log.error("batcher collector died: %r — restarting", exc)
            self._task = None
        if self._task is not None and self._loop is not loop:
            # the server was restarted on a new event loop: the old
            # collector (and its loop-bound queue futures) are dead —
            # rebuild both or every score() would await a future nothing
            # will resolve. cancel() on a task bound to a closed foreign
            # loop can raise (call_soon on a closed loop); the rebuild
            # must happen anyway
            try:
                self._task.cancel()
            except RuntimeError:
                pass
            self._task = None
            self._queue = asyncio.Queue()
        if self._task is None:
            self._loop = loop
            self._task = asyncio.create_task(self._collector())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def score(self, window: np.ndarray) -> np.ndarray:
        """Submit one window; returns its scores when the batch flushes."""
        await self.start()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self.n_requests += 1
        await self._queue.put((window, fut))
        return await fut

    async def _collector(self) -> None:
        while True:
            window, fut = await self._queue.get()
            batch: List[np.ndarray] = [window]
            futs: List[asyncio.Future] = [fut]
            first = time.monotonic()
            hard_deadline = first + self.max_delay * self.stretch
            deadline = min(first + self.max_delay, hard_deadline)
            while len(batch) < self.max_batch:
                timeout = deadline - time.monotonic()
                if timeout <= 0:
                    break
                try:
                    w, f = await asyncio.wait_for(self._queue.get(), timeout)
                    batch.append(w)
                    futs.append(f)
                    # rolling quiet window, capped by the hard deadline
                    deadline = min(time.monotonic() + self.max_delay,
                                   hard_deadline)
                except asyncio.TimeoutError:
                    break
            arr = np.stack(batch)
            loop = asyncio.get_running_loop()
            try:
                # run the device call off-thread so the event loop stays live
                scores = await loop.run_in_executor(None, self.score_fn, arr)
                self.n_flushes += 1
                for i, f in enumerate(futs):
                    if not f.done():
                        f.set_result(scores[i])
            except Exception as e:  # propagate to all waiters
                for f in futs:
                    if not f.done():
                        f.set_exception(e)
