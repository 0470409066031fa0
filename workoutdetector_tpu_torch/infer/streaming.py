"""Online streaming repetition counting.

Port of ``workoutdetector_tpu/infer/streaming.py``: frames stream in one
at a time, every ``window`` frames one device call scores the window, and
an incremental state machine (the transition rule of
``counting.pred_to_count``) updates the running count at once — the
engine behind live webcam counting.

``StreamingPeriodicCounter`` (the RepNet period family) comes with RepNet
(ROADMAP §1 item 6).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from workoutdetector_tpu_torch.data.transforms import (center_crop,
                                                       resize_short_side)
from workoutdetector_tpu_torch.infer.engine import InferenceEngine


class OnlineRepCounter:
    """Incremental pred_to_count: feed one state per chunk, read
    count/reps at any time. Matches counting.pred_to_count outputs exactly
    for the same prediction sequence."""

    def __init__(self, step: int = 8):
        self.step = step
        self.count = 0
        self.reps: List[int] = []
        self._last: Optional[int] = None
        self._run_start_idx = 0  # where the current run of identical preds began
        self._idx = -1
        self._preds: List[int] = []

    def push_state(self, pred: int) -> bool:
        """Add one per-chunk prediction. Returns True if a rep completed."""
        self._idx += 1
        self._preds.append(pred)
        if pred == -1:
            return False
        completed = False
        if self._last is not None and self._last != pred:
            if pred % 2 == 1 and self._last == pred - 1:
                self.count += 1
                self.reps.append(self._run_start_idx * self.step)
                self.reps.append(self._idx * self.step)
                completed = True
        self._last = pred
        if pred != self._preds[self._run_start_idx]:
            self._run_start_idx = self._idx
        return completed


class StreamingRepCounter:
    """Frame-in, count-out streaming counter.

    push(frame) buffers raw RGB frames; every ``window`` frames it preps
    (resize/center-crop), scores ONE window on the device, and advances the
    online state machine. Returns a status dict when a window was scored,
    else None.
    """

    def __init__(self, engine: InferenceEngine, window: int = 8,
                 scale: int = 256):
        self.engine = engine
        self.window = window
        self.scale = scale
        self.counter = OnlineRepCounter(step=window)
        self._buf: List[np.ndarray] = []
        self.states: List[int] = []

    def push(self, frame_rgb: np.ndarray) -> Optional[Dict]:
        """frame_rgb: (H, W, 3) uint8. Returns {'state', 'count', 'reps',
        'rep_completed', 'scores'} after every ``window``-th frame."""
        self._buf.append(frame_rgb)
        if len(self._buf) < self.window:
            return None
        clip = np.stack(self._buf)
        self._buf.clear()
        clip = center_crop(resize_short_side(clip, self.scale),
                           self.engine.image_size)
        scores = self.engine.score_windows(clip[None])[0]
        state = int(np.argmax(scores))
        self.states.append(state)
        completed = self.counter.push_state(state)
        return {
            "state": state,
            "count": self.counter.count,
            "reps": list(self.counter.reps),
            "rep_completed": completed,
            "scores": scores.tolist(),
        }

    def reset(self) -> None:
        self.counter = OnlineRepCounter(step=self.window)
        self._buf.clear()
        self.states.clear()


class StreamingPeriodicCounter:
    """The RepNet period family's live counter: not in the PyTorch port
    yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "StreamingPeriodicCounter counts with RepNet, which is not in "
            "the PyTorch port yet (ROADMAP §1 item 6)")
