"""Online streaming repetition counting.

Port of ``workoutdetector_tpu/infer/streaming.py``: frames stream in one
at a time, every ``window`` frames one device call scores the window, and
an incremental state machine (the transition rule of
``counting.pred_to_count``) updates the running count at once — the
engine behind live webcam counting.

``StreamingPeriodicCounter`` counts with the RepNet period model: a
rolling T-frame window scored every ``hop`` frames, the count the sum of
1/period over the newest frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from workoutdetector_tpu_torch.data.transforms import (center_crop,
                                                       resize_short_side)
from workoutdetector_tpu_torch.infer.engine import InferenceEngine
from workoutdetector_tpu_torch.infer.inference_count import \
    repnet_frame_logits_fn
from workoutdetector_tpu_torch.models.repnet import period_of_class


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
    """Frame-in, fractional-count-out online counter for the RepNet
    period family (models/repnet.py) — counting with NO state-classifier
    checkpoint, live.

    Keeps a rolling T-frame window (T = engine.num_segments); every
    ``hop`` new frames it scores the window once (the per-frame-logits
    call count_by_repnet uses) and accumulates
    count += Σ 1/period(t) over the NEWEST ``hop`` frames only, so
    overlapping windows never double-count a frame. ``rate`` decimates
    the incoming stream first: the model sees periods of 2..T/2 window
    frames, so at 30 fps and rate 4 it covers rep durations of ~0.3-4 s
    with the shipped T=64.

    Device work is one fixed-shape call per hop, padded to the engine's
    window_batch (a live engine or a ``.pt2`` artifact alike).
    """

    def __init__(self, engine: InferenceEngine, hop: Optional[int] = None,
                 scale: Optional[int] = None, rate: int = 1,
                 min_periodicity: float = 0.5):
        self.engine = engine
        self.t_win = engine.num_segments
        self.hop = max(1, hop or self.t_win // 2)
        if self.hop > self.t_win:
            raise ValueError(f"hop {self.hop} larger than the window "
                             f"{self.t_win}")
        # the offline counter's prep (count_by_repnet: read_prepped(S ·
        # 256 / 224, S), about the whole frame); a fixed 256 would crop a
        # 64-px model's input to the frame's centre
        self.scale = scale or round(engine.image_size * 256 / 224)
        self.rate = max(1, rate)
        self.min_periodicity = min_periodicity
        self._fn = repnet_frame_logits_fn(engine)
        self._buf: List[np.ndarray] = []  # rolling prepped window
        self._pending = 0  # prepped frames since the last scoring
        self._seen = 0  # raw frames pushed (for rate decimation)
        self._new = 0  # frames the next ingest() may count
        self.fractional = 0.0
        self.count = 0
        self.period_frames = 0  # latest median period, raw-frame units
        self.strength = 0.0  # latest window mean periodicity

    def prepare(self, frame_rgb: np.ndarray) -> Optional[np.ndarray]:
        """Prep + buffer one (H, W, 3) uint8 frame. Returns the
        (T, S, S, 3) window to score when a scoring is due (every
        hop·rate raw frames once warm), else None. Pair each returned
        window with exactly one ingest() of its frame logits — the split
        lets a server batch windows from many connections into one
        device call (the server's periodic batcher)."""
        self._seen += 1
        if (self._seen - 1) % self.rate:
            return None
        s = self.engine.image_size
        prepped = center_crop(resize_short_side(frame_rgb[None], self.scale),
                              s)[0]
        self._buf.append(prepped)
        if len(self._buf) > self.t_win:
            self._buf.pop(0)
        self._pending += 1
        if len(self._buf) < self.t_win or self._pending < self.hop:
            return None
        self._new = min(self._pending, self.t_win)  # 1st window counts all T
        self._pending = 0
        return np.stack(self._buf)

    def ingest(self, frame_logits: np.ndarray) -> Dict:
        """Apply one prepared window's (T, C) frame logits to the
        running count and return the status dict."""
        fl = np.asarray(frame_logits, np.float32)
        p = np.exp(fl - fl.max(-1, keepdims=True))
        p /= p.sum(-1, keepdims=True)
        periodic = 1.0 - p[:, 0]
        period_t = period_of_class(np.argmax(p[:, 1:], axis=-1) + 1)
        contrib = np.where(periodic >= self.min_periodicity,
                           1.0 / period_t, 0.0)
        self.fractional += float(contrib[-self._new:].sum())
        self.count = int(round(self.fractional))
        mask = periodic >= self.min_periodicity
        self.period_frames = int(np.median(period_t[mask])) * self.rate \
            if mask.any() else 0
        self.strength = float(periodic.mean())
        return {
            "count": self.count,
            "fractional": round(self.fractional, 2),
            "period_frames": self.period_frames,
            "strength": round(self.strength, 3),
        }

    def push(self, frame_rgb: np.ndarray) -> Optional[Dict]:
        """Direct path (demo/CLI/tests): prepare + one padded device
        call + ingest. Returns a status dict per scored window, else
        None."""
        window = self.prepare(frame_rgb)
        if window is None:
            return None
        wb = max(self.engine.window_batch, 1)
        s = self.engine.image_size
        chunk = np.zeros((wb, self.t_win, s, s, 3), np.uint8)
        chunk[0] = window
        out = self.engine.chunked_call(self._fn, chunk)
        return self.ingest(out[0])

    def reset(self) -> None:
        self._buf.clear()
        self._pending = 0
        self._seen = 0
        self._new = 0
        self.fractional = 0.0
        self.count = 0
        self.period_frames = 0
        self.strength = 0.0
