"""Person detection and the clip-consistent person crop, on the host.

Port of ``workoutdetector_tpu/data/person.py``. The default backend is
motion saliency: the person doing the workout is the moving subject, so
the bounding box of temporal-difference activity localizes them. The
``learned`` backend is the CenterNet of ``models/detector.py``
(``LearnedDetectorBackend``, on ``device``); any callable
(clip (T, H, W, 3) uint8 → list of (N_t, 4) boxes) slots in as well.

``PersonCrop`` matches the reference's (transform.py:226-262): one crop
for the whole clip from the union of the per-frame boxes, enlarged 10 %;
with no detection the clip is returned unchanged.
"""

from __future__ import annotations

import inspect
from typing import Callable, List, Optional, Union

import numpy as np
import torch


def _motion_boxes(clip: np.ndarray, quantile: float = 0.90,
                  min_area_frac: float = 0.001) -> List[np.ndarray]:
    """Per-frame motion bounding boxes from temporal differences.

    Returns a list of (N_t, 4) float arrays (N_t ∈ {0, 1}) in
    (x1, y1, x2, y2). The first frame reuses the first diff.
    """
    if clip.shape[0] < 2:
        return [np.zeros((0, 4), np.float32) for _ in range(clip.shape[0])]
    gray = clip.astype(np.int16).mean(axis=-1)  # (T, H, W)
    diffs = np.abs(np.diff(gray, axis=0))  # (T-1, H, W)
    h, w = gray.shape[1:]
    boxes: List[np.ndarray] = []
    for d in diffs:
        thresh = max(np.quantile(d, quantile), 8.0)
        mask = d >= thresh
        if mask.sum() < min_area_frac * h * w:
            boxes.append(np.zeros((0, 4), np.float32))
            continue
        ys, xs = np.nonzero(mask)
        boxes.append(
            np.asarray([[xs.min(), ys.min(), xs.max() + 1, ys.max() + 1]],
                       np.float32))
    return [boxes[0]] + boxes  # frame 0 reuses diff 0


def aggregate_motion_boxes(clip: np.ndarray,
                           window: int = 12,
                           k_sigma: float = 2.2,
                           floor_quantile: float = 0.9,
                           min_aspect: float = 1.0) -> List[np.ndarray]:
    """Temporally aggregated motion boxes from the motion-energy map.

    ``_motion_boxes`` thresholds each diff on its own, so codec shimmer
    spreads its box over most of a real frame; the subject's motion is
    coherent in time while the shimmer is not. Per frame:

      * sum |temporal diff| over the ±``window`` neighbours (prefix sums
        along T);
      * subtract the spatial ``floor_quantile`` of that energy map (the
        shimmer floor), clamping at 0;
      * box = the energy-weighted centroid ± ``k_sigma``·std per axis;
      * shape prior: a box flatter than ``min_aspect`` (height / width)
        grows in height, symmetrically, to it.

    Also the teacher of ``models/detector.distill_from_videos``. Same
    return contract as ``_motion_boxes``.
    """
    t = clip.shape[0]
    if t < 2:
        return [np.zeros((0, 4), np.float32) for _ in range(t)]
    gray = clip.astype(np.int16).mean(axis=-1).astype(np.float32)
    diffs = np.abs(np.diff(gray, axis=0))  # (T-1, H, W)
    h, w = gray.shape[1:]
    cum = np.concatenate([np.zeros((1, h, w), np.float32),
                          np.cumsum(diffs, axis=0)])  # (T, H, W)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out: List[np.ndarray] = []
    for i in range(t):
        lo = max(0, i - window)
        hi = min(t - 1, i + window)
        e = cum[hi] - cum[lo]
        e = np.maximum(e - np.quantile(e, floor_quantile), 0.0)
        tot = e.sum()
        if tot <= 0:
            out.append(np.zeros((0, 4), np.float32))
            continue
        cx = float((e * xs).sum() / tot)
        cy = float((e * ys).sum() / tot)
        sx = float(np.sqrt((e * (xs - cx) ** 2).sum() / tot))
        sy = float(np.sqrt((e * (ys - cy) ** 2).sum() / tot))
        bw, bh = 2 * k_sigma * sx, 2 * k_sigma * sy
        if bh < bw * min_aspect:
            bh = bw * min_aspect
        box = np.asarray([max(0.0, cx - bw / 2), max(0.0, cy - bh / 2),
                          min(float(w), cx + bw / 2),
                          min(float(h), cy + bh / 2)], np.float32)
        if box[2] <= box[0] or box[3] <= box[1]:
            out.append(np.zeros((0, 4), np.float32))
        else:
            out.append(box[None])
    return out


class Detector:
    """Per-frame person bounding boxes.

    Args:
        backend: 'motion' (default), 'motion-agg' (the motion-energy
            centroid ± k·σ with a shape prior, ``aggregate_motion_boxes``),
            'learned' (the CenterNet of ``models/detector.py``, loaded from
            ``checkpoint``: a JAX msgpack file or the port's own), or a
            callable (clip_u8 (T, H, W, 3)) → list of (N_t, 4) boxes.
        checkpoint: the 'learned' backend's weights.
        device: where the 'learned' backend runs, default ``"cuda"``; it
            raises without a card unless the caller names the CPU. The
            other backends run on the host and ignore it.
    """

    def __init__(self, backend: Union[str, Callable] = "motion",
                 checkpoint: Optional[str] = None,
                 device: Union[str, torch.device] = "cuda"):
        if backend == "motion":
            self._fn: Callable = _motion_boxes
        elif backend == "motion-agg":
            self._fn = aggregate_motion_boxes
        elif backend == "learned":
            from workoutdetector_tpu_torch.models.detector import \
                LearnedDetectorBackend
            if checkpoint is None:
                raise ValueError(
                    "backend='learned' needs a checkpoint path "
                    "(train one with models.detector.train_detector)")
            self._fn = LearnedDetectorBackend.load(checkpoint, device=device)
        else:
            self._fn = backend

    def detect(self, frames: np.ndarray,
               threshold: Optional[float] = None) -> List[np.ndarray]:
        """frames (T, H, W, 3) uint8 → list of (N_t, 4) box arrays.

        ``threshold``, the least detection confidence, goes only to a
        backend whose signature takes one (the learned backend): the
        motion backends give unscored boxes. The signature is read, not
        tried, so a backend's own TypeError is never taken for a missing
        parameter.
        """
        if threshold is not None:
            try:
                takes_threshold = "threshold" in \
                    inspect.signature(self._fn).parameters
            except (TypeError, ValueError):
                takes_threshold = False
            if takes_threshold:
                return self._fn(frames, threshold=threshold)
        return self._fn(frames)


class PersonCrop:
    """Clip-consistent person crop (reference transform.py:226-262): the
    union of each frame's best box, enlarged 10 %; the clip itself when
    nothing is detected."""

    def __init__(self, detector: Optional[Detector] = None):
        self.detector = detector or Detector()

    def __call__(self, clip: np.ndarray) -> np.ndarray:
        boxes = self.detector.detect(clip)
        firsts = [b[0] for b in boxes if len(b) > 0]
        if not firsts:
            return clip
        arr = np.stack(firsts)
        x1, y1 = float(arr[:, 0].min()), float(arr[:, 1].min())
        x2, y2 = float(arr[:, 2].max()), float(arr[:, 3].max())
        w, h = x2 - x1, y2 - y1
        if w * h <= 0:
            return clip
        x1 = int(max(0, x1 - w * 0.05))
        y1 = int(max(0, y1 - h * 0.05))
        x2 = int(min(clip.shape[2], x2 + w * 0.05))
        y2 = int(min(clip.shape[1], y2 + h * 0.05))
        if x2 <= x1 or y2 <= y1:
            return clip
        return clip[:, y1:y2, x1:x2]

    def __repr__(self) -> str:
        return self.__class__.__name__ + "()"
