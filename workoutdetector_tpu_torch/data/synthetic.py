"""Synthetic person scenes, stick figures and a RepCount-shaped corpus.

Port of ``workoutdetector_tpu/data/synthetic.py``, line for line: numpy
and cv2 (pandas inside ``build_repcount_corpus``, which writes the CSV),
so that the same seed gives the same arrays, boxes, keypoints and files
as the JAX package's copy.

Fixtures for the person detector (``models/detector.py``), the person
crop and pose (``models/pose.py``): a textured "person" rectangle over a
textured background, optionally drifting across frames so the motion
baseline (``data/person.py``) has something to see; a COCO-17 stick
figure; and dark/bright rep videos for the dataset sweeps.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _background(rng: np.random.Generator, size: int) -> np.ndarray:
    """Smooth low-frequency color field + mild noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    phase = rng.uniform(0, 6.28, (3,))
    freq = rng.uniform(0.05, 0.15, (3,))
    img = np.stack([
        120 + 60 * np.sin(freq[c] * xx + phase[c]) *
        np.cos(freq[c] * 0.7 * yy)
        for c in range(3)
    ], axis=-1)
    img += rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _person_patch(rng: np.random.Generator, bh: int, bw: int) -> np.ndarray:
    """High-contrast striped patch — trivially separable from the smooth
    background by a learned model, but *static texture*, so only its
    motion is visible to the saliency baseline."""
    yy = np.arange(bh)[:, None]
    stripes = np.broadcast_to(((yy // max(2, bh // 8)) % 2) * 160 + 40,
                              (bh, bw))
    patch = np.repeat(stripes[..., None], 3, axis=-1).astype(np.float32)
    tint = rng.uniform(0.6, 1.4, (3,))
    patch = patch * tint
    patch += rng.normal(0, 10, (bh, bw, 3))
    return np.clip(patch, 0, 255).astype(np.uint8)


def person_scene(rng: np.random.Generator, size: int = 64, t: int = 8,
                 drift: float = 1.5) -> Tuple[np.ndarray, np.ndarray]:
    """One clip with one person.

    Returns:
        clip (t, size, size, 3) uint8, boxes (t, 4) float32 (x1,y1,x2,y2).
    """
    bh = int(rng.integers(size // 3, size // 2))
    bw = int(rng.integers(size // 5, size // 3))
    x = float(rng.integers(2, size - bw - 2))
    y = float(rng.integers(2, size - bh - 2))
    vx, vy = rng.uniform(-drift, drift, (2,))
    bg = _background(rng, size)
    patch = _person_patch(rng, bh, bw)
    frames, boxes = [], []
    for _ in range(t):
        f = bg.copy()
        xi = int(np.clip(x, 0, size - bw))
        yi = int(np.clip(y, 0, size - bh))
        f[yi:yi + bh, xi:xi + bw] = patch
        frames.append(f)
        boxes.append([xi, yi, xi + bw, yi + bh])
        x += vx
        y += vy
    return np.stack(frames), np.asarray(boxes, np.float32)


def person_dataset(n: int, size: int = 64, seed: int = 0
                   ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(N, size, size, 3) single frames + per-image (1, 4) gt boxes —
    detector training set."""
    rng = np.random.default_rng(seed)
    imgs, boxes = [], []
    for _ in range(n):
        clip, b = person_scene(rng, size=size, t=1, drift=0.0)
        imgs.append(clip[0])
        boxes.append(b[:1])
    return np.stack(imgs), boxes


def iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of two (4,) boxes."""
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(0.0, x2 - x1) * max(0.0, y2 - y1)
    area = ((a[2] - a[0]) * (a[3] - a[1]) +
            (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return float(inter / area) if area > 0 else 0.0


# ----------------------------------------------------------- pose fixtures

# COCO-17 canonical joint offsets within a unit body box (x, y), roughly
# anatomical: nose, eyes, ears, shoulders, elbows, wrists, hips, knees,
# ankles — enough geometric structure for a pose model to learn.
_COCO_UNIT = np.asarray([
    (0.50, 0.08), (0.46, 0.05), (0.54, 0.05), (0.40, 0.08), (0.60, 0.08),
    (0.32, 0.25), (0.68, 0.25), (0.22, 0.42), (0.78, 0.42),
    (0.18, 0.58), (0.82, 0.58), (0.40, 0.55), (0.60, 0.55),
    (0.38, 0.75), (0.62, 0.75), (0.36, 0.95), (0.64, 0.95),
], np.float32)

# distinct per-joint colors (a learnable appearance cue)
_JOINT_COLORS = ((np.arange(17)[:, None] * np.asarray([53, 97, 31]) + 60)
                 % 200 + 55).astype(np.uint8)


def pose_scene(rng: np.random.Generator, size: int = 128, t: int = 1,
               jitter: float = 0.02) -> Tuple[np.ndarray, np.ndarray]:
    """A stick figure with known COCO-17 keypoints.

    Returns:
        clip (t, size, size, 3) uint8, keypoints (t, 17, 2) float pixels.
    """
    bh = rng.uniform(0.55, 0.8) * size
    bw = bh * rng.uniform(0.4, 0.6)
    x0 = rng.uniform(0.05 * size, size - bw - 0.05 * size)
    y0 = rng.uniform(0.05 * size, size - bh - 0.05 * size)
    bg = _background(rng, size)
    r = max(2, int(size * 0.02))
    frames, kps_all = [], []
    for _ in range(t):
        f = bg.copy()
        kps = _COCO_UNIT + rng.normal(0, jitter, _COCO_UNIT.shape)
        kps = np.stack([x0 + kps[:, 0] * bw, y0 + kps[:, 1] * bh], axis=-1)
        yy, xx = np.mgrid[0:size, 0:size]
        for k, (kx, ky) in enumerate(kps):
            mask = (yy - ky) ** 2 + (xx - kx) ** 2 <= r ** 2
            f[mask] = _JOINT_COLORS[k]
        frames.append(f)
        kps_all.append(kps)
    return np.stack(frames), np.stack(kps_all).astype(np.float32)


def pose_dataset(n: int, size: int = 128, seed: int = 0
                 ) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(N, size, size, 3) frames + per-image (17, 2) keypoints."""
    rng = np.random.default_rng(seed)
    imgs, kps = [], []
    for _ in range(n):
        clip, k = pose_scene(rng, size=size, t=1)
        imgs.append(clip[0])
        kps.append(k[0])
    return np.stack(imgs), kps


# --------------------------------------------------------- RepCount corpus

# the helper's cleaned action list (reference repcount_dataset.py:163-166)
REPCOUNT_ACTIONS = ("situp", "push_up", "pull_up", "jump_jack", "squat",
                    "front_raise")

# per-action RGB tint so classes are visually distinct (multiplied into
# the two state brightnesses)
_ACTION_TINT = {
    "situp": (1.0, 0.9, 0.8), "push_up": (0.8, 1.0, 0.9),
    "pull_up": (0.9, 0.8, 1.0), "jump_jack": (1.0, 1.0, 0.8),
    "squat": (0.8, 1.0, 1.0), "front_raise": (1.0, 0.8, 1.0),
}


def repcount_video_frames(rng: np.random.Generator,
                          action: str,
                          n_reps: int,
                          size: int = 96) -> Tuple[np.ndarray, List[int]]:
    """One synthetic exercise video: reps alternate a dark 'start' state
    and a bright 'end' state (the two half-states the binary classifiers
    learn), with per-segment durations jittered so rep lengths vary, a
    dark lead-in/out, and pixel noise.

    Returns (frames (T, size, size, 3) uint8, reps [s1, e1, s2, e2, ...]
    in the reference's annotation convention)."""
    tint = np.asarray(_ACTION_TINT[action], np.float32)
    segs: List[np.ndarray] = []
    reps: List[int] = []
    t = 0

    def emit(n: int, level: float):
        nonlocal t
        base = np.full((n, size, size, 3), level, np.float32) * tint
        noise = rng.normal(0, 6, size=(n, size, size, 3)).astype(np.float32)
        segs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        t += n

    emit(int(rng.integers(4, 16)), 40.0)  # lead-in (dark = start state)
    for _ in range(n_reps):
        start = t
        # half-state durations sized like real RepCount reps (the shipped
        # pull-up annotation's mean rep is ~37 frames): a 16-frame sparse
        # scoring window then straddles at most one state transition
        emit(int(rng.integers(12, 27)), 40.0)   # start half-state
        emit(int(rng.integers(12, 27)), 220.0)  # end half-state
        reps.extend([start, t - 1])
    emit(int(rng.integers(4, 16)), 40.0)  # lead-out
    return np.concatenate(segs), reps


def build_repcount_corpus(root: str,
                          n_videos: int = 150,
                          splits: Tuple[Tuple[str, float], ...] = (
                              ("train", 0.1), ("val", 0.8), ("test", 0.1)),
                          size: int = 96,
                          zero_count_frac: float = 0.1,
                          seed: int = 0) -> "object":
    """Write a RepCount-shaped corpus: ``root/videos/<split>/<name>.mp4``
    plus ``root/annotation.csv`` in the reference's exact schema
    (index, class_, split, name, vid, start, end, count, reps — reference
    datasets/RepCount/annotation.csv).

    The corpus exists to drive the DATASET-SCALE scoring/eval machinery
    (wd-eval sharding, eval_count_shards merging, analyze_count, the
    reference's executing eval main) over hundreds of videos in-image —
    real RepCount media can't be fetched (zero egress). Returns the
    annotation DataFrame."""
    import os

    import cv2
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []
    idx = 0
    for split, frac in splits:
        os.makedirs(os.path.join(root, "videos", split), exist_ok=True)
        n_split = max(1, int(round(n_videos * frac)))
        for k in range(n_split):
            action = REPCOUNT_ACTIONS[idx % len(REPCOUNT_ACTIONS)]
            n_reps = 0 if rng.random() < zero_count_frac else \
                int(rng.integers(1, 9))
            frames, reps = repcount_video_frames(rng, action, n_reps,
                                                 size=size)
            name = f"{split}{idx}.mp4"
            path = os.path.join(root, "videos", split, name)
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                30, (size, size))
            for f in frames:
                w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
            w.release()
            rows.append({
                "class_": action, "split": split, "name": name,
                # 11 chars like a YouTube id, UNIQUE per video ('synthetic'
                # is 9 chars — slicing a zero-padded suffix to 11 would
                # collapse every row to 'synthetic00')
                "vid": f"syn{idx:08d}", "start": 0,
                "end": len(frames),
                "count": float(n_reps),
                "reps": " ".join(map(str, reps)),
            })
            idx += 1
    df = pd.DataFrame(rows)
    df.to_csv(os.path.join(root, "annotation.csv"))
    return df
