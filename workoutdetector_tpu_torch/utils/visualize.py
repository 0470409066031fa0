"""Visualization: rep-segmentation plots, score curves, pose rendering.

Port of ``workoutdetector_tpu/utils/visualize.py`` (the reference's
``plot_pred``, ``plot_all`` and ``Vis2DPose``): video IO through the
port's ``data.video``, figures in matplotlib (imported inside the plotting
functions), pose overlays drawn with cv2 (imported inside
``vis_2d_pose``). Nothing here runs on the card.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from workoutdetector_tpu_torch.counting import pred_to_count, scores_to_preds

CLASSES = ["situp", "push_up", "pull_up", "jump_jack", "squat", "front_raise"]

# COCO-17 keypoint skeleton (pairs of keypoint indices)
COCO_PAIRS = [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
              (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
              (14, 16)]


def plot_pred(result: Sequence[int],
              gt: Sequence[int],
              total_frames: int,
              info: Dict[str, Any],
              step: int = 8,
              out_path: Optional[str] = None) -> None:
    """Two-lane segmentation plot: gt rep spans on top, predictions below
    (reference visualize.py:18-53)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(8, 2))
    plt.xlabel("Frame index")
    plt.yticks([])
    plt.ylim(0, 1)
    plt.xlim(0, max(total_frames, 1))
    for i in range(0, len(gt) - 1, 2):
        plt.gca().add_patch(
            plt.Rectangle((gt[i], 0.5), gt[i + 1] - gt[i], 0.5,
                          color=["C5", "C4"][i % 4 // 2]))
    for j in range(0, len(result) - 1, 2):
        plt.gca().add_patch(
            plt.Rectangle((result[j], 0.0), result[j + 1] - result[j], 0.49,
                          color=["C0", "C2"][j % 4 // 2]))
    plt.title(f'{info.get("video_name", "?")}, {info.get("action", "?")}, '
              f'count={len(gt) // 2}, Up: ground truth, Down: prediction')
    if out_path:
        plt.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close()
    else:
        plt.show()


def plot_score_json(json_path: str,
                    out_path: Optional[str] = None,
                    threshold: float = 0.5,
                    softmax: bool = True,
                    step: int = 8) -> Dict[str, Any]:
    """Score-vs-frame curves with gt rep bars for one ``.score.json``
    (reference plot_all per-video panel, visualize.py:56-137)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with open(json_path) as f:
        info = json.load(f)
    scores = info["scores"]
    frames = sorted(scores, key=int)
    classes = sorted(scores[frames[0]], key=int) if frames else []
    mat = np.asarray([[scores[f][c] for c in classes] for f in frames])
    preds = scores_to_preds(scores, threshold=threshold, softmax=softmax)
    count, reps = pred_to_count(preds, step=step)

    fig, (ax1, ax2) = plt.subplots(2, 1, figsize=(10, 4), sharex=True,
                                   height_ratios=[3, 1])
    x = np.asarray([int(f) for f in frames])
    for ci, c in enumerate(classes):
        ax1.plot(x, mat[:, ci], label=f"class {c}", lw=1)
    ax1.legend(fontsize=6, ncol=4)
    ax1.set_ylabel("score")
    gt = info.get("ground_truth", [])
    for i in range(0, len(gt) - 1, 2):
        ax2.add_patch(plt.Rectangle((gt[i], 0.5), gt[i + 1] - gt[i], 0.5,
                                    color="C4"))
    for j in range(0, len(reps) - 1, 2):
        ax2.add_patch(plt.Rectangle((reps[j], 0.0), reps[j + 1] - reps[j], 0.49,
                                    color="C2"))
    ax2.set_ylim(0, 1)
    ax2.set_yticks([])
    ax2.set_xlabel("frame")
    ax1.set_title(f'{info.get("video_name")}, {info.get("action")}, '
                  f'gt={len(gt) // 2} pred={count}')
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=120)
        plt.close(fig)
    return {"count": count, "reps": reps, "gt": gt}


def plot_all(json_dir: str, out_dir: str, threshold: float = 0.5,
             softmax: bool = True) -> None:
    """Render plots for every score json in a directory."""
    os.makedirs(out_dir, exist_ok=True)
    for f in sorted(os.listdir(json_dir)):
        if f.endswith(".json"):
            plot_score_json(os.path.join(json_dir, f),
                            os.path.join(out_dir, f.replace(".json", ".png")),
                            threshold=threshold, softmax=softmax)


def vis_3d_pose(keypoints: np.ndarray,
                pairs: Optional[Sequence[tuple]] = None,
                out_path: Optional[str] = None,
                fps: float = 20.0,
                figsize: int = 4) -> np.ndarray:
    """Render 3D skeleton sequences to frames (reference Vis3DPose,
    visualize.py:283-323; matplotlib 3D instead of moviepy).

    Args:
        keypoints: (P, T, K, 3) xyz joints.
    Returns:
        (T, H, W, 3) uint8 frames (also written as video if out_path).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    kp = np.asarray(keypoints, np.float32)
    if kp.ndim == 3:
        kp = kp[None]
    pairs = pairs if pairs is not None else COCO_PAIRS
    p, t = kp.shape[:2]
    lo, hi = kp.reshape(-1, 3).min(0), kp.reshape(-1, 3).max(0)
    frames = []
    for ti in range(t):
        fig = plt.figure(figsize=(figsize, figsize))
        ax = fig.add_subplot(111, projection="3d")
        ax.set_xlim(lo[0], hi[0]); ax.set_ylim(lo[1], hi[1])
        ax.set_zlim(lo[2], hi[2])
        for pi in range(p):
            pts = kp[pi, ti]
            for a, b in pairs:
                if a < len(pts) and b < len(pts):
                    ax.plot(*zip(pts[a], pts[b]), c="g", lw=1.5)
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="r", s=8)
        ax.axis("off")
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(buf.copy())
        plt.close(fig)
    out = np.stack(frames)
    if out_path:
        from workoutdetector_tpu_torch.data.video import write_video
        write_video(out_path, out, fps)
    return out


def vis_2d_pose(keypoints: np.ndarray,
                keypoint_scores: Optional[np.ndarray] = None,
                frames: Optional[np.ndarray] = None,
                img_shape: Optional[tuple] = None,
                thre: float = 0.5,
                out_path: Optional[str] = None,
                fps: float = 20.0) -> np.ndarray:
    """Render COCO-17 skeletons onto frames (reference Vis2DPose,
    visualize.py:168-280; cv2 drawing instead of matplotlib+moviepy).

    Args:
        keypoints: (P, T, 17, 2) or (P, T, 17, 3) (x, y[, score]).
        keypoint_scores: (P, T, 17) if not packed into keypoints.
        frames: (T, H, W, 3) uint8 background (black canvas if None).
    Returns:
        (T, H, W, 3) uint8 rendered frames (also written if out_path).
    """
    import cv2
    kp = np.asarray(keypoints, np.float32)
    if kp.ndim == 3:
        kp = kp[None]
    if kp.shape[-1] == 3 and keypoint_scores is None:
        keypoint_scores = kp[..., 2]
        kp = kp[..., :2]
    p, t = kp.shape[:2]
    if frames is None:
        h, w = img_shape if img_shape else (
            int(kp[..., 1].max()) + 20, int(kp[..., 0].max()) + 20)
        frames = np.zeros((t, h, w, 3), np.uint8)
    out = frames[:t].copy()
    for ti in range(min(t, len(out))):
        img = out[ti]
        for pi in range(p):
            pts = kp[pi, ti]
            sc = keypoint_scores[pi, ti] if keypoint_scores is not None else \
                np.ones(len(pts))
            for a, b in COCO_PAIRS:
                if sc[a] >= thre and sc[b] >= thre:
                    cv2.line(img, (int(pts[a, 0]), int(pts[a, 1])),
                             (int(pts[b, 0]), int(pts[b, 1])), (0, 255, 0), 2)
            for ki in range(len(pts)):
                if sc[ki] >= thre:
                    cv2.circle(img, (int(pts[ki, 0]), int(pts[ki, 1])), 3,
                               (255, 0, 0), -1)
    if out_path:
        from workoutdetector_tpu_torch.data.video import write_video
        write_video(out_path, out, fps)
    return out
