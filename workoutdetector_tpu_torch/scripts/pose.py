"""Pose pipeline: extraction, keypoint-pickle IO and rendering.

Port of ``workoutdetector_tpu/scripts/pose.py`` (the reference's
``scripts/pose.py:35-162``: person detection + a top-down pose model →
(P, T, 17, 3) pickles): ``data.person.Detector`` localizes the person,
``models.pose.PoseEstimator`` estimates COCO-17 keypoints on the crop (on
its device, default cuda), and the results map back to frame
coordinates. The pickle schema is the JAX package's, key for key.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Any, Dict, List, Optional

import numpy as np


def inference_one_video(video_path: str,
                        pose_estimator: Optional[Any] = None,
                        pose_checkpoint: Optional[str] = None,
                        detector: Optional[Any] = None,
                        max_frames: int = 0,
                        device: str = "cuda") -> Dict[str, Any]:
    """Extract (P=1, T, 17, ·) keypoints for one video.

    Matches the reference's output dict (scripts/pose.py:35-162):
    frame_dir / keypoint (1, T, 17, 2) / keypoint_score (1, T, 17) /
    img_shape / total_frames.

    Args:
        pose_estimator: models/pose.PoseEstimator (or None to load from
            ``pose_checkpoint``, a JAX msgpack file or the port's own, on
            ``device``).
        detector: data/person.Detector for the person crop; None ⇒ full
            frame (single-subject workout videos).
        max_frames: truncate long videos (0 = all).
    """
    from workoutdetector_tpu_torch.data.video import VideoReader
    from workoutdetector_tpu_torch.models.pose import PoseEstimator

    if pose_estimator is None:
        if pose_checkpoint is None:
            raise ValueError(
                "need pose_estimator or pose_checkpoint (train one with "
                "models.pose.train_pose)")
        pose_estimator = PoseEstimator.load(pose_checkpoint, device=device)

    with VideoReader(video_path) as r:
        frames = r.read_raw()
    if max_frames:
        frames = frames[:max_frames]
    t, h, w = frames.shape[:3]

    x1 = y1 = 0
    x2, y2 = w, h
    if detector is not None:
        boxes = detector.detect(frames)
        firsts = [b[0] for b in boxes if len(b) > 0]
        if firsts:
            arr = np.stack(firsts)
            bw = arr[:, 2].max() - arr[:, 0].min()
            bh = arr[:, 3].max() - arr[:, 1].min()
            x1 = int(max(0, arr[:, 0].min() - 0.05 * bw))
            y1 = int(max(0, arr[:, 1].min() - 0.05 * bh))
            x2 = int(min(w, arr[:, 2].max() + 0.05 * bw))
            y2 = int(min(h, arr[:, 3].max() + 0.05 * bh))

    crop = frames[:, y1:y2, x1:x2]
    kp3 = pose_estimator.estimate_clip(crop)  # (T, 17, 3) in crop coords
    kp = kp3[..., :2] + np.asarray([x1, y1], np.float32)
    score = kp3[..., 2]
    return {
        "frame_dir": osp.splitext(osp.basename(video_path))[0],
        "keypoint": kp[None].astype(np.float32),        # (1, T, 17, 2)
        "keypoint_score": score[None].astype(np.float32),  # (1, T, 17)
        "img_shape": (h, w),
        "original_shape": (h, w),
        "total_frames": t,
        "video_path": video_path,
    }


def extract_dataset(video_paths: List[str], out_path: str,
                    pose_estimator: Optional[Any] = None,
                    pose_checkpoint: Optional[str] = None,
                    detector: Optional[Any] = None,
                    device: str = "cuda") -> List[Dict[str, Any]]:
    """Batch extraction → one pickle (the reference's per-split pkl)."""
    if pose_estimator is None and pose_checkpoint is not None:
        # load once, not once per video
        from workoutdetector_tpu_torch.models.pose import PoseEstimator
        pose_estimator = PoseEstimator.load(pose_checkpoint, device=device)
    items = [inference_one_video(p, pose_estimator=pose_estimator,
                                 detector=detector)
             for p in video_paths]
    with open(out_path, "wb") as f:
        pickle.dump(items, f)
    return items


def load_pose_pickle(path: str) -> List[Dict[str, Any]]:
    """Load a pose pickle: list of dicts with keys frame_dir, keypoint
    (P, T, 17, 2), keypoint_score (P, T, 17), img_shape, total_frames."""
    with open(path, "rb") as f:
        return pickle.load(f)


def render_pose_video(item: Dict[str, Any],
                      out_path: str,
                      video_path: Optional[str] = None,
                      thre: float = 0.5,
                      fps: float = 20.0) -> None:
    """Render one pose item to a skeleton video (reference gen_gif,
    utils/common.py:31-43)."""
    from workoutdetector_tpu_torch.utils.visualize import vis_2d_pose

    frames = None
    if video_path and osp.exists(video_path):
        from workoutdetector_tpu_torch.data.video import VideoReader
        with VideoReader(video_path) as r:
            frames = r.read_raw()
    kp = np.asarray(item["keypoint"])
    scores = np.asarray(item.get("keypoint_score")) if "keypoint_score" in item \
        else None
    vis_2d_pose(kp, scores, frames=frames,
                img_shape=tuple(item.get("img_shape", (480, 640))),
                thre=thre, out_path=out_path, fps=fps)
