"""Per-video person-box pipeline: detect → JSON; draw / crop videos.

Port of ``workoutdetector_tpu/scripts/bbox.py`` (the reference's
``scripts/bbox.py:24-161``) on the port's ``data.person.Detector``: the
motion backend by default, or ``--backend learned --checkpoint F`` (a
JAX msgpack file or the port's own) on ``--device`` (default cuda).

    python -m workoutdetector_tpu_torch.scripts.bbox json -i V.mp4 -o V.json
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from typing import List, Optional

import numpy as np

from workoutdetector_tpu_torch.data.person import Detector
from workoutdetector_tpu_torch.data.video import VideoReader, write_video


def bboxes_to_json(video_path: str, out_path: Optional[str] = None,
                   detector: Optional[Detector] = None) -> dict:
    """Detect per-frame person boxes → JSON
    {video, total_frames, boxes: [[x1,y1,x2,y2], ...] or [] per frame}."""
    detector = detector or Detector()
    with VideoReader(video_path) as r:
        frames = r.read_raw()
    boxes = detector.detect(frames)
    d = {
        "video": osp.basename(video_path),
        "total_frames": int(len(frames)),
        "boxes": [b[0].tolist() if len(b) else [] for b in boxes],
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(d, f)
    return d


def draw_boxes(video_path: str, out_path: str,
               detector: Optional[Detector] = None) -> None:
    """Render detected boxes onto the video."""
    import cv2
    detector = detector or Detector()
    with VideoReader(video_path) as r:
        fps = r.fps or 30.0
        frames = r.read_raw()
    boxes = detector.detect(frames)
    out = frames.copy()
    for f, b in zip(out, boxes):
        if len(b):
            x1, y1, x2, y2 = map(int, b[0])
            cv2.rectangle(f, (x1, y1), (x2, y2), (0, 255, 0), 2)
    write_video(out_path, out, fps)


def crop_and_save(video_path: str, out_path: str,
                  detector: Optional[Detector] = None,
                  size: int = 224) -> None:
    """Crop the clip-consistent person region and save resized video
    (reference bbox.py crop_and_save)."""
    from workoutdetector_tpu_torch.data.person import PersonCrop
    from workoutdetector_tpu_torch.data.transforms import resize_clip
    with VideoReader(video_path) as r:
        fps = r.fps or 30.0
        frames = r.read_raw()
    cropped = PersonCrop(detector)(frames)
    write_video(out_path, resize_clip(cropped, (size, size)), fps)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Person bbox pipeline")
    parser.add_argument("func", choices=["json", "draw", "crop"])
    parser.add_argument("-i", "--video", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--backend", default="motion",
                        choices=["motion", "motion-agg", "learned"])
    parser.add_argument("--checkpoint", default=None,
                        help="the learned backend's weights")
    parser.add_argument("--device", default="cuda",
                        help="the learned backend's device")
    args = parser.parse_args(argv)
    detector = Detector(backend=args.backend, checkpoint=args.checkpoint,
                        device=args.device)
    if args.func == "json":
        bboxes_to_json(args.video, args.output, detector)
    elif args.func == "draw":
        draw_boxes(args.video, args.output, detector)
    else:
        crop_and_save(args.video, args.output, detector)


if __name__ == "__main__":
    main()
