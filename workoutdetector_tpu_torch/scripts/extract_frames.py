"""Video → rawframe JPEG folders (``img_00001.jpg`` ...).

The port's own copy of ``workoutdetector_tpu/scripts/extract_frames.py``,
on the port's ``data/video.VideoReader`` (native libav where it loads,
else cv2) and cv2's JPEG writer.

    python -m workoutdetector_tpu_torch.scripts.extract_frames \
        -i VIDEOS -o RAWFRAMES
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

from workoutdetector_tpu_torch.data.video import VideoReader


def extract_video(video_path: str, out_dir: str,
                  tmpl: str = "img_{:05d}.jpg", quality: int = 95) -> int:
    """Every frame → ``{out_dir}/img_00001.jpg`` ... (1-based, the
    rawframe lists' template). Returns the frame count."""
    import cv2
    os.makedirs(out_dir, exist_ok=True)
    n = 0
    with VideoReader(video_path) as r:
        for frame in r.iter_raw():
            n += 1
            cv2.imwrite(osp.join(out_dir, tmpl.format(n)),
                        cv2.cvtColor(frame, cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, quality])
    return n


def extract_tree(video_root: str, out_root: str) -> None:
    """Every video under ``video_root/{split}/`` into
    ``out_root/{split}/{name}/``; a folder that already holds frames is
    left as it is."""
    for split in ("train", "val", "test"):
        d = osp.join(video_root, split)
        if not osp.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if not name.endswith((".mp4", ".webm", ".avi", ".mkv")):
                continue
            stem = name.rsplit(".", 1)[0]
            out = osp.join(out_root, split, stem)
            if osp.isdir(out) and os.listdir(out):
                continue
            extract_video(osp.join(d, name), out)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Extract rawframes")
    parser.add_argument("-i", "--video-root", required=True)
    parser.add_argument("-o", "--out-root", required=True)
    args = parser.parse_args(argv)
    extract_tree(args.video_root, args.out_root)


if __name__ == "__main__":
    main()
