"""Clip cutting: the [start_sec, end_sec) segments of videos, at 30 fps.

The port's own copy of ``workoutdetector_tpu/scripts/cut.py``: the
port's ``data/video.VideoReader`` decodes and ``write_video`` (cv2)
writes, resampled to the output rate as ffmpeg's ``fps=30`` filter does.

    python -m workoutdetector_tpu_torch.scripts.cut -i VIDEOS -o CUTS \
        --csv cuts.csv   # columns vid,start_sec,end_sec
"""

from __future__ import annotations

import argparse
import os
import os.path as osp

import numpy as np

from workoutdetector_tpu_torch.data.video import VideoReader, write_video


def cut_video(input_dir: str, vid: str, start_sec: float, end_sec: float,
              output_dir: str, fps: float = 30.0) -> str:
    """One clip → ``{output_dir}/{vid}_{start_sec}.mp4`` at ``fps``."""
    input_file = osp.join(input_dir, f"{vid}.mp4")
    os.makedirs(output_dir, exist_ok=True)
    output_file = osp.join(output_dir, f"{vid}_{start_sec}.mp4")
    with VideoReader(input_file) as r:
        src_fps = r.fps or fps
        frames = r.read_raw()
    s = int(start_sec * src_fps)
    e = min(int(end_sec * src_fps), len(frames))
    if e <= s:
        raise ValueError(f"empty cut [{start_sec}, {end_sec}) for {input_file}")
    # resampled to the output rate: a clip of another source rate written
    # frame for frame would change its duration
    n_out = max(1, int(round((e - s) * fps / src_fps)))
    idx = s + np.minimum(
        (np.arange(n_out) * src_fps / fps).astype(np.int64), e - s - 1)
    write_video(output_file, frames[idx], fps)
    return output_file


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Cut video clips from a csv")
    parser.add_argument("-i", "--input-dir", required=True)
    parser.add_argument("-o", "--output", required=True)
    parser.add_argument("--csv", required=True,
                        help="csv with columns vid,start_sec,end_sec")
    args = parser.parse_args(argv)
    import pandas as pd
    df = pd.read_csv(args.csv)
    for _, row in df.iterrows():
        cut_video(args.input_dir, row["vid"], row["start_sec"], row["end_sec"],
                  args.output)


if __name__ == "__main__":
    main()
