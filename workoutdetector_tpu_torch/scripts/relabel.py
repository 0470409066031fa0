"""Relabel tooling: mpv screenshot timestamps → CSV → rawframe lists.

The port's own copy of ``workoutdetector_tpu/scripts/relabel.py``.
Annotators screenshot rep boundaries in mpv, whose file names carry the
video and the timestamp; this turns them into labelled frame lists at the
video's frame rate (pandas, imported by the function that reads the CSV).
"""

from __future__ import annotations

import os
import os.path as osp
from os.path import join as osj
from typing import List, Tuple


def process_screenshot(s: str) -> Tuple[str, float]:
    """mpv screenshot file name → (video name, seconds).

    >>> process_screenshot('stu2_48.mp4_00_00_09.943.png')
    ('stu2_48.mp4', 9.943)
    """
    assert s.endswith(".png")
    name, ts = s.split(".mp4")
    name = name.split("/")[-1] + ".mp4"
    ts = ts[1:-4]
    h, m, sec = float(ts[0:2]), float(ts[3:5]), float(ts[6:])
    return name, h * 3600 + m * 60 + sec


def name_to_png(vid: str, sec: float) -> str:
    """The inverse: video name and seconds → mpv screenshot file name."""
    # one integer millisecond count, so that rounding cannot disagree with
    # the h/m/s split (59.9997 s is 01_00.000, not 59.000)
    ms_total = round(sec * 1000)
    h, rem = divmod(ms_total, 3_600_000)
    m, rem = divmod(rem, 60_000)
    s, ms = divmod(rem, 1000)
    return f"{vid}_{h:02}_{m:02}_{s:02}.{ms:03}.png"


def screenshots_to_csv(path: str, csv_path: str, num_frame: int = 3) -> None:
    """A folder of mpv screenshots (train/val/test subfolders) → CSV rows
    ``name,sec,label,split``; consecutive triples are one rep's (start,
    mid, end), labelled 0, 1, 0."""
    assert os.path.isdir(path), f"{path} must be a dir"
    assert num_frame == 3, "num_frame must be 3"
    with open(csv_path, "w") as f:
        f.write("name,sec,label,split\n")
        for split in ("train", "val", "test"):
            d = osj(path, split)
            if not osp.isdir(d):
                continue
            shots = sorted(x for x in os.listdir(d) if x.endswith(".png"))
            for i, shot in enumerate(shots):
                name, sec = process_screenshot(shot)
                # the end frame of a triple is a class-0 (start-like) state
                label = 1 if i % num_frame == 1 else 0
                f.write(f"{name},{sec},{label},{split}\n")


def relabeled_csv_to_rawframe_list(csv_path: str,
                                   out_dir: str,
                                   video_fps: float = 30.0,
                                   num_segments_min: int = 2) -> None:
    """A CSV of (name, sec, label, split) → one 4-column rawframe list
    ``dir start length label`` per split, frame indices at ``video_fps``
    (1-based)."""
    import pandas as pd

    df = pd.read_csv(csv_path)
    os.makedirs(out_dir, exist_ok=True)
    for split in df["split"].unique():
        rows: List[str] = []
        ds = df[df["split"] == split].reset_index(drop=True)
        for name in ds["name"].unique():
            dv = ds[ds["name"] == name].sort_values("sec").reset_index(drop=True)
            # consecutive (start, mid, end) triples
            for i in range(0, len(dv) - 2, 3):
                s = int(dv.loc[i, "sec"] * video_fps) + 1  # frames are 1-based
                m = int(dv.loc[i + 1, "sec"] * video_fps) + 1
                e = int(dv.loc[i + 2, "sec"] * video_fps) + 1
                stem = name.split(".")[0]
                if m - s >= num_segments_min:
                    rows.append(f"{split}/{stem} {s} {m - s + 1} 0\n")
                if e - m >= num_segments_min:
                    rows.append(f"{split}/{stem} {m + 1} {e - m} 1\n")
        with open(osj(out_dir, f"{split}.txt"), "w") as f:
            f.writelines(rows)
