"""Dataset construction: the Workouts merge, rep-state images, rep clips.

The port's own copy of ``workoutdetector_tpu/scripts/build_datasets.py``
on the port's video IO (``data/video.py``) and settings:

* ``build_workout`` merges RepCount (8 usable classes) and Countix (10)
  into the 11-class Workouts lists, with per-source prefixes and
  rawframe symlinks;
* ``build_image_rep`` writes rep-state images in the ImageFolder layout;
* ``build_video_rep`` cuts each annotated rep's halves into clips with
  Kinetics-style ``path label`` lists.

    python -m workoutdetector_tpu_torch.scripts.build_datasets build_workout
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from os.path import join as osj
from typing import Dict, List, Optional

from workoutdetector_tpu_torch.settings import (DATA_ROOT, PROJ_ROOT,
                                                WORKOUT_LABELS)

REPCOUNT_ACTIONS = ["situp", "push_up", "pull_up", "jump_jack", "squat",
                    "front_raise"]


def build_workout(data_root: Optional[str] = None,
                  repcount_classes_path: Optional[str] = None,
                  countix_classes_path: Optional[str] = None,
                  out_root: Optional[str] = None,
                  symlink: bool = True) -> None:
    """Merge RepCount (8 usable classes) and Countix (10) into the
    11-class Workouts dataset: remapped 3-column lists with per-source
    prefixes, and rawframe symlinks."""
    data_root = data_root or DATA_ROOT
    out_root = out_root or osj(data_root, "Workout", "rawframes")
    os.makedirs(out_root, exist_ok=True)
    classes = list(WORKOUT_LABELS)

    def read_classes(path: str) -> List[str]:
        with open(path) as f:
            return [ln.strip() for ln in f if ln.strip()]

    repcount_class = read_classes(repcount_classes_path or
                                  osj(PROJ_ROOT, "datasets/RepCount/classes.txt"))
    countix_class = read_classes(countix_classes_path or
                                 osj(PROJ_ROOT, "datasets/Countix/classes.txt"))

    repcount_keep = ["front_raise", "pull_up", "squat", "bench_pressing",
                     "jumping_jack", "situp", "push_up", "battle_rope"]
    repcount_map = {i: classes.index(x) for i, x in enumerate(repcount_class)
                    if x in repcount_keep}
    countix_to = ["exercising_arm", "bench_pressing", "front_raise", "squat",
                  "jumping_jack", "lunge", "mountain_climber", "pull_up",
                  "push_up", "situp"]
    countix_map = {i: classes.index(countix_to[i])
                   for i in range(len(countix_class))}

    def remap(label_map: Dict[int, int], prefix: str, input_txt: str,
              output_txt: str) -> None:
        if not osp.isfile(input_txt):
            return
        set_type = osp.basename(input_txt).split(".")[0]
        with open(input_txt) as f, open(output_txt, "w") as out:
            for line in f:
                parts = line.split()
                if len(parts) != 3:
                    continue
                path, length, label = parts
                i = int(label)
                if i not in label_map:
                    continue
                out.write(f"{prefix}/{set_type}/{path} {length} {label_map[i]}\n")

    merged: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for split in ("train", "val", "test"):
        rp_in = osj(data_root, "RepCount", "rawframes", f"{split}.txt")
        rp_out = osj(out_root, f"{split}_repcount.txt")
        remap(repcount_map, "RepCount", rp_in, rp_out)
        if osp.isfile(rp_out):
            merged[split].append(rp_out)
        if split != "test":  # Countix has no test split
            cx_in = osj(data_root, "Countix", "rawframes", f"{split}.txt")
            cx_out = osj(out_root, f"{split}_countix.txt")
            remap(countix_map, "Countix", cx_in, cx_out)
            if osp.isfile(cx_out):
                merged[split].append(cx_out)

    for split, files in merged.items():
        with open(osj(out_root, f"{split}.txt"), "w") as out:
            for fp in files:
                with open(fp) as f:
                    out.write(f.read())

    if symlink:
        for src_ds, splits in (("RepCount", ("train", "val", "test")),
                               ("Countix", ("train", "val"))):
            for split in splits:
                src = osj(data_root, src_ds, "rawframes", split)
                dst_dir = osj(out_root, src_ds)
                os.makedirs(dst_dir, exist_ok=True)
                dst = osj(dst_dir, split)
                if osp.isdir(src) and not osp.exists(dst):
                    os.symlink(osp.abspath(src), dst)


def build_image_rep(data_dir: Optional[str] = None,
                    anno_path: Optional[str] = None,
                    dest_dir: Optional[str] = None) -> None:
    """Rep-state image folders (ImageFolder layout): the first rep's end
    frame → class 2k, its middle frame → 2k+1."""
    import cv2
    import pandas as pd

    data_dir = data_dir or osj(DATA_ROOT, "RepCount", "videos")
    anno_path = anno_path or osj(DATA_ROOT, "RepCount", "annotation.csv")
    dest_dir = dest_dir or osj(DATA_ROOT, "RepCount", "rep_image")
    from workoutdetector_tpu_torch.data.video import VideoReader
    for split in ("train", "val", "test"):
        for i in range(len(REPCOUNT_ACTIONS) * 2):
            os.makedirs(osj(dest_dir, split, str(i)), exist_ok=True)
    anno = pd.read_csv(anno_path)
    for _, row in anno.iterrows():
        if row["class_"] not in REPCOUNT_ACTIONS or int(row["count"]) == 0:
            continue
        split = row["split"]
        video_path = osj(data_dir, split, row["name"])
        if not osp.isfile(video_path):
            continue
        reps = [int(x) for x in str(row["reps"]).split()]
        start_idx, end_idx = reps[0], reps[1]
        mid_idx = (start_idx + end_idx) // 2
        with VideoReader(video_path) as r:
            video = r.read_raw(max_frames=end_idx + 2)
        if len(video) <= mid_idx:
            continue
        name = row["name"].split(".")[0]
        cls = REPCOUNT_ACTIONS.index(row["class_"]) * 2
        cv2.imwrite(osj(dest_dir, split, str(cls), f"{name}.png"),
                    cv2.cvtColor(video[min(end_idx, len(video) - 1)],
                                 cv2.COLOR_RGB2BGR))
        cv2.imwrite(osj(dest_dir, split, str(cls + 1), f"{name}.png"),
                    cv2.cvtColor(video[mid_idx], cv2.COLOR_RGB2BGR))


def build_video_rep(data_dir: Optional[str] = None,
                    anno_path: Optional[str] = None,
                    dest_dir: Optional[str] = None) -> None:
    """Each annotated rep's two halves as clips, with Kinetics-style
    ``path label`` lists."""
    import pandas as pd

    from workoutdetector_tpu_torch.data.video import VideoReader, write_video

    data_dir = data_dir or osj(DATA_ROOT, "RepCount", "videos")
    anno_path = anno_path or osj(DATA_ROOT, "RepCount", "annotation.csv")
    dest_dir = dest_dir or osj(DATA_ROOT, "RepCount", "rep_video")
    handles = {}
    for split in ("train", "val", "test"):
        os.makedirs(osj(dest_dir, split), exist_ok=True)
        handles[split] = open(osj(dest_dir, f"{split}.csv"), "w")
    anno = pd.read_csv(anno_path)
    try:
        for _, row in anno.iterrows():
            if row["class_"] not in REPCOUNT_ACTIONS or int(row["count"]) == 0:
                continue
            split = row["split"]
            video_path = osj(data_dir, split, row["name"])
            if not osp.isfile(video_path):
                continue
            reps = [int(x) for x in str(row["reps"]).split()]
            with VideoReader(video_path) as r:
                fps = r.fps or 30.0
                video = r.read_raw()
            name = row["name"].split(".")[0]
            base_cls = REPCOUNT_ACTIONS.index(row["class_"]) * 2
            for k, (s, e) in enumerate(zip(reps[0::2], reps[1::2])):
                mid = (s + e) // 2
                for half, (a, b) in enumerate(((s, mid), (mid, e))):
                    if b <= a or b > len(video):
                        continue
                    out_name = f"{name}_{k}_{half}.mp4"
                    write_video(osj(dest_dir, split, out_name), video[a:b], fps)
                    handles[split].write(f"{split}/{out_name} {base_cls + half}\n")
    finally:
        for f in handles.values():
            f.close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("func", choices=["build_workout", "build_image_rep",
                                         "build_video_rep"])
    args = parser.parse_args(argv)
    globals()[args.func]()


if __name__ == "__main__":
    main()
