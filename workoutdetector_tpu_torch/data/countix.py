"""Countix annotation layer.

Port of ``workoutdetector_tpu/data/countix.py`` (the reference's
``utils/common.py:154-250`` class Countix): the workouts-subset CSVs, video
paths, rep counts by YouTube id and, when extracted, the pose pickles.
The CSVs are read by ``data.repcount.read_csv`` (the standard library's
csv module, cells typed per column as pandas types them), so
``anno_all`` is a list of row dicts, each with its ``split``.
"""

from __future__ import annotations

import os.path as osp
import pickle
from typing import Any, Dict, List, Optional

from workoutdetector_tpu_torch.data.repcount import read_csv
from workoutdetector_tpu_torch.settings import DATA_ROOT, PROJ_ROOT


class Countix:
    """Countix workouts-subset annotations.

    CSV schema (datasets/Countix/workouts_{split}.csv):
        video_id, class, kinetics_start, kinetics_end,
        repetition_start, repetition_end, count
    """

    def __init__(self,
                 anno_root: Optional[str] = None,
                 data_root: Optional[str] = None,
                 load_pose: bool = False):
        self.anno_root = anno_root or osp.join(PROJ_ROOT, "datasets", "Countix")
        self.data_root = data_root or osp.join(DATA_ROOT, "Countix")
        self.anno_all: List[Dict[str, Any]] = []
        for split in ("train", "val"):
            self.anno_all += [dict(row, split=split)
                              for row in self.get_anno(split)]
        self.pose_data: Dict[str, Any] = self.load_pose() if load_pose else {}

    def get_anno(self, split: str = "train") -> List[Dict[str, Any]]:
        split = split.lower()
        if split not in ("train", "val"):
            raise ValueError(f"Invalid split: {split}. Must be train or val")
        return read_csv(osp.join(self.anno_root, f"workouts_{split}.csv"))

    def _row(self, video_id: str) -> Dict[str, Any]:
        for row in self.anno_all:
            if row["video_id"] == video_id:
                return row
        raise ValueError(f"Video {video_id} not found in annotation")

    def get_count(self, video_id: str) -> int:
        return int(self._row(video_id)["count"])

    def get_video(self, video_id: str) -> str:
        split = self._row(video_id)["split"]
        return osp.join(self.data_root, "videos", split, f"{video_id}.mp4")

    def load_pose(self) -> Dict[str, Any]:
        """Pose pickles {video_id: pose dict} where extracted
        (``scripts/pose.extract_dataset`` writes them; reference
        common.py:183-197)."""
        d: Dict[str, Any] = {}
        for split in ("train", "val"):
            path = osp.join(self.data_root, "pose", f"countix_{split}.pkl")
            if not osp.exists(path):
                continue
            with open(path, "rb") as f:
                poses = pickle.load(f)
            for pose in poses:
                name = pose["frame_dir"]
                try:
                    pose["count"] = self.get_count(name)
                except ValueError:
                    pass
                d[name] = pose
        return d

    def get_pose(self, video_id: str) -> Dict[str, Any]:
        if video_id not in self.pose_data:
            raise ValueError(f"Video {video_id} not found in pose data")
        return self.pose_data[video_id]

    def __repr__(self) -> str:
        return (f"Countix(anno_root={self.anno_root}, "
                f"len_anno_all={len(self.anno_all)})")
