"""RepCount dataset classes over rawframes.

The port's own copy of ``workoutdetector_tpu/data/repcount_datasets.py``
(``get_video_list``, ``RepcountImageDataset``, ``RepcountVideoDataset``,
``RepcountRecognitionDataset``): numpy uint8 items for the device feed,
frames sampled through the loader's generator.
"""

from __future__ import annotations

import os.path as osp
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.data.datasets import read_image
from workoutdetector_tpu_torch.data.repcount import ACTIONS, RepcountHelper
from workoutdetector_tpu_torch.data.sampling import sample_frames


def get_video_list(helper: RepcountHelper,
                   split: str,
                   action: Optional[str] = None,
                   max_reps: int = 2) -> List[dict]:
    """Each rep's two halves as binary-labelled spans: start → mid is
    label 0, mid → end label 1; 1-based frame indices; at most
    ``max_reps`` reps a video (all when < 1).

    ``action=None`` takes every class in the annotation csv (a split-only
    filter, as the reference's get_video_list), not the helper's six
    actions."""
    data = helper.get_rep_data(split=[split],
                               action=[action] if action else None)
    videos: List[dict] = []
    for item in data.values():
        if item.count <= 0:
            continue
        reps = item.reps[:max_reps * 2] if max_reps > 0 else item.reps
        for start, end in zip(reps[0::2], reps[1::2]):
            start, end = start + 1, end + 1  # frames are 1-indexed on disk
            mid = (start + end) // 2
            videos.append(dict(video_path=item.frames_path, start=start, end=mid,
                               length=mid - start + 1, class_=item.class_, label=0))
            videos.append(dict(video_path=item.frames_path, start=mid + 1, end=end,
                               length=end - mid, class_=item.class_, label=1))
    return videos


class RepcountImageDataset:
    """Binary image dataset: first-frame (0) vs mid-frame (1) of each rep
    for one action."""

    def __init__(self,
                 root: str,
                 action: str,
                 split: str = "train",
                 transform: Optional[Callable] = None,
                 anno_file: Optional[str] = None) -> None:
        if action not in ACTIONS:
            raise ValueError(f"{action} not in {ACTIONS}")
        helper = RepcountHelper(root, anno_file or osp.join(root, "annotation.csv"))
        data = helper.get_rep_data(split=[split], action=[action])
        self.images: List[str] = []
        self.labels: List[int] = []
        for item in data.values():
            if item.count <= 0:
                continue
            for start, end in zip(item.reps[0::2], item.reps[1::2]):
                start, end = start + 1, end + 1
                mid = (start + end) // 2
                self.images.append(osp.join(item.frames_path, f"img_{start:05}.jpg"))
                self.images.append(osp.join(item.frames_path, f"img_{mid:05}.jpg"))
                self.labels.extend([0, 1])
        self.transform = transform
        self.action = action

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        img = read_image(self.images[idx])[None]
        if self.transform is not None:
            img = self.transform(img, rng)
        return img, self.labels[idx]

    def __len__(self) -> int:
        return len(self.images)


class RepcountVideoDataset:
    """Binary video dataset over rep half-segments, 8-segment sampled."""

    def __init__(self,
                 root: str,
                 action: str,
                 num_segments: int = 8,
                 split: str = "train",
                 transform: Optional[Callable] = None,
                 filename_tmpl: str = "img_{:05}.jpg",
                 anno_file: Optional[str] = None,
                 is_test: bool = False) -> None:
        if action not in ACTIONS:
            raise ValueError(f"{action} not in {ACTIONS}")
        helper = RepcountHelper(root, anno_file or osp.join(root, "annotation.csv"))
        self.video_list = get_video_list(helper, split, action)
        self.num_segments = num_segments
        self.transform = transform
        self.tmpl = filename_tmpl
        self.random = not is_test

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        info = self.video_list[idx]
        samples = sample_frames(info["length"], self.num_segments, info["start"],
                                self.random, rng)
        clip = np.stack([
            read_image(osp.join(info["video_path"], self.tmpl.format(i)))
            for i in samples
        ])
        if self.transform is not None:
            clip = self.transform(clip, rng)
        assert clip.shape[0] == self.num_segments
        return clip, info["label"]

    def __len__(self) -> int:
        return len(self.video_list)


class RepcountRecognitionDataset:
    """Action classification over the full rep span reps[0]..reps[-1]."""

    def __init__(self,
                 root: str,
                 split: str,
                 actions: Optional[List[str]] = None,
                 num_segments: int = 8,
                 transform: Optional[Callable] = None,
                 filename_tmpl: str = "img_{:05}.jpg",
                 anno_file: Optional[str] = None,
                 is_test: bool = False) -> None:
        helper = RepcountHelper(root, anno_file or osp.join(root, "annotation.csv"))
        if actions is None:
            actions = helper.classes
        self.video_list = list(
            helper.get_rep_data(split=[split], action=actions).values())
        self.num_segments = num_segments
        self.transform = transform
        self.tmpl = filename_tmpl
        self.action_map: Dict[str, int] = {a: i for i, a in enumerate(actions)}
        self.random = not is_test

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        item = self.video_list[idx]
        if item.reps:
            rep_start, rep_end = item.reps[0], item.reps[-1]
        else:
            rep_start, rep_end = 0, max(item.total_frames - 1, 1)
        idx_list = sample_frames(max(rep_end - rep_start, 1), self.num_segments,
                                 offset=rep_start, random=self.random, rng=rng)
        clip = np.stack([
            read_image(osp.join(item.frames_path, self.tmpl.format(i + 1)))
            for i in idx_list
        ])
        if self.transform is not None:
            clip = self.transform(clip, rng)
        return clip, self.action_map[item.class_]

    def __len__(self) -> int:
        return len(self.video_list)
