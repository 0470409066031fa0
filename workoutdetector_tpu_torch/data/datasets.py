"""Datasets producing fixed-shape uint8 numpy items for the device feed.

The port's own copy of ``workoutdetector_tpu/data/datasets.py``
(``read_image``, the rawframe lists, ``FrameDataset``, ``TDNDataset``,
``ImageDataset``, ``SuperImageDataset``, ``DebugDataset``,
``build_dataset``). Items are ``(uint8 (T, H, W, 3) clip, int label)``
(TDN's: (T·5, H, W, 3) bursts), ``__getitem__(idx, rng)``
taking the loader's per-item generator; the normalize runs on the device.
JPEGs decode through the native libjpeg reader where it loads and take
cv2 where it does not (``data/jpeg.py``); cv2 is imported inside the
functions that use it.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, List, Optional, Tuple

import numpy as np

from workoutdetector_tpu_torch.data import jpeg as njpeg
from workoutdetector_tpu_torch.data.sampling import (sample_frames,
                                                     tdn_sample_indices)
from workoutdetector_tpu_torch.data.transforms import (TestTransform,
                                                       build_transform,
                                                       resize_clip)

# dataset_type → where the port will bring it (ROADMAP.md §1)
LATER = {
    "SyntheticPeriodic": "the RepNet slice (ROADMAP §1 item 6)",
}


def read_image(path: str) -> np.ndarray:
    """Read an image file → RGB uint8 (H, W, 3): JPEGs through the native
    libjpeg decoder, anything else (or a JPEG it refuses) through cv2."""
    img = njpeg.read_image(path)
    if img is not None:
        return img
    import cv2
    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)


def _prepped_params(transform) -> Optional[Tuple[int, int]]:
    """(scale, crop) when ``transform`` is a plain TestTransform whose
    geometry the native batch decoder can produce in the decode (resize
    short → scale, centre crop; no person crop), else None."""
    if (type(transform) is TestTransform and transform.person_crop is None
            and getattr(transform, "in_decoder", True)
            and transform.scale >= transform.size):
        return transform.scale, transform.size
    return None


def _read_clip(paths: List[str], transform, rng) -> np.ndarray:
    """Decode a clip: TestTransform geometry in one native batch decode
    where the library takes the files, else per-frame decode and the
    transform on the host."""
    prep = _prepped_params(transform)
    if prep is not None:
        out = njpeg.read_batch_prepped(paths, prep[0], prep[1])
        if out is not None:
            return out
    frames = np.stack([read_image(p) for p in paths])
    if transform is not None:
        frames = transform(frames, rng)
    return frames


def decoder_path(transform) -> str:
    """Which decode a rawframe dataset with ``transform`` takes for JPEG
    files: 'native prepped', 'native full' or 'cv2'."""
    if not njpeg.native_available():
        return "cv2"
    return "native prepped" if _prepped_params(transform) else "native full"


def _load_rawframe_anno(anno_path: str, data_prefix: str,
                        anno_col: int) -> List[dict]:
    """Parse 4-column ``dir start total label`` or 3-column ``dir total
    label`` rawframe lists (start index 1)."""
    infos: List[dict] = []
    with open(anno_path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if anno_col == 4:
                frame_dir, start_index, total_frames, label = parts
            else:
                frame_dir, total_frames, label = parts
                start_index = 1
            if data_prefix and int(total_frames) > 0:
                frame_dir = os.path.join(data_prefix, frame_dir)
            infos.append(
                dict(frame_dir=frame_dir,
                     start_index=int(start_index),
                     total_frames=int(total_frames),
                     label=int(label)))
    return infos


def _require_file(path: str) -> None:
    # AssertionError: the JAX package's exception for a missing list
    if not osp.isfile(path):
        raise AssertionError(f"{path} is not a file")


class FrameDataset:
    """Rawframe video dataset over ``dir [start] total label`` lists.
    Items are (num_segments, H, W, C) uint8 clips and their labels."""

    def __init__(self,
                 data_root: str,
                 anno_path: str,
                 data_prefix: Optional[str] = None,
                 num_segments: int = 8,
                 filename_tmpl: str = "img_{:05}.jpg",
                 transform: Optional[Callable] = None,
                 anno_col: int = 4,
                 is_test: bool = False) -> None:
        _require_file(anno_path)
        self.data_prefix = osp.join(data_root, data_prefix or "")
        self.transform = transform
        self.num_segments = num_segments
        self.tmpl = filename_tmpl
        self.anno = _load_rawframe_anno(anno_path, self.data_prefix, anno_col)
        self.random = not is_test

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        info = self.anno[idx]
        samples = sample_frames(info["total_frames"], self.num_segments,
                                info["start_index"], self.random, rng)
        frames = _read_clip(
            [osp.join(info["frame_dir"], self.tmpl.format(i)) for i in samples],
            self.transform, rng)
        assert frames.shape[0] == self.num_segments
        return frames, info["label"]

    def __len__(self) -> int:
        return len(self.anno)


class TDNDataset:
    """TDN burst dataset over the same rawframe lists: ``num_segments``
    burst starts (``tdn_sample_indices``), ``num_frames`` consecutive
    frames each, clamped inside the annotated span. Items are
    (num_segments · num_frames, H, W, C) uint8 clips and their labels."""

    def __init__(self,
                 data_root: str,
                 anno_path: str,
                 data_prefix: Optional[str] = None,
                 num_segments: int = 8,
                 num_frames: int = 5,
                 filename_tmpl: str = "img_{:05}.jpg",
                 transform: Optional[Callable] = None,
                 anno_col: int = 4,
                 is_test: bool = False) -> None:
        _require_file(anno_path)
        self.data_prefix = osp.join(data_root, data_prefix or "")
        self.transform = transform
        self.num_segments = num_segments
        self.num_frames = num_frames
        self.tmpl = filename_tmpl
        self.anno = _load_rawframe_anno(anno_path, self.data_prefix, anno_col)
        self.random = not is_test

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        info = self.anno[idx]
        total = info["total_frames"]
        starts = tdn_sample_indices(total, self.num_segments, self.num_frames,
                                    rng, self.random) + info["start_index"]
        last = info["start_index"] + total - 1
        paths = [osp.join(info["frame_dir"],
                          self.tmpl.format(min(int(i) + j, last)))
                 for i in starts for j in range(self.num_frames)]
        clip = _read_clip(paths, self.transform, rng)
        assert clip.shape[0] == self.num_segments * self.num_frames
        return clip, info["label"]

    def __len__(self) -> int:
        return len(self.anno)


class ImageDataset:
    """``path label`` image lists. Items are (1, H, W, C) uint8 clips, so
    the transforms are the videos' ones."""

    def __init__(self,
                 data_root: str,
                 data_prefix: Optional[str] = None,
                 anno_path: str = "train.txt",
                 transform: Optional[Callable] = None) -> None:
        _require_file(anno_path)
        self.data_prefix = osp.join(data_root, data_prefix or "")
        self.transform = transform
        self.anno: List[Tuple[str, int]] = []
        with open(anno_path) as f:
            for line in f:
                if line.strip():
                    name, class_ = line.strip().split()
                    self.anno.append((name, int(class_)))

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        path, label = self.anno[idx]
        img = _read_clip([osp.join(self.data_prefix, path)], self.transform,
                         rng)  # (1, H, W, C)
        return img, label

    def __len__(self) -> int:
        return len(self.anno)


class DebugDataset:
    """Synthetic constant-colour clips, pixel value 255 // (label + 1) as
    uint8: a learnable toy task that needs no files."""

    def __init__(self, num_class: int = 2, num_segments: int = 8,
                 size: int = 100, image_size: int = 224) -> None:
        self.num_class = num_class
        self.num_segments = num_segments
        self.size = size
        self.image_size = image_size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        label = idx % self.num_class
        x = np.full((self.num_segments, self.image_size, self.image_size, 3),
                    255 // (label + 1), dtype=np.uint8)
        return x, label


class SuperImageDataset:
    """'Super image' mosaic: ``num_image`` frames of a clip in a 3×3 (or
    2×2) grid, resized to ``image_size``, so that one image classifier
    sees the whole clip. Items are (image_size, image_size, C) uint8."""

    def __init__(self,
                 images: List[List[str]],
                 labels: List[int],
                 num_image: int = 9,
                 image_size: int = 224,
                 transform: Optional[Callable] = None) -> None:
        if num_image not in (4, 9):
            raise ValueError(f"num_image={num_image}. Only 4 or 9 supported")
        self.images = images
        self.labels = labels
        self.num_image = num_image
        self.image_size = image_size
        self.transform = transform

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                    ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng()
        paths = self.images[idx][:self.num_image]
        frames = np.stack([read_image(p) for p in paths])  # (N, H, W, C)
        if self.transform is not None:
            frames = self.transform(frames, rng)
        side = 3 if self.num_image == 9 else 2
        n, h, w, c = frames.shape
        grid = frames.reshape(side, side, h, w, c).transpose(0, 2, 1, 3, 4)
        grid = grid.reshape(side * h, side * w, c)
        grid = resize_clip(grid[None], (self.image_size, self.image_size))[0]
        return grid, self.labels[idx]

    def __len__(self) -> int:
        return len(self.labels)


def build_dataset(cfg, split: str):
    """The dataset ``cfg.dataset_type`` names for ``split`` (cfg:
    ``DataConfig``)."""
    if cfg.dataset_type == "DebugDataset":
        return DebugDataset(num_class=cfg.debug_num_class,
                            num_segments=cfg.num_segments,
                            size=cfg.debug_size, image_size=cfg.image_size)
    if cfg.dataset_type in LATER:
        raise NotImplementedError(
            f"dataset_type {cfg.dataset_type!r} ({split}) is not in the "
            f"PyTorch port yet: it comes with {LATER[cfg.dataset_type]}")
    if cfg.dataset_type not in ("FrameDataset", "TDNDataset", "ImageDataset"):
        raise KeyError(f"Dataset '{cfg.dataset_type}' is not supported.")
    is_test = split != "train"
    split_cfg = getattr(cfg, split)
    # the person crop is a test-pipeline transform, as in the JAX package
    if split_cfg.person_crop and is_test:
        raise NotImplementedError(
            f"person_crop on the {split} split is not in the PyTorch port "
            "yet: it needs the person detector (data/person.py, "
            "models/detector.py), ROADMAP §1 item 6")
    transform = build_transform(split, size=cfg.image_size,
                                scale=cfg.scale_size,
                                device_augment=cfg.device_augment,
                                native_prep=cfg.native_prep)
    if cfg.dataset_type == "FrameDataset":
        return FrameDataset(data_root=cfg.data_root,
                            anno_path=split_cfg.anno,
                            data_prefix=split_cfg.data_prefix,
                            num_segments=cfg.num_segments,
                            filename_tmpl=cfg.filename_tmpl,
                            transform=transform,
                            anno_col=cfg.anno_col,
                            is_test=is_test)
    if cfg.dataset_type == "TDNDataset":
        return TDNDataset(data_root=cfg.data_root,
                          anno_path=split_cfg.anno,
                          data_prefix=split_cfg.data_prefix,
                          num_segments=cfg.num_segments,
                          num_frames=cfg.num_frames,
                          filename_tmpl=cfg.filename_tmpl,
                          transform=transform,
                          anno_col=cfg.anno_col,
                          is_test=is_test)
    return ImageDataset(data_root=cfg.data_root,
                        data_prefix=split_cfg.data_prefix,
                        anno_path=split_cfg.anno,
                        transform=transform)
