"""Datasets producing fixed-shape uint8 numpy items for the device feed.

The port's own copy of ``workoutdetector_tpu/data/datasets.py``
(``read_image``, the rawframe lists, ``FrameDataset``, ``TDNDataset``,
``ImageDataset``, ``SuperImageDataset``, ``DebugDataset``,
``synth_periodic_clip``, ``SyntheticPeriodicDataset``, ``build_dataset``). Items are ``(uint8 (T, H, W, 3) clip, int label)``
(TDN's: (T·5, H, W, 3) bursts), ``__getitem__(idx, rng)``
taking the loader's per-item generator; the normalize runs on the device.
JPEGs decode through the native libjpeg reader where it loads and take
cv2 where it does not (``data/jpeg.py``); cv2 is imported inside the
functions that use it.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Callable, List, Optional, Tuple, Union

import numpy as np
import torch

from workoutdetector_tpu_torch.data import jpeg as njpeg
from workoutdetector_tpu_torch.data.sampling import (sample_frames,
                                                     tdn_sample_indices)
from workoutdetector_tpu_torch.data.transforms import (TestTransform,
                                                       build_transform,
                                                       resize_clip)

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


def synth_periodic_clip(rng: np.random.Generator,
                        length: int,
                        image_size: int,
                        period: int = 0,
                        mode: Optional[str] = None,
                        kind: Optional[str] = None) -> np.ndarray:
    """Render one synthetic motion clip → (length, S, S, 3) uint8.

    One rectangular "actor" moves over a noisy constant background with
    0-2 static distractor squares and handheld-style camera jitter.
    period ≥ 2 ⇒ sinusoidal repetition of that period with a motion
    ``kind`` (random when None) chosen to span how real exercise looks
    at low resolution:

      translate — whole-body displacement (jumping jacks, pull-ups)
      squash    — height compresses about a fixed bottom edge, width
                  anti-phase (squats, push-ups)
      scale     — approach/retreat about the center
      swing     — rotation of the actor about an off-body pivot (arm
                  curls, leg raises)

    (A periodic-brightness 'flash' kind was measured HARMFUL on real
    footage: it teaches appearance periodicity, and codec/sensor flicker
    then reads as fast reps — a squat video counted 3→23 at a 0.5 s
    period. Brightness variation appears only as a NEGATIVE.)

    period 0 ⇒ an aperiodic negative from ``mode`` ∈ {static, drift,
    walk, scalewalk, flicker} (random when None) — the class-0 clips.
    Negatives get the same camera jitter/distractors so structural
    periodicity is the only separating signal; 'flicker' (random
    brightness jumps on a static actor) explicitly maps appearance
    noise to class 0.
    """
    s = image_size
    bg = rng.integers(0, 256, size=3)
    color = (bg + 96 + rng.integers(0, 64, size=3)) % 256
    side = int(rng.integers(max(s // 6, 2), max(s // 3, 3)))
    lo, hi = 0.0, float(s - side)
    c0 = (lo + hi) / 2.0
    amp = rng.uniform(0.5, 0.96) * (hi - lo) / 2.0
    t = np.arange(length, dtype=np.float32)
    # defaults: fixed position/size/brightness, overridden per kind
    px = py = np.full_like(t, c0)
    w_t = np.full_like(t, float(side))
    h_t = np.full_like(t, float(side))
    gain = np.ones_like(t)
    if period >= 2:
        phase = rng.uniform(0, 2 * np.pi)
        wave = np.sin(2 * np.pi * t / period + phase)
        kind = kind or str(rng.choice(
            ["translate", "squash", "scale", "swing"]))
        if kind == "translate":
            axis = rng.choice(["x", "y", "xy"])
            if axis == "xy":  # circular motion
                px = c0 + amp * wave
                py = c0 + amp * np.sin(2 * np.pi * t / period + phase
                                       + np.pi / 2)
            elif axis == "x":
                px = c0 + amp * wave
            else:
                py = c0 + amp * wave
        elif kind == "squash":
            # height oscillates about a FIXED bottom edge, width
            # anti-phase — a squatting silhouette
            depth = rng.uniform(0.35, 0.65)
            h_t = side * (1.0 - depth * (0.5 + 0.5 * wave))
            w_t = side * (1.0 + 0.5 * depth * (0.5 + 0.5 * wave))
            py = (c0 + side) - h_t  # bottom edge pinned at c0 + side
            px = c0 + (side - w_t) / 2.0
        elif kind == "scale":
            g = 1.0 + rng.uniform(0.3, 0.6) * wave
            w_t, h_t = side * g, side * g
            px, py = c0 + (side - w_t) / 2.0, c0 + (side - h_t) / 2.0
        else:  # swing
            r = rng.uniform(0.5, 0.9) * (hi - lo) / 2.0
            th0 = rng.uniform(0, 2 * np.pi)
            swing = rng.uniform(0.6, 1.4) * wave  # radians
            px = c0 + r * np.cos(th0 + swing)
            py = c0 + r * np.sin(th0 + swing)
    else:
        mode = mode or str(rng.choice(["static", "drift", "walk",
                                       "scalewalk", "flicker"]))
        if mode == "static":
            pass
        elif mode == "drift":
            px = lo + (hi - lo) * t / max(length - 1, 1)
        elif mode == "scalewalk":  # aperiodic size change
            g = np.clip(1.0 + np.cumsum(rng.normal(0, 0.04, length)),
                        0.4, 1.8)
            w_t, h_t = side * g, side * g
            px, py = c0 + (side - w_t) / 2.0, c0 + (side - h_t) / 2.0
        elif mode == "flicker":  # appearance noise on a static actor
            gain = np.clip(1.0 + rng.normal(0, 0.25, length), 0.4, 1.6)
        else:  # random walk, step scale ~ the periodic case's speed
            steps = rng.normal(0.0, amp / 6.0, size=(2, length))
            px = np.clip(c0 + np.cumsum(steps[0]), lo, hi)
            py = np.clip(c0 + np.cumsum(steps[1]), lo, hi)
    # handheld camera jitter: bounded random walk applied to EVERYTHING
    jit = np.clip(np.cumsum(rng.normal(0, 0.35, size=(2, length)), axis=1),
                  -2.0, 2.0)
    # static distractors (jitter with the camera, never periodic)
    distractors = []
    for _ in range(int(rng.integers(0, 3))):
        d_side = int(rng.integers(max(s // 8, 2), max(s // 5, 3)))
        distractors.append((float(rng.uniform(0, s - d_side)),
                            float(rng.uniform(0, s - d_side)), d_side,
                            (bg + rng.integers(32, 224, size=3)) % 256))
    frames = np.empty((length, s, s, 3), np.float32)
    frames[:] = bg
    for i in range(length):
        for dx, dy, d_side, d_color in distractors:
            x0 = int(round(dx + jit[0, i]))
            y0 = int(round(dy + jit[1, i]))
            x0, y0 = max(x0, 0), max(y0, 0)
            frames[i, y0:y0 + d_side, x0:x0 + d_side] = d_color
        x0 = int(round(px[i] + jit[0, i]))
        y0 = int(round(py[i] + jit[1, i]))
        x1 = min(max(x0 + int(round(w_t[i])), x0 + 1), s)
        y1 = min(max(y0 + int(round(h_t[i])), y0 + 1), s)
        x0, y0 = min(max(x0, 0), s - 1), min(max(y0, 0), s - 1)
        frames[i, y0:y1, x0:x1] = np.clip(color * gain[i], 0, 255)
    frames += rng.normal(0.0, 6.0, size=frames.shape)
    return np.clip(frames, 0, 255).astype(np.uint8)


class SyntheticPeriodicDataset:
    """On-the-fly periodic-motion clips for the RepNet counting family.

    Label convention matches models/repnet.RepNet: 0 = aperiodic,
    k ≥ 1 = sinusoidal motion of period (k+1) frames; num_class =
    num_segments // 2 so at least two full cycles fit in every clip.
    Items are deterministic in (split, idx) when the loader doesn't
    supply an rng — val/test sets are stable across epochs.
    """

    def __init__(self,
                 num_segments: int = 64,
                 size: int = 2000,
                 image_size: int = 64,
                 split: str = "train") -> None:
        self.num_segments = num_segments
        self.num_class = num_segments // 2
        self.size = size
        self.image_size = image_size
        # disjoint deterministic streams per split
        self.index_offset = {"train": 0, "val": 1, "test": 2}.get(split, 0) \
            * 1_000_003

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, idx: int, rng: Optional[np.random.Generator] = None
                   ) -> Tuple[np.ndarray, int]:
        if rng is None:
            rng = np.random.default_rng(self.index_offset + idx)
        label = idx % self.num_class
        period = 0 if label == 0 else label + 1
        clip = synth_periodic_clip(rng, self.num_segments, self.image_size,
                                   period=period)
        return clip, label


def build_dataset(cfg, split: str, device: Union[str, torch.device] = "cuda"):
    """The dataset ``cfg.dataset_type`` names for ``split`` (cfg:
    ``DataConfig``). A test split's ``person_crop`` builds
    ``PersonCrop(Detector(cfg.person_backend, cfg.person_checkpoint))``
    into its transform; the learned backend runs on ``device`` (it raises
    without a card unless the caller names the CPU), and one backend
    serves every loader thread (its forwards are serialized)."""
    if cfg.dataset_type == "DebugDataset":
        return DebugDataset(num_class=cfg.debug_num_class,
                            num_segments=cfg.num_segments,
                            size=cfg.debug_size, image_size=cfg.image_size)
    if cfg.dataset_type == "SyntheticPeriodic":
        # RepNet trains on synthesized repetitions; val and test draw
        # from disjoint deterministic streams
        return SyntheticPeriodicDataset(num_segments=cfg.num_segments,
                                        size=cfg.debug_size,
                                        image_size=cfg.image_size,
                                        split=split)
    if cfg.dataset_type not in ("FrameDataset", "TDNDataset", "ImageDataset"):
        raise KeyError(f"Dataset '{cfg.dataset_type}' is not supported.")
    is_test = split != "train"
    split_cfg = getattr(cfg, split)
    person_crop = None
    # the person crop is a test-pipeline transform (reference
    # build.py:26-28): a train split builds no detector
    if split_cfg.person_crop and is_test:
        from workoutdetector_tpu_torch.data.person import Detector, PersonCrop
        person_crop = PersonCrop(Detector(backend=cfg.person_backend,
                                          checkpoint=cfg.person_checkpoint,
                                          device=device))
    transform = build_transform(split, person_crop=person_crop,
                                size=cfg.image_size,
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
