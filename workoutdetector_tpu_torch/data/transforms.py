"""Host-side spatial transforms over uint8 clips (numpy, cv2).

The port's own copy of ``workoutdetector_tpu/data/transforms.py``.
Geometric work (crop selection, resize, flip) runs on the host over
(T, H, W, C) uint8 clips; the float convert and the normalize run on the
device in the train step (``ops.preprocess.normalize_clip``), so the
device input stays uint8. Every random draw goes through the
``np.random.Generator`` passed in, in the JAX package's order, so the
two packages give the same pixels for the same generator. cv2 is
imported inside the functions that resize.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
MULTI_SCALES = (1.0, 0.875, 0.75, 0.66)
INPUT_SIZE = 224
SCALE_SIZE = 256


def resize_clip(clip: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Resize a (T, H, W, C) clip to (T, size[0], size[1], C): INTER_AREA
    when shrinking (antialiased, as the reference's PIL resize), bilinear
    when enlarging."""
    import cv2
    th, tw = size
    if clip.shape[1] == th and clip.shape[2] == tw:
        return clip
    downscale = th < clip.shape[1] or tw < clip.shape[2]
    interp = cv2.INTER_AREA if downscale else cv2.INTER_LINEAR
    out = np.empty((clip.shape[0], th, tw, clip.shape[3]), dtype=clip.dtype)
    for i in range(clip.shape[0]):
        out[i] = cv2.resize(clip[i], (tw, th), interpolation=interp)
    return out


def resize_short_side(clip: np.ndarray, short: int = SCALE_SIZE) -> np.ndarray:
    """Resize so that the short side is ``short``, keeping the aspect
    ratio (torchvision ``Resize(int)``)."""
    h, w = clip.shape[1:3]
    if h <= w:
        th, tw = short, max(1, round(w * short / h))
    else:
        th, tw = max(1, round(h * short / w)), short
    return resize_clip(clip, (th, tw))


def center_crop(clip: np.ndarray, size: int = INPUT_SIZE) -> np.ndarray:
    h, w = clip.shape[1:3]
    y = max(0, (h - size) // 2)
    x = max(0, (w - size) // 2)
    return clip[:, y:y + size, x:x + size]


def horizontal_flip(clip: np.ndarray) -> np.ndarray:
    return clip[:, :, ::-1]


def crop_candidates(base: int, scales: Sequence[float] = MULTI_SCALES,
                    max_wh_scale_gap: int = 1) -> np.ndarray:
    """(K, 2) int32 [w, h] crop sizes from ``base`` × scales whose scale
    indices differ by at most ``max_wh_scale_gap``, in MultiScaleCrop's
    order (the on-device augment draws from the same set)."""
    sizes = [int(base * s) for s in scales]
    return np.asarray([[w, h]
                       for i, h in enumerate(sizes)
                       for j, w in enumerate(sizes)
                       if abs(i - j) <= max_wh_scale_gap], dtype=np.int32)


class MultiScaleCrop:
    """mmaction's multi-scale crop: a (w, h) pair from min-side × scales
    with a bounded scale gap, then one of 5 (or 13) fixed offsets, or a
    uniformly random one (``random_crop``)."""

    FIXED_5 = ((0, 0), (4, 0), (0, 4), (4, 4), (2, 2))
    EXTRA_8 = ((0, 2), (4, 2), (2, 4), (2, 0), (1, 1), (3, 1), (1, 3), (3, 3))

    def __init__(self,
                 scales: Sequence[float] = MULTI_SCALES,
                 max_wh_scale_gap: int = 1,
                 random_crop: bool = False,
                 num_fixed_crops: int = 5):
        if num_fixed_crops not in (5, 13):
            raise ValueError(f"num_fixed_crops must be 5 or 13, got {num_fixed_crops}")
        self.scales = tuple(scales)
        self.max_wh_scale_gap = max_wh_scale_gap
        self.random_crop = random_crop
        self.num_fixed_crops = num_fixed_crops

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        img_h, img_w = clip.shape[1:3]
        candidates = crop_candidates(min(img_h, img_w), self.scales,
                                     self.max_wh_scale_gap)
        crop_w, crop_h = (int(v) for v in
                          candidates[rng.integers(0, len(candidates))])
        if self.random_crop:
            x = int(rng.integers(0, img_w - crop_w + 1))
            y = int(rng.integers(0, img_h - crop_h + 1))
        else:
            w_step = (img_w - crop_w) // 4
            h_step = (img_h - crop_h) // 4
            offsets = list(self.FIXED_5)
            if self.num_fixed_crops == 13:
                offsets += list(self.EXTRA_8)
            ox, oy = offsets[rng.integers(0, len(offsets))]
            x, y = ox * w_step, oy * h_step
        return clip[:, y:y + crop_h, x:x + crop_w]


class ThreeCrop:
    """Three square crops along the longer side; returns one at random."""

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        h, w = clip.shape[1:3]
        s = min(h, w)
        if h > w:
            step = (h - w) // 2
            tops = [(0, 0), (step, 0), (2 * step, 0)]
        else:
            step = (w - h) // 2
            tops = [(0, 0), (0, step), (0, 2 * step)]
        y, x = tops[rng.integers(0, 3)]
        return clip[:, y:y + s, x:x + s]


class TrainTransform:
    """MultiScaleCrop → Resize(size) → RandomHorizontalFlip over uint8
    clips (the normalize runs on the device)."""

    def __init__(self,
                 scales: Optional[Sequence[float]] = MULTI_SCALES,
                 size: int = INPUT_SIZE,
                 flip_prob: float = 0.5):
        self.msc = MultiScaleCrop(scales) if scales else None
        self.size = size
        self.flip_prob = flip_prob

    def __call__(self, clip: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.msc is not None:
            clip = self.msc(clip, rng)
        else:
            clip = resize_short_side(clip, SCALE_SIZE)
            h, w = clip.shape[1:3]
            y = int(rng.integers(0, h - self.size + 1))
            x = int(rng.integers(0, w - self.size + 1))
            clip = clip[:, y:y + self.size, x:x + self.size]
        clip = resize_clip(clip, (self.size, self.size))
        if rng.random() < self.flip_prob:
            clip = horizontal_flip(clip)
        return np.ascontiguousarray(clip)


class TestTransform:
    """Resize(short = scale) → CenterCrop(size), deterministic; with a
    ``person_crop`` the person box replaces both."""

    __test__ = False  # not a pytest class

    def __init__(self, size: int = INPUT_SIZE, scale: int = SCALE_SIZE,
                 person_crop=None, in_decoder: bool = True):
        self.size = size
        self.scale = scale
        self.person_crop = person_crop
        # lets the rawframe datasets produce this geometry inside the
        # native JPEG decode (DCT prescale + bilinear, not full decode +
        # INTER_AREA); cfg.data.native_prep=false pins the host pixels
        self.in_decoder = in_decoder

    def __call__(self, clip: np.ndarray,
                 rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if self.person_crop is not None:
            clip = self.person_crop(clip)
            clip = resize_clip(clip, (self.size, self.size))
            return np.ascontiguousarray(clip)
        clip = resize_short_side(clip, self.scale)
        clip = center_crop(clip, self.size)
        return np.ascontiguousarray(clip)


def build_transform(split: str, person_crop=None, size: int = INPUT_SIZE,
                    scale: int = SCALE_SIZE, device_augment: bool = False,
                    native_prep: bool = True):
    """The split's transform.

    With ``device_augment`` the train split only letterboxes frames to a
    (scale, scale) uint8 canvas here; MultiScaleCrop and the flip run on
    the device in the train step (``ops/augment.py``).
    ``native_prep=False`` keeps this geometry out of the native JPEG
    decode (the rawframe datasets then resize on the host)."""
    if split == "train":
        if device_augment:
            return TestTransform(size=scale, scale=scale,
                                 in_decoder=native_prep)
        return TrainTransform(size=size)
    return TestTransform(size=size, scale=scale, person_crop=person_crop,
                         in_decoder=native_prep)
