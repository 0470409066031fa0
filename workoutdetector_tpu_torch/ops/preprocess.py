"""Device-side preprocessing: window gather, normalize and resize.

Port of ``workoutdetector_tpu/ops/preprocess.py``. The host ships uint8
frames once; the temporal window gather, the normalize and (where a
caller wants it) the antialiased resize + centre crop run on the device
that holds the video. Layout is NHWC throughout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_clip(x: torch.Tensor,
                   mean: Tuple[float, ...] = IMAGENET_MEAN,
                   std: Tuple[float, ...] = IMAGENET_STD,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (..., H, W, C) → normalized float (..., H, W, C).

    ConvertImageDtype + Normalize as one multiply-add:
    (x/255 − mean)/std == x · (1/(255·std)) − mean/std.
    """
    scale = torch.tensor([1.0 / (255.0 * s) for s in std], dtype=dtype,
                         device=x.device)
    shift = torch.tensor([m / s for m, s in zip(mean, std)], dtype=dtype,
                         device=x.device)
    return x.to(dtype) * scale - shift


def _triangle_weights(in_size: int, out_size: int) -> torch.Tensor:
    """(in, out) float32 weights of an antialiased bilinear resize along
    one axis, built as ``jax.image.scale_and_translate`` builds them: a
    triangle kernel widened by 1/scale when shrinking, columns normalised
    to sum 1, sample points outside the input zeroed."""
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = ((np.arange(out_size, dtype=np.float32) + np.float32(0.5))
              * inv_scale - np.float32(0.5))
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1.0)),
                 np.float32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.from_numpy(np.where(inside[None, :], w, np.float32(0.0))
                            .astype(np.float32))


def resize_center_crop(x: torch.Tensor, scale_size: int = 256,
                       crop_size: int = 224) -> torch.Tensor:
    """Resize the short side of (..., H, W, C) frames to ``scale_size``
    (bilinear with antialiasing, as ``jax.image.resize``), then
    centre-crop ``crop_size`` × ``crop_size``. Returns float32.

    The resize is two separable weight matrices applied by ``einsum``;
    ``F.interpolate(antialias=True)`` filters differently, so it is not
    used."""
    *lead, h, w, c = x.shape
    if h <= w:
        th, tw = scale_size, max(1, round(w * scale_size / h))
    else:
        th, tw = max(1, round(h * scale_size / w)), scale_size
    x = x.float()
    if th != h:
        x = torch.einsum("...hwc,hy->...ywc", x,
                         _triangle_weights(h, th).to(x.device))
    if tw != w:
        x = torch.einsum("...hwc,wx->...hxc", x,
                         _triangle_weights(w, tw).to(x.device))
    y0 = max(0, (th - crop_size) // 2)
    x0 = max(0, (tw - crop_size) // 2)
    return x[..., y0:y0 + crop_size, x0:x0 + crop_size, :]


def sparse_window_gather(video: torch.Tensor, starts: torch.Tensor,
                         num_frames: int = 8, stride: int = 2) -> torch.Tensor:
    """Gather N windows [s, s+stride, ..., s+(num_frames−1)·stride] from a
    (T, H, W, C) video; frames past the end are zero (the reference's
    zero-padded tail).

    Returns (N, num_frames, H, W, C) in the video's dtype, on its device.
    """
    total = video.shape[0]
    offs = torch.arange(num_frames, device=video.device) * stride
    idx = starts.to(video.device, torch.int64)[:, None] + offs[None, :]
    valid = idx < total
    out = video.index_select(0, idx.clamp(0, max(total - 1, 0)).reshape(-1))
    out = out.reshape(starts.shape[0], num_frames, *video.shape[1:])
    mask = valid.reshape(starts.shape[0], num_frames, *([1] * (video.dim() - 1)))
    return torch.where(mask, out, torch.zeros((), dtype=video.dtype,
                                              device=video.device))


def preprocess_windows(video_u8: torch.Tensor, starts: torch.Tensor,
                       num_frames: int = 8, stride: int = 2,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Window gather + normalize: uint8 (T, H, W, 3) →
    (N, num_frames, H, W, 3) normalized float windows."""
    windows = sparse_window_gather(video_u8, starts, num_frames, stride)
    return normalize_clip(windows, dtype=dtype)
