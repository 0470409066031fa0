"""Training augmentation on the device: MultiScaleCrop + flip in the step.

The port's own copy of ``workoutdetector_tpu/ops/augment.py``. With
``cfg.data.device_augment`` the loader only decodes and letterboxes
frames to a square uint8 canvas (``build_transform``'s ``device_augment``
branch); the crop choice, the bilinear crop-resize to ``image_size`` and
the horizontal flip run in the train step on the batch's device, ahead of
the normalize. These are ordinary torch ops (gathers and lerps), as the
JAX package leaves them to XLA.

The draw is split from its application, so a test can hand the
application another package's draw:

  * ``sample_crop_params(generator, base)``: one clip's (x0, y0, cw, ch,
    flip), uniform over the host MultiScaleCrop's candidate sizes, then
    over its 5 (or 13) fixed quarter-step offsets, then a flip with
    ``flip_prob``; drawn from a CPU ``torch.Generator`` (the trainer's is
    seeded by (seed + 2, step), the counterpart of the JAX step's
    ``fold_in(PRNGKey(seed + 2), step)``);
  * ``crop_flip(batch, params, out_size)``: ``bilinear_crop_resize`` of
    every clip by its row of ``params``, then the flip;
  * ``device_train_augment(batch, generator, ...)``: both.

One crop and one flip per clip, shared by its frames. The canvas is the
source frame's short-side square, so margins beyond it are out of reach,
and the resample is bilinear where the host path shrinks with INTER_AREA:
augmentation jitter, not a parity surface with the host transform.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from workoutdetector_tpu_torch.data.transforms import (MULTI_SCALES,
                                                       MultiScaleCrop,
                                                       crop_candidates)


def sample_crop_params(generator: torch.Generator,
                       base: int,
                       scales: Sequence[float] = MULTI_SCALES,
                       max_wh_scale_gap: int = 1,
                       num_fixed_crops: int = 5,
                       flip_prob: float = 0.5) -> Tuple[int, int, int, int, bool]:
    """One clip's draw from ``generator`` (a CPU generator):
    (x0, y0, cw, ch, flip)."""
    if num_fixed_crops not in (5, 13):
        raise ValueError(f"num_fixed_crops must be 5 or 13, got {num_fixed_crops}")
    cand = crop_candidates(base, scales, max_wh_scale_gap)
    offs = MultiScaleCrop.FIXED_5 + \
        (MultiScaleCrop.EXTRA_8 if num_fixed_crops == 13 else ())
    ci = int(torch.randint(0, len(cand), (), generator=generator))
    oi = int(torch.randint(0, len(offs), (), generator=generator))
    flip = bool(torch.rand((), generator=generator) < flip_prob)
    cw, ch = int(cand[ci, 0]), int(cand[ci, 1])
    x0 = offs[oi][0] * ((base - cw) // 4)
    y0 = offs[oi][1] * ((base - ch) // 4)
    return x0, y0, cw, ch, flip


def bilinear_crop_resize(clips: torch.Tensor, x0, y0, cw, ch,
                         out_size: int) -> torch.Tensor:
    """Resample the (x0, y0, cw, ch) window of each (T, H, W, C) clip of
    ``clips`` (B, T, H, W, C) to (B, T, out_size, out_size, C) float32 by
    bilinear interpolation; the window arguments are (B,) integer tensors,
    one entry per clip. Pixel centres align as in cv2.INTER_LINEAR, so a
    window of out_size × out_size passes through exactly."""
    b, t, h, w, c = clips.shape
    dev = clips.device

    def axis(start, extent, size):  # (B, out) sample positions, clamped
        grid = torch.arange(out_size, dtype=torch.float32, device=dev) + 0.5
        # a tensor divisor: divided by a Python number, CUDA multiplies by
        # its reciprocal, which moves the samples by an ulp from the CPU's
        step = extent.to(dev, torch.float32)[:, None] / torch.full(
            (1, 1), float(out_size), device=dev)
        pos = start.to(dev, torch.float32)[:, None] + grid * step - 0.5
        pos = pos.clamp(0.0, size - 1.0)
        i0 = pos.floor().long()
        return i0, (i0 + 1).clamp(max=size - 1), pos - i0.float()

    iy0, iy1, fy = axis(y0, ch, h)
    ix0, ix1, fx = axis(x0, cw, w)
    bi = torch.arange(b, device=dev)[:, None]
    # rows: (B, out, T, W, C) → (B, T, out, W, C)
    r0 = clips[bi, :, iy0].float().transpose(1, 2)
    r1 = clips[bi, :, iy1].float().transpose(1, 2)
    fy = fy[:, None, :, None, None]
    rows = r0 * (1.0 - fy) + r1 * fy
    # columns: (B, out, T, out, C) → (B, T, out, out, C)
    c0 = rows[bi, :, :, ix0].permute(0, 2, 3, 1, 4)
    c1 = rows[bi, :, :, ix1].permute(0, 2, 3, 1, 4)
    fx = fx[:, None, None, :, None]
    return c0 * (1.0 - fx) + c1 * fx


def crop_flip(batch: torch.Tensor, params: torch.Tensor,
              out_size: int) -> torch.Tensor:
    """Apply a (B, 5) integer tensor of draws, rows (x0, y0, cw, ch,
    flip), to a (B, T, S, S, C) batch → (B, T, out_size, out_size, C)
    float32 in [0, 255]."""
    params = params.to(batch.device)
    out = bilinear_crop_resize(batch, params[:, 0], params[:, 1],
                               params[:, 2], params[:, 3], out_size)
    flip = params[:, 4].bool()[:, None, None, None, None]
    return torch.where(flip, out.flip(3), out)


def canvas_size(batch: torch.Tensor) -> int:
    """S of a (B, T, S, S, C) canvas batch; ValueError for other shapes."""
    if batch.dim() != 5 or batch.shape[2] != batch.shape[3]:
        raise ValueError(
            f"expected a (B, T, S, S, C) canvas batch, got {tuple(batch.shape)}")
    return batch.shape[2]


def sample_batch_params(generator: torch.Generator, batch_size: int,
                        base: int, **kw) -> torch.Tensor:
    """``batch_size`` draws of ``sample_crop_params`` as a (B, 5) int64
    CPU tensor, in the rows' order."""
    return torch.tensor([sample_crop_params(generator, base, **kw)
                         for _ in range(batch_size)], dtype=torch.int64)


def device_train_augment(batch: torch.Tensor,
                         generator: torch.Generator,
                         out_size: int = 224,
                         scales: Sequence[float] = MULTI_SCALES,
                         max_wh_scale_gap: int = 1,
                         num_fixed_crops: int = 5,
                         flip_prob: float = 0.5) -> torch.Tensor:
    """MultiScaleCrop + RandomHorizontalFlip of a (B, T, S, S, C) uint8
    canvas batch → (B, T, out_size, out_size, C) float32 in [0, 255],
    each clip's draw from ``generator``."""
    base = canvas_size(batch)
    params = sample_batch_params(generator, batch.shape[0], base,
                                 scales=scales,
                                 max_wh_scale_gap=max_wh_scale_gap,
                                 num_fixed_crops=num_fixed_crops,
                                 flip_prob=flip_prob)
    return crop_flip(batch, params, out_size)
