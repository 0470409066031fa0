"""Temporal shift — the TSM core op, plain PyTorch.

Semantics (port of ``workoutdetector_tpu/ops/temporal_shift.py``): with
fold = C // fold_div, channels [0, fold) shift left in time (t ← t+1),
channels [fold, 2·fold) shift right (t ← t−1), the rest pass through;
vacated slots are zero. The shift never crosses a clip: in the flat
``(B·T, ...)`` layout the first and last frame of every clip get zeros.

These are the plain versions. On the main path the shift runs inside the
hand kernels of ``ops/kernels``.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

from workoutdetector_tpu_torch.ops.conv import conv2d_nhwc


def shift_folds(x: torch.Tensor, n_segment: int, fold: int,
                reverse: bool = False) -> torch.Tensor:
    """Shift ``fold`` channels each way on a flat (B·T, ..., C) batch.
    ``reverse`` swaps the two directions — the transpose Sᵀ, the shift's
    backward."""
    if fold == 0:
        return x
    bt = x.shape[0]
    v = x.reshape(bt // n_segment, n_segment, *x.shape[1:])
    zeros = torch.zeros_like(v[:, :1, ..., :fold])

    def ahead(part):  # frame t takes frame t+1, zero at t = T−1
        return torch.cat([part[:, 1:], zeros], dim=1)

    def behind(part):  # frame t takes frame t−1, zero at t = 0
        return torch.cat([zeros, part[:, :-1]], dim=1)

    first, second = (behind, ahead) if reverse else (ahead, behind)
    out = torch.cat([first(v[..., :fold]), second(v[..., fold:2 * fold]),
                     v[..., 2 * fold:]], dim=-1)
    return out.reshape(x.shape)


def temporal_shift(x: torch.Tensor, fold_div: int = 8) -> torch.Tensor:
    """Shift channel folds across time on a (B, T, H, W, C) clip batch."""
    b, t = x.shape[:2]
    fold = x.shape[-1] // fold_div
    flat = x.reshape(b * t, *x.shape[2:])
    return shift_folds(flat, t, fold).reshape(x.shape)


def temporal_shift_flat(x: torch.Tensor, n_segment: int,
                        fold_div: int = 8) -> torch.Tensor:
    """Temporal shift over a flattened (B·T, H, W, C) batch."""
    return shift_folds(x, n_segment, x.shape[-1] // fold_div)


def shift_conv(x: torch.Tensor, kernel: torch.Tensor, n_segment: int,
               fold_div: int = 8, strides: Sequence[int] = (1, 1),
               padding: Union[str, Sequence] = "SAME") -> torch.Tensor:
    """conv(temporal_shift_flat(x)) with an HWIO ``kernel`` (the JAX
    layout), x (B·T, H, W, C) → (B·T, H', W', O)."""
    shifted = temporal_shift_flat(x, n_segment, fold_div)
    return conv2d_nhwc(shifted, kernel.permute(3, 2, 0, 1), strides, padding)
