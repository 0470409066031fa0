"""NHWC convolution on top of ``F.conv2d``.

Activations stay NHWC (contiguous ``(N, H, W, C)``); ``permute(0, 3, 1, 2)``
turns one into a channels_last NCHW view without a copy, which is the
layout cuDNN takes and returns, so the result permutes back to NHWC for
free as well.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def same_pads(in_hw: Sequence[int], k_hw: Sequence[int],
              strides: Sequence[int]) -> Pads:
    """XLA's SAME padding: out = ceil(in / s), the odd pixel goes last."""
    pads = []
    for n, k, s in zip(in_hw, k_hw, strides):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(pads)


def resolve_pads(padding: Union[str, Sequence], in_hw: Sequence[int],
                 k_hw: Sequence[int], strides: Sequence[int]) -> Pads:
    """'SAME' | [(lo, hi), (lo, hi)] → ((lo, hi), (lo, hi))."""
    if isinstance(padding, str):
        if padding != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        return same_pads(in_hw, k_hw, strides)
    (a, b), (c, d) = padding
    return ((int(a), int(b)), (int(c), int(d)))


def conv2d_nhwc(x: torch.Tensor, weight: torch.Tensor,
                strides: Sequence[int] = (1, 1),
                padding: Union[str, Sequence] = "SAME",
                bias: Optional[torch.Tensor] = None,
                groups: int = 1) -> torch.Tensor:
    """(N, H, W, C) × OIHW weight (+ bias) → (N, H', W', O), in x's dtype;
    ``groups`` as flax's ``feature_group_count``."""
    k_hw = weight.shape[2:]
    (t, b), (l, r) = resolve_pads(padding, x.shape[1:3], k_hw, strides)
    xc = x.permute(0, 3, 1, 2)
    if t == b and l == r:
        pad = (t, l)
    else:
        xc = F.pad(xc, (l, r, t, b))
        pad = (0, 0)
    if bias is not None:
        bias = bias.to(x.dtype)
    y = F.conv2d(xc, weight.to(x.dtype), bias, stride=tuple(strides),
                 padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)
