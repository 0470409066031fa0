"""TSM temporal shift: hand kernel (``csrc/shift.cu``) and plain version.

Port of ``workoutdetector_tpu/ops/pallas/shift.py`` (``temporal_shift_pallas``).
The model uses it where the shift is not fused into a conv: the whole-block
input under ``shift_place='block'`` and the 3×3 shift sites of BasicBlock
networks. ``TemporalShift`` makes it differentiable: its backward is the
transpose Sᵀ (the two directions swapped) on the same kernel. Bound and
design: see the note at the top of the CUDA source.
"""

from __future__ import annotations

import torch

from workoutdetector_tpu_torch.ops.kernels import _build
from workoutdetector_tpu_torch.ops.kernels.library import (count_launch,
                                                          cpu_autograd,
                                                          kernel_op)
from workoutdetector_tpu_torch.ops.temporal_shift import shift_folds

_ELEM_BYTES = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


def temporal_shift_plain(x: torch.Tensor, n_segment: int, fold_div: int = 8,
                         reverse: bool = False) -> torch.Tensor:
    """The plain version: shift a flat (B·T, H, W, C) batch (Sᵀ when
    ``reverse``)."""
    return shift_folds(x, n_segment, x.shape[-1] // fold_div, reverse)


def _shift_cpu(x: torch.Tensor, n_segment: int, fold_div: int,
               reverse: bool) -> torch.Tensor:
    y = temporal_shift_plain(x, n_segment, fold_div, reverse)
    return x.clone() if y is x else y  # an op's output may not alias x


def _shift_fake(x: torch.Tensor, n_segment: int, fold_div: int,
                reverse: bool) -> torch.Tensor:
    return torch.empty_like(x)


@kernel_op("temporal_shift", _shift_cpu, _shift_fake)
def _shift_op(x: torch.Tensor, n_segment: int, fold_div: int,
              reverse: bool) -> torch.Tensor:
    """``wd::temporal_shift`` on CUDA: check the operand, then launch."""
    if x.dtype not in _ELEM_BYTES:
        raise TypeError(
            f"temporal_shift kernel takes bf16/fp16/fp32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("temporal_shift kernel needs a contiguous NHWC tensor")
    if x.shape[0] % n_segment:
        raise ValueError(
            f"batch {x.shape[0]} is not a multiple of T={n_segment}")
    c = x.shape[-1]
    inner = x.numel() // max(x.shape[0] * c, 1) if x.numel() else 0
    y = torch.empty_like(x)
    lib = _build.load()
    lib.check(lib.lib.wd_temporal_shift(
        x.data_ptr(), y.data_ptr(), x.shape[0], inner, n_segment, c,
        c // fold_div, _ELEM_BYTES[x.dtype], int(reverse), x.device.index or 0,
        _build.stream_handle(x.device)), "temporal_shift")
    count_launch(temporal_shift)
    return y


def temporal_shift(x: torch.Tensor, n_segment: int, fold_div: int = 8,
                   reverse: bool = False) -> torch.Tensor:
    """Shift a flat (B·T, H, W, C) batch (Sᵀ when ``reverse``) through the
    op ``wd::temporal_shift``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor; any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"temporal_shift: unsupported device {x.device}")
    if cpu_autograd(x):
        return temporal_shift_plain(x, n_segment, fold_div, reverse)
    return _shift_op(x, n_segment, fold_div, reverse)


temporal_shift.launches = 0


class TemporalShift(torch.autograd.Function):
    """Differentiable shift: forward S, backward Sᵀ, both on the wrapper
    (kernel for CUDA tensors, plain version for CPU ones)."""

    @staticmethod
    def forward(ctx, x, n_segment: int, fold_div: int):
        ctx.shift = (n_segment, fold_div)
        return temporal_shift(x.contiguous(), n_segment, fold_div)

    @staticmethod
    def backward(ctx, g):
        return (temporal_shift(g.contiguous(), *ctx.shift, reverse=True),
                None, None)


def temporal_shift_clips(x: torch.Tensor, fold_div: int = 8) -> torch.Tensor:
    """(B, T, H, W, C) → shifted (B, T, H, W, C); the signature of
    ``temporal_shift_pallas``."""
    b, t = x.shape[:2]
    flat = x.reshape(b * t, *x.shape[2:])
    return temporal_shift(flat, t, fold_div).reshape(x.shape)
