"""Hand kernels for Hopper (``csrc/*.cu``) with their plain versions.

Each wrapper runs its plain PyTorch version for a CPU tensor and launches
its kernel for a CUDA tensor (or raises); it never falls back. Each
counts its launches in ``<wrapper>.launches``. Nothing is built or
loaded at import: ``_build.load()`` runs at the first CUDA launch.
"""

from workoutdetector_tpu_torch.ops.kernels.attention import (
    Attention, attention, attention_bwd, attention_bwd_plain, attention_dkv,
    attention_dq, attention_lse, attention_lse_plain, attention_plain,
    attention_tiled, fwd_route, short_route, split_heads)
from workoutdetector_tpu_torch.ops.kernels.conv1x1 import (
    Conv1x1, ShiftConv1x1, conv1x1_dw, conv1x1_dw_plain, conv1x1_dx,
    conv1x1_dx_plain)
from workoutdetector_tpu_torch.ops.kernels.fused_block import (
    FusedBlockParams, fold_bn, fused_bottleneck, fused_bottleneck_plain,
    fused_bottleneck_wmma, wgmma_route, wgmma_tiles)
from workoutdetector_tpu_torch.ops.kernels.shift import (
    TemporalShift, temporal_shift, temporal_shift_clips, temporal_shift_plain)
from workoutdetector_tpu_torch.ops.kernels.shift_matmul import (
    shift_matmul, shift_matmul_plain, shift_matmul_plan)

WRAPPERS = (temporal_shift, shift_matmul, fused_bottleneck,
            fused_bottleneck_wmma, conv1x1_dx, conv1x1_dw, attention,
            attention_tiled, attention_bwd, attention_dkv, attention_dq)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launch_counts() -> dict:
    """{wrapper name: launches} of every kernel wrapper."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}


__all__ = [
    "Attention", "attention", "attention_bwd", "attention_bwd_plain",
    "attention_dkv", "attention_dq", "attention_lse", "attention_lse_plain",
    "attention_plain", "attention_tiled", "fwd_route", "short_route",
    "split_heads", "Conv1x1", "ShiftConv1x1",
    "conv1x1_dw", "conv1x1_dw_plain", "conv1x1_dx", "conv1x1_dx_plain", "FusedBlockParams", "fold_bn",
    "fused_bottleneck", "fused_bottleneck_plain", "fused_bottleneck_wmma",
    "wgmma_route", "wgmma_tiles", "TemporalShift",
    "temporal_shift", "temporal_shift_clips", "temporal_shift_plain",
    "shift_matmul", "shift_matmul_plain", "shift_matmul_plan", "WRAPPERS",
    "reset_launches", "launch_counts",
]
