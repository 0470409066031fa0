"""TSM — Temporal Shift Module video classifier.

Port of ``workoutdetector_tpu/models/tsm.py``: a ResNet trunk with the
temporal shift at residual-branch inputs (``'blockres'``: every block, or
every ``shift_round``-th; every other block when stage 3 has ≥ 23 blocks)
or whole-block inputs (``'block'``, identity path shifted too), optional
temporal max-pool before stage 2, dropout and a linear head, and average
(or identity) consensus in fp32.

The module is built in eval mode, as the JAX module's call defaults to
``train=False``; ``model.train()`` selects training (BN batch statistics
except under ``partial_bn``, dropout before ``fc``).

Input (B, T, H, W, C) normalized float; the trunk runs on the flat
(B·T, H, W, C) batch in ``dtype``. On the main path (bottleneck archs,
``fused_block=True``) the stride-1 blocks of ``fused_stages`` are single
fused-block kernels and every other shifted conv1 is a shift-matmul
kernel; ``shift_place='block'`` shifts through the shift kernel.
Training runs every block unfused, with the 1×1 backward kernels.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from workoutdetector_tpu_torch.models.resnet import (BOTTLENECK, STAGE_SIZES,
                                                     Dense, ResNet)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, scale the kept
    values by 1 / (1 − rate) in x's dtype, zero the rest."""
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class TSM(nn.Module):
    """Temporal Shift Module network: logits = model(x), x (B, T, H, W, C)."""

    def __init__(self, num_class: int, num_segments: int = 8,
                 base_model: str = "resnet50", is_shift: bool = True,
                 shift_div: int = 8, shift_place: str = "blockres",
                 consensus_type: str = "avg", temporal_pool: bool = False,
                 dtype: torch.dtype = torch.float32, shift_round: int = 0,
                 fused_block: bool = True,
                 fused_stages: Sequence[int] = (0, 1),
                 use_kernels: bool = True, dropout: float = 0.5,
                 partial_bn: bool = True):
        super().__init__()
        if shift_place not in ("blockres", "block"):
            raise ValueError(f"shift_place {shift_place!r}")
        if consensus_type not in ("avg", "identity"):
            raise ValueError(f"consensus_type {consensus_type!r}")
        self.num_class = num_class
        self.num_segments = num_segments
        self.consensus_type = consensus_type
        self.temporal_pool = temporal_pool
        self.dtype = dtype
        self.dropout = dropout
        n_round = shift_round or (2 if STAGE_SIZES[base_model][2] >= 23 else 1)

        def spec(stage: int, block: int, every: int):
            if is_shift and block % every == 0:
                return (self._seg_at_stage(stage), shift_div)
            return None

        shift_spec = pre_shift = fuse_spec = None
        if shift_place == "blockres":
            def shift_spec(i, j):
                return spec(i, j, n_round)
        else:
            def pre_shift(i, j):
                return spec(i, j, 1)
        if fused_block and BOTTLENECK[base_model]:
            stages = tuple(fused_stages)

            def fuse_spec(i, j):
                return i in stages

        self.backbone = ResNet(STAGE_SIZES[base_model],
                               bottleneck=BOTTLENECK[base_model],
                               shift_spec=shift_spec, pre_shift=pre_shift,
                               stage_hook=self._stage_hook,
                               fuse_spec=fuse_spec, use_kernels=use_kernels,
                               partial_bn=partial_bn)
        self.fc = Dense(self.backbone.num_features, num_class)
        self.eval()

    def _seg_at_stage(self, stage_idx: int) -> int:
        """Segments alive at a stage: temporal_pool halves T after stage 1."""
        if self.temporal_pool and stage_idx >= 1:
            return self.num_segments // 2
        return self.num_segments

    def _stage_hook(self, x: torch.Tensor, stage_idx: int) -> torch.Tensor:
        """Max-pool time in front of stage 2 when temporal_pool: window 3,
        stride 2, pad 1 along T."""
        if not self.temporal_pool or stage_idx != 1:
            return x
        bt, h, w, c = x.shape
        t = self.num_segments
        b = bt // t
        xt = x.reshape(b, t, h * w * c)
        pad = torch.full((b, 1, h * w * c), float("-inf"), dtype=x.dtype,
                         device=x.device)
        xp = torch.cat([pad, xt, pad], dim=1)
        pooled = torch.maximum(torch.maximum(xp[:, 0:-2:2], xp[:, 1:-1:2]),
                               xp[:, 2::2])
        return pooled.reshape(b * (t // 2), h, w, c)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """Logits of (B, T, H, W, C) clips. In train mode dropout draws its
        mask from ``dropout_generator`` (the trainer seeds one per step)."""
        b, t, h, w, c = x.shape
        if t != self.num_segments:
            raise ValueError(f"expected T={self.num_segments}, got {t}")
        feat = self.backbone(x.reshape(b * t, h, w, c).to(self.dtype))
        if self.training and self.dropout > 0:
            feat = dropout(feat, self.dropout, dropout_generator)
        logits = self.fc(feat)
        t_out = t // 2 if self.temporal_pool else t
        logits = logits.reshape(b, t_out, self.num_class).float()
        if self.consensus_type == "avg":
            return logits.mean(dim=1)
        return logits
