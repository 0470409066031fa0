"""TSM — Temporal Shift Module video classifier.

Port of ``workoutdetector_tpu/models/tsm.py``: a ResNet trunk with the
temporal shift at residual-branch inputs (``'blockres'``: every block, or
every ``shift_round``-th; every other block when stage 3 has ≥ 23 blocks)
or whole-block inputs (``'block'``, identity path shifted too), optional
temporal max-pool before stage 2, dropout and a linear head, and average
(or identity) consensus in fp32.

The module is built in eval mode, as the JAX module's call defaults to
``train=False``; ``model.train()`` selects training (BN batch statistics
except under ``partial_bn``, dropout before ``fc``); ``remat``
recomputes each residual block in the backward (``ResNet``).

Input (B, T, H, W, C) normalized float; the trunk runs on the flat
(B·T, H, W, C) batch in ``dtype``. On the main path (bottleneck archs,
``fused_block=True``) the stride-1 blocks of ``fused_stages`` are single
fused-block kernels and every other shifted conv1 is a shift-matmul
kernel; ``shift_place='block'`` shifts through the shift kernel.
Training runs every block unfused, with the 1×1 backward kernels.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Union

import torch
import torch.nn as nn

from workoutdetector_tpu_torch.models.resnet import (BOTTLENECK, STAGE_SIZES,
                                                     Dense, ResNet)


class RowDraw(NamedTuple):
    """A dropout stream for rows [lo, hi) of a global batch of ``total``
    clips (data-parallel training): each mask is drawn from ``generator``
    at the global batch's shape and cut to these rows, so the ranks
    together drop what one process on the whole batch drops."""

    generator: torch.Generator
    lo: int
    hi: int
    total: int


class Split(NamedTuple):
    """Rows of a sequence-parallel tensor: its leading dim is (rows, k)
    flattened, and those k are block ``index`` of ``n`` equal blocks of a
    global dim of k·n (the ``model`` rank's patches or frames)."""

    k: int
    n: int
    index: int


def uniform(shape: Sequence[int],
            generator: Union[torch.Generator, RowDraw, None],
            device, split: Optional[Split] = None) -> torch.Tensor:
    """fp32 uniforms in [0, 1) for a mask of ``shape``, drawn at the
    global shape and cut to this rank's part: a ``RowDraw`` cuts the
    leading dim by clip (it holds a whole number of rows per clip), a
    ``split`` cuts its k-blocks. One process on the whole batch draws
    the same numbers for the same global shape."""
    shape = list(shape)
    lead = [shape[0]]
    idx = [slice(None)]
    if split is not None:
        lead = [shape[0] // split.k, split.k * split.n]
        idx = [slice(None), slice(split.index * split.k,
                                  split.index * split.k + split.k)]
    if isinstance(generator, RowDraw):
        per_clip = lead[0] // (generator.hi - generator.lo)
        idx[0] = slice(generator.lo * per_clip, generator.hi * per_clip)
        lead[0] = generator.total * per_clip
        generator = generator.generator
    u = torch.rand(lead + shape[1:], generator=generator, device=device)
    return u[tuple(idx)].reshape(shape)


def dropout(x: torch.Tensor, rate: float,
            generator: Union[torch.Generator, RowDraw, None] = None,
            split: Optional[Split] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, scale the kept
    values by 1 / (1 − rate) in x's dtype, zero the rest. x's leading dim
    holds a whole number of rows per clip (a ``RowDraw`` cuts its mask by
    clip; ``split``: by the rank's token block too, ``uniform``)."""
    keep = 1.0 - rate
    if keep <= 0.0:
        return torch.zeros_like(x)
    mask = uniform(x.shape, generator, x.device, split) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class TSM(nn.Module):
    """Temporal Shift Module network: logits = model(x), x (B, T, H, W, C)."""

    # kernels whose JAX initializer is not lecun_normal, by module name
    # (``init_flax_variables``): the head, normal(0.001)
    FLAX_KERNEL_INIT = {"fc": ("normal", 0.001)}

    def __init__(self, num_class: int, num_segments: int = 8,
                 base_model: str = "resnet50", is_shift: bool = True,
                 shift_div: int = 8, shift_place: str = "blockres",
                 consensus_type: str = "avg", temporal_pool: bool = False,
                 dtype: torch.dtype = torch.float32, shift_round: int = 0,
                 fused_block: bool = True,
                 fused_stages: Sequence[int] = (0, 1),
                 use_kernels: bool = True, dropout: float = 0.5,
                 partial_bn: bool = True, remat: bool = False):
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
                               partial_bn=partial_bn, remat=remat)
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

    def boundary_frames(self, boundary: int) -> int:
        """Frames a clip carries at segment boundary ``boundary``: the
        temporal pool halves T in front of stage 2, so boundaries 3 and up
        carry T/2."""
        if self.temporal_pool and boundary >= 3:
            return self.num_segments // 2
        return self.num_segments

    def forward(self, x: torch.Tensor,
                dropout_generator: Union[torch.Generator, RowDraw, None] = None,
                seg_lo: int = 0, seg_hi: int = 6) -> torch.Tensor:
        """Logits of (B, T, H, W, C) clips. In train mode dropout draws its
        mask from ``dropout_generator`` (the trainer seeds one per step).

        ``seg_lo``/``seg_hi`` run the trunk's segment range (``ResNet``'s
        segments 0-4; segment 5 is pool, dropout, fc and consensus) for a
        pipeline stage (JAX ``tsm.py:115-194``). Boundary activations are
        clip-major, (B, T', h, w, c) with T' = ``boundary_frames``, so the
        pipeline's batch dim stays the clip batch."""
        if seg_lo == 0:
            b, t, h, w, c = x.shape
            if t != self.num_segments:
                raise ValueError(f"expected T={self.num_segments}, got {t}")
        else:
            b, t = x.shape[:2]
            if t != self.boundary_frames(seg_lo):
                raise ValueError(f"boundary {seg_lo} expects "
                                 f"T'={self.boundary_frames(seg_lo)}, got {t}")
        feat = self.backbone(x.reshape(b * t, *x.shape[2:]).to(self.dtype),
                             seg_lo=seg_lo, seg_hi=seg_hi)
        if seg_hi < 6:
            return feat.reshape(b, self.boundary_frames(seg_hi),
                                *feat.shape[1:])
        if self.training and self.dropout > 0:
            feat = dropout(feat, self.dropout, dropout_generator)
        logits = self.fc(feat)
        t_out = self.boundary_frames(6)
        logits = logits.reshape(b, t_out, self.num_class).float()
        if self.consensus_type == "avg":
            return logits.mean(dim=1)
        return logits
