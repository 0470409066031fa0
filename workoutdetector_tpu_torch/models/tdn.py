"""TDN — Temporal Difference Network, NHWC.

Port of ``workoutdetector_tpu/models/tdn.py``: two stems (the RGB centre
frame of each 5-frame burst through ``conv1``, the four stacked frame
differences through ``conv1_5`` after a 2×2 average pool), fused α/β at
the stem and after layer1 (0.5/0.5 at T = 8, else 0.75/0.25), an
FBResNet body (convs with bias) whose stages 2-4 carry the motion
excitation (``MSEModule``) and the learnable 3-tap temporal shift
(``TemporalShiftConv``) after conv1, dropout, ``new_fc`` and an fp32
average consensus. Module and parameter names follow the flax tree, so
``models/convert.load_flax_variables`` is a key map; the shift taps are a
(3, C) ``weight`` (the flax (C, 3) ``kernel`` transposed, as a Dense's).

Every op is a plain torch op, which cuDNN or cuBLAS runs: the JAX TDN
calls no Pallas kernel, so the port has no hand kernel here. ``seg_lo``/
``seg_hi`` run a segment range for a pipeline stage
(``parallel/pipeline.pipeline_apply_het``), as the JAX module's do.

The module is built in eval mode; ``model.train()`` selects training (BN
batch statistics except under ``partial_bn``, where only the RGB stem's
``bn1`` stays live, and dropout before ``new_fc``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import BatchNorm, Conv, Dense
from workoutdetector_tpu_torch.models.tsm import dropout

TDN_STAGES = {"resnet50": [3, 4, 6, 3], "resnet101": [3, 4, 23, 3]}


def nearest_resize(x: torch.Tensor, h_out: int, w_out: int) -> torch.Tensor:
    """(N, h, w, C) → (N, h_out, w_out, C) by nearest neighbour with
    half-pixel centres, as ``jax.image.resize(..., "nearest")``: output
    pixel i reads src = floor((i + 0.5) · in / out), in exact integer
    arithmetic (so the 2× case reads i // 2). Not ``F.interpolate``'s
    ``nearest``, which reads floor(i · in / out)."""
    _, h, w, _ = x.shape

    def src(n_in: int, n_out: int) -> torch.Tensor:
        i = torch.arange(n_out, device=x.device)
        return torch.div((2 * i + 1) * n_in, 2 * n_out, rounding_mode="floor")

    return x.index_select(1, src(h, h_out)).index_select(2, src(w, w_out))


def _pool(x: torch.Tensor, kind: str) -> torch.Tensor:
    """NHWC pools of the stems and mSE: 'avg' 2×2 stride 2 (VALID), 'max'
    3×3 stride 2 with one pixel of -inf padding."""
    xc = x.permute(0, 3, 1, 2)
    y = F.avg_pool2d(xc, 2, 2) if kind == "avg" else F.max_pool2d(xc, 3, 2, 1)
    return y.permute(0, 2, 3, 1)


def _time_shift(x: torch.Tensor, n_segment: int, direction: int
                ) -> torch.Tensor:
    """Zero-padded shift along time inside each clip of the flat (B·T, ...)
    batch: direction 1 gives y[t] = x[t + 1] (zero at the last t), -1
    gives y[t] = x[t − 1] (zero at the first)."""
    xt = x.reshape(-1, n_segment, *x.shape[1:])
    zero = torch.zeros_like(xt[:, :1])
    y = torch.cat([xt[:, 1:], zero], 1) if direction == 1 else \
        torch.cat([zero, xt[:, :-1]], 1)
    return y.reshape(x.shape)


class TemporalShiftConv(nn.Module):
    """The learnable per-channel 3-tap temporal filter (the reference's
    ShiftModule, a grouped Conv1d over T): taps ``weight`` (3, C) over
    [x(t − 1), x(t), x(t + 1)], zero past either end of a clip."""

    def __init__(self, channels: int, n_segment: int):
        super().__init__()
        self.n_segment = n_segment
        self.weight = nn.Parameter(torch.zeros(3, channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        return _time_shift(x, self.n_segment, -1) * w[0] + x * w[1] + \
            _time_shift(x, self.n_segment, 1) * w[2]


class MSEModule(nn.Module):
    """Motion excitation: a 1×1 bottleneck to C/16 with BN, a depthwise
    3×3 on it, the forward (conv(t + 1) − raw(t), zero at the last t) and
    backward (conv(t − 1) − raw(t), zero at the first) temporal
    differences, each through a 2×2-pooled 3×3 branch resized back, a
    full-resolution 3×3 branch and the 1×1 back to C, a sigmoid − 0.5
    gate, and x + x·y."""

    def __init__(self, channels: int, n_segment: int, reduction: int = 16,
                 frozen_bn: bool = False):
        super().__init__()
        r = channels // reduction
        self.n_segment = n_segment
        self.conv1 = Conv(channels, r, 1)
        self.bn1 = BatchNorm(r, frozen=frozen_bn)
        self.conv2 = Conv(r, r, 3, 1, 1, groups=r)
        self.conv3_smallscale2 = Conv(r, r, 3, 1, 1)
        self.bn3_smallscale2 = BatchNorm(r, frozen=frozen_bn)
        self.conv3_smallscale4 = Conv(r, r, 3, 1, 1)
        self.bn3_smallscale4 = BatchNorm(r, frozen=frozen_bn)
        self.conv3 = Conv(r, channels, 1)
        self.bn3 = BatchNorm(channels, frozen=frozen_bn)

    def _branch(self, diff: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = diff.shape
        if h >= 2 and w >= 2:
            y2 = self.conv3_smallscale2(_pool(diff, "avg"),
                                        self.bn3_smallscale2)
            y2 = nearest_resize(y2, h, w)
        else:  # already 1×1 (tiny inputs): no downscale
            y2 = self.conv3_smallscale2(diff, self.bn3_smallscale2)
        y4 = self.conv3_smallscale4(diff, self.bn3_smallscale4)
        y = self.conv3(diff / 3.0 + y2 / 3.0 + y4 / 3.0, self.bn3)
        return torch.sigmoid(y) - 0.5

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bott = self.conv1(x, self.bn1)
        conv_bott = self.conv2(bott)
        t = self.n_segment
        b = bott.reshape(-1, t, *bott.shape[1:])
        c = conv_bott.reshape(b.shape)
        zero = torch.zeros_like(b[:, :1])
        diff_fwd = torch.cat([c[:, 1:] - b[:, :-1], zero], 1)
        diff_bwd = torch.cat([zero, c[:, :-1] - b[:, 1:]], 1)
        y = 0.5 * self._branch(diff_fwd.reshape(bott.shape)) + \
            0.5 * self._branch(diff_bwd.reshape(bott.shape))
        return x + x * y


class TDNBottleneck(nn.Module):
    """FBResNet bottleneck, convs with bias, stride on the 3×3;
    ``with_shift`` puts the mSE and the temporal shift after conv1."""
    expansion = 4

    def __init__(self, cin: int, filters: int, n_segment: int, stride: int,
                 downsample: bool, with_shift: bool, frozen_bn: bool):
        super().__init__()
        out = filters * self.expansion
        self.conv1 = Conv(cin, filters, 1, bias=True)
        self.bn1 = BatchNorm(filters, frozen=frozen_bn)
        self.with_shift = with_shift
        if with_shift:
            self.mse = MSEModule(filters, n_segment, frozen_bn=frozen_bn)
            self.shift = TemporalShiftConv(filters, n_segment)
        self.conv2 = Conv(filters, filters, 3, stride, 1, bias=True)
        self.bn2 = BatchNorm(filters, frozen=frozen_bn)
        self.conv3 = Conv(filters, out, 1, bias=True)
        self.bn3 = BatchNorm(out, frozen=frozen_bn)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv(cin, out, 1, stride, bias=True)
            self.downsample_bn = BatchNorm(out, frozen=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.conv1(x, self.bn1))
        if self.with_shift:
            y = self.shift(self.mse(y))
        y = torch.relu(self.conv2(y, self.bn2))
        y = self.conv3(y, self.bn3)
        residual = x
        if self.downsample:
            residual = self.downsample_conv(x, self.downsample_bn)
        return torch.relu(y + residual)


class TDN(nn.Module):
    """Temporal Difference Network: logits = model(x), x normalized
    (B, T, 5, H, W, C) bursts or the dataset's (B, T·5, H, W, C)."""

    # kernels whose JAX initializer is not lecun_normal, by module name
    # (``init_flax_variables``): the head normal(0.01), the shift taps the
    # shift pattern over C/8 folds
    FLAX_KERNEL_INIT = {"new_fc": ("normal", 0.01), "shift": ("shift", 8)}

    def __init__(self, num_class: int, num_segments: int = 8,
                 num_frames: int = 5, base_model: str = "resnet50",
                 consensus_type: str = "avg", dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 partial_bn: bool = False):
        super().__init__()
        if num_frames != 5:
            raise ValueError(f"TDN uses 5-frame bursts, not {num_frames}")
        if consensus_type not in ("avg", "identity"):
            raise ValueError(f"consensus_type {consensus_type!r}")
        self.num_class = num_class
        self.num_segments = num_segments
        self.num_frames = num_frames
        self.consensus_type = consensus_type
        self.dropout = dropout
        self.dtype = dtype
        t = num_segments
        # the stem and layer1 fusion weights of the reference's TDN_Net
        self.alpha, self.beta = (0.5, 0.5) if t == 8 else (0.75, 0.25)
        stages = TDN_STAGES[base_model]
        # diff stem; its BN freezes with the body under partial BN
        self.conv1_5 = Conv(12, 64, 7, 2, 3)
        self.bn1_5 = BatchNorm(64, frozen=partial_bn)
        self.conv1 = Conv(3, 64, 7, 2, 3, bias=True)
        self.bn1 = BatchNorm(64)  # the one BN partial BN keeps live
        self.stages = []
        for name, cin, filters, n, stride, shift in (
                ("resnext_layer1", 64, 64, stages[0], 1, False),
                ("layer1", 64, 64, stages[0], 1, False),
                ("layer2", 256, 128, stages[1], 2, True),
                ("layer3", 512, 256, stages[2], 2, True),
                ("layer4", 1024, 512, stages[3], 2, True)):
            names = []
            for j in range(n):
                s = stride if j == 0 else 1
                c = cin if j == 0 else filters * 4
                self.add_module(f"{name}_{j}", TDNBottleneck(
                    c, filters, t, s,
                    downsample=j == 0 and (s != 1 or c != filters * 4),
                    with_shift=shift, frozen_bn=partial_bn))
                names.append(f"{name}_{j}")
            self.stages.append(names)
        self.new_fc = Dense(2048, num_class)
        self.eval()

    def _stage(self, x: torch.Tensor, k: int) -> torch.Tensor:
        for name in self.stages[k]:
            x = getattr(self, name)(x)
        return x

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                seg_lo: int = 0, seg_hi: int = 5) -> torch.Tensor:
        """Logits of the bursts. In train mode dropout draws its mask from
        ``dropout_generator`` (the trainer seeds one per step).

        ``seg_lo``/``seg_hi`` run the segment range [seg_lo, seg_hi) for a
        pipeline stage (JAX ``tdn.py:250``): segment 0 is both stems,
        layer1 and the two fusions (the part with cross-path structure),
        1-3 are layer2-4, 4 is the head (pool, dropout, ``new_fc``,
        consensus). Boundary activations are clip-major, (B, T, h, w, c)."""
        if not 0 <= seg_lo < seg_hi <= 5:
            raise ValueError(f"segment range [{seg_lo}, {seg_hi})")
        t = self.num_segments
        if seg_lo == 0:
            if x.dim() == 5:  # the dataset's (B, T·5, H, W, C)
                b, td, h, w, c = x.shape
                x = x.reshape(b, td // self.num_frames, self.num_frames, h,
                              w, c)
            b, tt, d, h, w, c = x.shape
            if tt != t or d != self.num_frames:
                raise ValueError(f"expected (B, {t}, {self.num_frames}, H, "
                                 f"W, C) bursts, got {tuple(x.shape)}")
            frames = x.reshape(b * t, d, h, w, c).to(self.dtype).unbind(1)
            diffs = torch.cat([frames[i + 1] - frames[i] for i in range(4)],
                              -1)

            xd = torch.relu(self.conv1_5(_pool(diffs, "avg"), self.bn1_5))
            temp_out_diff1 = _pool(xd, "max")
            xd = self._stage(temp_out_diff1, 0)

            y = _pool(torch.relu(self.conv1(frames[2], self.bn1)), "max")
            y = self.alpha * y + self.beta * nearest_resize(temp_out_diff1,
                                                            *y.shape[1:3])
            y = self._stage(y, 1)
            y = self.alpha * y + self.beta * nearest_resize(xd, *y.shape[1:3])
        else:
            b, tt = x.shape[:2]
            if tt != t:
                raise ValueError(f"boundary expects T={t}, got {tt}")
            y = x.reshape(b * t, *x.shape[2:]).to(self.dtype)
        for seg in (1, 2, 3):
            if seg_lo <= seg < seg_hi:
                y = self._stage(y, seg + 1)
        if seg_hi < 5:
            return y.reshape(b, t, *y.shape[1:])

        feat = y.mean(dim=(1, 2))
        if self.training and self.dropout > 0:
            feat = dropout(feat, self.dropout, dropout_generator)
        logits = self.new_fc(feat).reshape(b, t, self.num_class).float()
        if self.consensus_type == "avg":
            return logits.mean(dim=1)
        return logits
