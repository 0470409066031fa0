"""TPN — Temporal Pyramid Network on the shift-conv ResNet.

Port of ``workoutdetector_tpu/models/tpn.py`` (the reference's mmaction
``Recognizer2D``: a ResNetTSM backbone tapped at stages 3 and 4, the TPN
neck with its auxiliary head, and ``TPNHead``):

* the backbone is the port's ``ResNet`` with TSM's ``blockres`` shift
  (every block, or every other one when stage 3 has ≥ 23 blocks) and
  TSM's fuse policy, tapped by ``out_indices``: its inference runs the
  fused-bottleneck and shift-matmul kernels, its training ``ShiftConv1x1``
  and ``Conv1x1`` with the dx/dW kernels, as TSM's does;
* the neck keeps the JAX layout, (B, T, h, w, C) with T as the depth of
  an NDHWC 3-D conv (``conv3d`` through a permute at the call): spatial
  modulation ((1, 3, 3) stride (1, 2, 2) conv-BN-ReLUs to the deepest
  level's size and width), temporal modulation (a grouped (3, 1, 1) conv,
  groups 32, then a max-pool over T with window and stride min(8, T)),
  the top-down and bottom-up sums, grouped 1×1×1 level fusions and the
  pyramid fusion;
* the head averages over (T′, h, w), then dropout and ``fc``.

The auxiliary head (``aux_conv`` → mean → dropout → ``aux_fc``) always
exists, so a flax tree loads strictly, and runs only in train mode: the
train-mode forward returns ``(logits, aux_logits)``, which the trainer
turns into its ``aux_loss_weight`` · CE term (the JAX model sows
``aux_logits``); the eval forward returns the logits alone.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import (BOTTLENECK, STAGE_SIZES,
                                                     BatchNorm, Dense, ResNet)
from workoutdetector_tpu_torch.models.tsm import dropout

Triple = Tuple[int, int, int]
# the reference configuration's neck (mmaction's TPN in configs/tpn.py):
# taps at stages 3 and 4, temporal modulation to 1024 channels with ×8
# downsampling, fusion to 2048, and the aux head's dropout
OUT_INDICES = (2, 3)
NECK_OUT, FUSION_OUT = 1024, 2048
TEMPORAL_SCALE = 8
AUX_DROPOUT = 0.5


class Conv3d(nn.Module):
    """Bias-free 3-D convolution on (B, T, H, W, C) with an OIDHW fp32
    weight, flax's symmetric ((k − 1) // 2) padding and
    ``feature_group_count``."""

    def __init__(self, cin: int, cout: int, kernel: Triple,
                 strides: Triple = (1, 1, 1), groups: int = 1):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, *kernel))
        self.strides = strides
        self.pad = tuple((k - 1) // 2 for k in kernel)
        self.groups = groups

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                     stride=self.strides, padding=self.pad,
                     groups=self.groups)
        return y.permute(0, 2, 3, 4, 1)


class ConvBN3D(nn.Module):
    """mmaction's ConvModule: ``Conv3d`` + BN + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: Triple = (1, 1, 1),
                 strides: Triple = (1, 1, 1), groups: int = 1,
                 frozen_bn: bool = False):
        super().__init__()
        self.conv = Conv3d(cin, cout, kernel, strides, groups)
        self.bn = BatchNorm(cout, frozen=frozen_bn)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class LevelFusion(nn.Module):
    """A grouped (32) 1×1×1 conv-BN-ReLU per level, concatenated, then a
    1×1×1 conv-BN-ReLU to ``out``."""

    def __init__(self, cin: int, mid: Sequence[int], out: int,
                 frozen_bn: bool = False):
        super().__init__()
        for i, m in enumerate(mid):
            self.add_module(f"down{i}", ConvBN3D(cin, m, groups=32,
                                                 frozen_bn=frozen_bn))
        self.fusion = ConvBN3D(sum(mid), out, frozen_bn=frozen_bn)

    def forward(self, feats) -> torch.Tensor:
        outs = [getattr(self, f"down{i}")(f) for i, f in enumerate(feats)]
        return self.fusion(torch.cat(outs, dim=-1))


class TPN(nn.Module):
    """TSM-ResNet + temporal pyramid neck + TPN head: logits = model(x), x
    (B, T, H, W, C) normalized float → (B, num_class) fp32; in train mode
    ``(logits, aux_logits)``."""

    # kernels whose JAX initializer is not lecun_normal, by module name
    # (``init_flax_variables``): both heads normal(0.01)
    FLAX_KERNEL_INIT = {"fc": ("normal", 0.01), "aux_fc": ("normal", 0.01)}

    def __init__(self, num_class: int, num_segments: int = 8,
                 base_model: str = "resnet50", is_shift: bool = True,
                 shift_div: int = 8, dropout: float = 0.5,
                 dtype: torch.dtype = torch.float32,
                 partial_bn: bool = False, fused_block: bool = True,
                 fused_stages: Sequence[int] = (0, 1),
                 use_kernels: bool = True):
        super().__init__()
        self.num_class = num_class
        self.num_segments = num_segments
        self.dropout = dropout
        self.aux_dropout = AUX_DROPOUT
        self.dtype = dtype
        n_round = 2 if STAGE_SIZES[base_model][2] >= 23 else 1
        shift_spec = fuse_spec = None
        if is_shift:
            def shift_spec(i, j):
                return (num_segments, shift_div) if j % n_round == 0 else None
        if fused_block and BOTTLENECK[base_model]:
            stages = tuple(fused_stages)

            def fuse_spec(i, j):
                return i in stages

        self.backbone = ResNet(STAGE_SIZES[base_model],
                               bottleneck=BOTTLENECK[base_model],
                               shift_spec=shift_spec, fuse_spec=fuse_spec,
                               use_kernels=use_kernels, partial_bn=partial_bn,
                               out_indices=OUT_INDICES)
        expansion = 4 if BOTTLENECK[base_model] else 1
        widths = [64 * 2 ** i * expansion for i in OUT_INDICES]
        deep = widths[-1]
        n = len(widths)
        self.aux_conv = ConvBN3D(widths[-2], widths[-2] * 2, (1, 3, 3),
                                 (1, 2, 2), frozen_bn=partial_bn)
        self.aux_fc = Dense(widths[-2] * 2, num_class)
        # spatial modulation: level i takes n − 1 − i stride-2 convs
        self.spatial = []
        for i, c in enumerate(widths):
            names = []
            for s in range(n - 1 - i):
                self.add_module(f"spatial{i}_{s}", ConvBN3D(
                    c if s == 0 else deep, deep, (1, 3, 3), (1, 2, 2),
                    frozen_bn=partial_bn))
                names.append(f"spatial{i}_{s}")
            self.spatial.append(names)
        for i in range(n):
            self.add_module(f"temporal{i}_conv",
                            Conv3d(deep, NECK_OUT, (3, 1, 1), groups=32))
        self.fusion_td = LevelFusion(NECK_OUT, (NECK_OUT,) * n, FUSION_OUT,
                                     frozen_bn=partial_bn)
        self.fusion_bu = LevelFusion(NECK_OUT, (NECK_OUT,) * n, FUSION_OUT,
                                     frozen_bn=partial_bn)
        self.pyramid_fusion = ConvBN3D(2 * FUSION_OUT, FUSION_OUT,
                                       frozen_bn=partial_bn)
        self.fc = Dense(FUSION_OUT, num_class)
        self.eval()

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        """Logits of (B, T, H, W, C) clips; in train mode (logits, aux
        logits), both fp32, dropout drawing from ``dropout_generator``."""
        b, t, h, w, c = x.shape
        if t != self.num_segments:
            raise ValueError(f"expected T={self.num_segments}, got {t}")
        feats = self.backbone(x.reshape(b * t, h, w, c).to(self.dtype))
        feats = [f.reshape(b, t, *f.shape[1:]) for f in feats]

        aux = None
        if self.training:
            a = self.aux_conv(feats[-2]).mean(dim=(1, 2, 3))
            if self.aux_dropout > 0:
                a = dropout(a, self.aux_dropout, dropout_generator)
            aux = self.aux_fc(a).float()

        outs = []
        for i, f in enumerate(feats):
            for name in self.spatial[i]:
                f = getattr(self, name)(f)
            f = getattr(self, f"temporal{i}_conv")(f)
            s = min(TEMPORAL_SCALE, f.shape[1])
            bb, tt, hh, ww, cc = f.shape
            f = f[:, :tt // s * s].reshape(bb, tt // s, s, hh, ww, cc).amax(2)
            outs.append(f)

        td = list(outs)  # top-down: each level plus the deeper one
        for i in range(len(td) - 1, 0, -1):
            td[i - 1] = td[i - 1] + td[i]
        bu = list(outs)  # bottom-up: each level plus the shallower one
        for i in range(len(bu) - 1):
            bu[i + 1] = bu[i + 1] + bu[i]
        y = self.pyramid_fusion(torch.cat([self.fusion_td(td),
                                           self.fusion_bu(bu)], dim=-1))

        y = y.mean(dim=(1, 2, 3))
        if self.training and self.dropout > 0:
            y = dropout(y, self.dropout, dropout_generator)
        logits = self.fc(y).float()
        return logits if aux is None else (logits, aux)
