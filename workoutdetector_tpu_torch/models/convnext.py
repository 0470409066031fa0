"""ConvNeXt image backbone, NHWC throughout.

Port of ``workoutdetector_tpu/models/convnext.py`` (the reference's
image-classifier default, timm ``convnext_base``): a 4×4/4 patchify stem
with LayerNorm, four stages of ConvNeXt blocks (depthwise 7×7 → LayerNorm
→ pointwise 4× → exact GELU → pointwise → γ layer scale → + residual)
with a LayerNorm + 2×2/2 conv between stages, then the global mean, a
LayerNorm and the head. Every LayerNorm has ε 1e-6. The depthwise conv is
a grouped cuDNN convolution (``groups = C``); the pointwise layers are
cuBLAS GEMMs. No hand kernel: the JAX model calls no Pallas kernel.

Module and parameter names follow the flax tree (``stem_conv``,
``stem_norm``, ``down{i}_norm``, ``down{i}_conv``,
``stage{i}_block{j}.{conv_dw,norm,fc1,fc2,gamma}``, ``head_norm``,
``head``), so ``models/convert.load_flax_variables`` is a key map and
``port_convnext_checkpoint`` ports timm's layout. Parameters are fp32,
compute runs in ``dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import Conv, Dense
from workoutdetector_tpu_torch.models.timesformer import LayerNorm

LAYER_SCALE_INIT = 1e-6  # γ at init (timm's, and the JAX block's)
# (depths, dims) per variant: timm's convnext_* definitions
CONVNEXT_VARIANTS = {
    "convnext_atto": ((2, 2, 6, 2), (40, 80, 160, 320)),
    "convnext_tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "convnext_small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "convnext_base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "convnext_large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
}


class ConvNeXtBlock(nn.Module):
    """dw7×7 → LN → pw(4×) → GELU → pw → γ-scale → + residual, on NHWC x."""

    def __init__(self, dim: int, layer_scale_init: float = LAYER_SCALE_INIT):
        super().__init__()
        self.conv_dw = Conv(dim, dim, 7, 1, 3, bias=True, groups=dim)
        self.norm = LayerNorm(dim)
        self.fc1 = Dense(dim, 4 * dim)
        self.fc2 = Dense(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale_init))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(self.conv_dw(x))
        y = self.fc2(F.gelu(self.fc1(y)))  # exact (erf) GELU
        return x + y * self.gamma.to(y.dtype)


class ConvNeXt(nn.Module):
    """ConvNeXt classifier or feature extractor: (B, H, W, 3) float →
    (B, num_classes) fp32 logits; ``num_classes=0`` gives the pooled
    features after ``head_norm``, ``spatial=True`` the last stage's map.
    Built in eval mode (it has no train-mode behaviour of its own)."""

    def __init__(self, depths: Sequence[int] = (3, 3, 9, 3),
                 dims: Sequence[int] = (96, 192, 384, 768),
                 num_classes: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.dims = tuple(depths), tuple(dims)
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem_conv = Conv(3, dims[0], 4, 4, 0, bias=True)
        self.stem_norm = LayerNorm(dims[0])
        cin = dims[0]
        for i, (depth, dim) in enumerate(zip(depths, dims)):
            if i > 0:
                self.add_module(f"down{i}_norm", LayerNorm(cin))
                self.add_module(f"down{i}_conv",
                                Conv(cin, dim, 2, 2, 0, bias=True))
            for j in range(depth):
                self.add_module(f"stage{i}_block{j}", ConvNeXtBlock(dim))
            cin = dim
        self.head_norm = LayerNorm(cin)
        if num_classes > 0:
            self.head = Dense(cin, num_classes)
        self.num_features = cin
        self.eval()

    def forward(self, x: torch.Tensor, spatial: bool = False) -> torch.Tensor:
        x = self.stem_norm(self.stem_conv(x.to(self.dtype)))
        for i, depth in enumerate(self.depths):
            if i > 0:
                x = getattr(self, f"down{i}_conv")(
                    getattr(self, f"down{i}_norm")(x))
            for j in range(depth):
                x = getattr(self, f"stage{i}_block{j}")(x)
        if spatial:
            return x
        x = self.head_norm(x.mean(dim=(1, 2)))
        if self.num_classes == 0:
            return x
        return self.head(x).float()


def make_convnext(variant: str, num_classes: int = 1000,
                  dtype: torch.dtype = torch.float32) -> ConvNeXt:
    depths, dims = CONVNEXT_VARIANTS[variant]
    return ConvNeXt(depths=depths, dims=dims, num_classes=num_classes,
                    dtype=dtype)
