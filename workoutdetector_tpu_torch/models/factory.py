"""Model construction from a ``ModelConfig``.

Port of ``workoutdetector_tpu/models/factory.py`` (``build_model``,
``ImageClassifier``, ``example_input``) for the model families the port
has: TSM, TDN, TPN, TimeSformer (with its MoE MLPs), RepNet and the
image classifiers (the ResNet, ConvNeXt and ViT zoos).
"""

from __future__ import annotations

import torch

from typing import Optional, Sequence, Tuple

from workoutdetector_tpu_torch.models.convnext import (CONVNEXT_VARIANTS,
                                                       make_convnext)
from workoutdetector_tpu_torch.models.repnet import REPNET_VARIANTS, RepNet
from workoutdetector_tpu_torch.models.resnet import STAGE_SIZES, make_resnet
from workoutdetector_tpu_torch.models.tdn import TDN
from workoutdetector_tpu_torch.models.timesformer import (VIT_VARIANTS,
                                                          TimeSformer,
                                                          vit_patch_size)
from workoutdetector_tpu_torch.models.tpn import TPN
from workoutdetector_tpu_torch.models.tsm import TSM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def kernels_for(device, dtype: str) -> bool:
    """Whether a model of ``dtype`` (a ``ModelConfig.dtype``) on ``device``
    runs the hand kernels. Their GEMMs take bf16 only, so on the card a
    model of another dtype is the plain reference (as
    ``detector.resnet_backbone`` decides); on the CPU every wrapper runs
    its plain version in any dtype."""
    return torch.device(device).type != "cuda" or dtype == "bfloat16"


def build_model(cfg, use_kernels: bool = True) -> torch.nn.Module:
    """The model ``cfg.model_type`` names (cfg: ``ModelConfig``).

    The hand kernels are the main path: ``fused_block`` (TSM and TPN's
    backbone, the image ResNet-50/101) and ``flash_attention``
    (TimeSformer, its MoE variant too) are on unless the config says
    ``'false'``; TDN, RepNet, ConvNeXt and the ViT image models have no
    hand kernel. RepNet's ``num_class`` is derived (``num_segments // 2``,
    class 0 aperiodic; ``cfg.num_class`` is ignored) and an unknown
    ``base_model`` takes the ``base`` variant, as in the JAX factory. ``model_type: image``
    raises KeyError for a backbone outside the three zoos. Under autograd the
    1×1 convs' backward always takes the dx/dW kernels
    (``models/resnet.py``); nothing in the port reads ``pallas_conv_bwd``.
    ``use_kernels=False`` builds the plain reference instead.
    """
    mt = cfg.model_type.lower()
    if mt == "timesformer":
        embed, depth, heads = VIT_VARIANTS.get(
            cfg.base_model, (cfg.embed_dims, cfg.num_layers, cfg.num_heads))
        return TimeSformer(
            cfg.num_class, cfg.num_segments, cfg.image_size, cfg.patch_size,
            embed, depth, heads, cfg.mlp_ratio, cfg.attention_type,
            dtype=DTYPES[cfg.dtype],
            flash=str(cfg.flash_attention).lower() != "false",
            use_kernels=use_kernels, dropout=cfg.dropout,
            drop_path_rate=cfg.drop_path_rate, moe_experts=cfg.moe_experts,
            moe_capacity_factor=cfg.moe_capacity_factor)
    if mt == "repnet":
        width, embed, model_dim, heads = REPNET_VARIANTS.get(
            cfg.base_model, REPNET_VARIANTS["base"])
        return RepNet(cfg.num_segments, width, embed, model_dim, heads,
                      dropout=cfg.dropout, dtype=DTYPES[cfg.dtype])
    fused = str(cfg.fused_block).lower() != "false"
    if mt == "image":
        return ImageClassifier(cfg.base_model, cfg.num_class,
                               dtype=DTYPES[cfg.dtype],
                               image_size=cfg.image_size, fused_block=fused,
                               fused_stages=tuple(cfg.fused_stages),
                               use_kernels=use_kernels)
    if mt == "tdn":
        return TDN(cfg.num_class, cfg.num_segments,
                   num_frames=max(cfg.num_frames, 5),
                   base_model=cfg.base_model,
                   consensus_type=cfg.consensus_type, dropout=cfg.dropout,
                   dtype=DTYPES[cfg.dtype], partial_bn=cfg.partial_bn)
    if mt == "tpn":
        return TPN(cfg.num_class, cfg.num_segments, cfg.base_model,
                   is_shift=cfg.is_shift, shift_div=cfg.shift_div,
                   dropout=cfg.dropout, dtype=DTYPES[cfg.dtype],
                   partial_bn=cfg.partial_bn, fused_block=fused,
                   fused_stages=tuple(cfg.fused_stages),
                   use_kernels=use_kernels)
    if mt != "tsm":
        raise KeyError(f"Model '{cfg.model_type}' is not supported.")
    return TSM(cfg.num_class, cfg.num_segments, cfg.base_model,
               is_shift=cfg.is_shift, shift_div=cfg.shift_div,
               shift_place=cfg.shift_place,
               consensus_type=cfg.consensus_type,
               temporal_pool=cfg.temporal_pool, dtype=DTYPES[cfg.dtype],
               shift_round=cfg.shift_round,
               fused_block=fused, fused_stages=tuple(cfg.fused_stages), use_kernels=use_kernels,
               dropout=cfg.dropout, partial_bn=cfg.partial_bn, remat=cfg.remat)


def example_input_shape(cfg, batch: int = 1,
                        image_size: int = 224) -> Tuple[int, ...]:
    """The shape of the model's input (JAX ``example_input``, whose zeros
    only its shape serves): (B, T, 5, H, W, 3) bursts for TDN, (B, H, W, 3)
    images for the image classifiers, (B, T, H, W, 3) windows for the
    others; TimeSformer and the ViT image models at their own
    ``cfg.image_size`` (the patch grid)."""
    mt = cfg.model_type.lower()
    if mt == "image":
        if cfg.base_model in VIT_VARIANTS:
            image_size = cfg.image_size
        return (batch, image_size, image_size, 3)
    if mt == "timesformer":
        return (batch, cfg.num_segments, cfg.image_size, cfg.image_size, 3)
    if mt == "tdn":
        return (batch, cfg.num_segments, max(cfg.num_frames, 5), image_size,
                image_size, 3)
    return (batch, cfg.num_segments, image_size, image_size, 3)


class ImageClassifier(torch.nn.Module):
    """Image classifier (JAX ``factory.ImageClassifier``, the reference's
    ``train_img.py`` LitModel over a timm backbone): logits = model(x) for
    (B, H, W, C) images or the image pipeline's (B, 1, H, W, C) clips →
    (B, num_class) fp32. The backbone, under the flax name
    ``backbone_img``, is one of three zoos:

    * ``resnet*``: the ResNet with its ``fc`` head; at inference the
      stride-1 bottlenecks of ``fused_stages`` are fused-block kernels (at
      n_segment 1, fold 0: no shift), under autograd its stride-1 1×1
      convs take the dx/dW kernels;
    * ``convnext_*``: ``models/convnext.ConvNeXt`` (no hand kernel);
    * ``vit_*``: TimeSformer's ``space_only`` encoder at T = 1, a plain
      ViT (its attention in plain torch ops, as the JAX model runs
      ``space_only`` without flash attention; no hand kernel), its patch
      grid fixed by ``image_size``.

    ``num_class=0`` gives the backbone's pooled features (B, D) in fp32;
    ``num_class`` is then D, the width the engine returns. Built in eval
    mode; ``train()`` turns on the BatchNorm batch statistics (ResNet).
    ``use_kernels=False`` builds the plain reference.
    """

    def __init__(self, base_model: str = "resnet50", num_class: int = 2,
                 dtype: torch.dtype = torch.float32, image_size: int = 224,
                 fused_block: bool = True,
                 fused_stages: Sequence[int] = (0, 1),
                 use_kernels: bool = True):
        super().__init__()
        if not any(base_model in zoo for zoo in (STAGE_SIZES,
                                                 CONVNEXT_VARIANTS,
                                                 VIT_VARIANTS)):
            raise KeyError(f"Unknown image backbone '{base_model}'")
        self.base_model = base_model
        self.dtype = dtype
        # kernels whose JAX initializer is not lecun_normal, by module name
        # (``init_flax_variables``): the ViT head, normal(0.02)
        self.FLAX_KERNEL_INIT = {}
        if base_model in VIT_VARIANTS:
            if num_class == 0:
                raise ValueError("the ViT image models have a head: "
                                 "num_class > 0")
            d, depth, heads = VIT_VARIANTS[base_model]
            self.backbone_img = TimeSformer(
                num_class, 1, image_size, vit_patch_size(base_model), d,
                depth, heads, attention_type="space_only", dtype=dtype,
                use_kernels=use_kernels)
            self.FLAX_KERNEL_INIT = {"fc": ("normal", 0.02)}
            width = num_class
        elif base_model in CONVNEXT_VARIANTS:
            self.backbone_img = make_convnext(base_model, num_class, dtype)
            width = num_class or self.backbone_img.num_features
        else:
            stages = tuple(fused_stages) if fused_block else ()
            self.backbone_img = make_resnet(base_model, num_class,
                                            fuse_spec=lambda i, j:
                                            i in stages,
                                            use_kernels=use_kernels)
            width = num_class or self.backbone_img.num_features
        self.num_class = width
        self.eval()

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """fp32 logits (features) of (B, H, W, C) or (B, 1, H, W, C)
        normalized images. ``dropout_generator`` is taken for the trainer's
        call and unused: no zoo model has dropout at its defaults."""
        if x.dim() == 5:
            if x.shape[1] != 1:
                raise ValueError(
                    f"expected single-frame clips, got {tuple(x.shape)}")
            x = x[:, 0]
        if isinstance(self.backbone_img, TimeSformer):
            return self.backbone_img(x[:, None]).float()
        return self.backbone_img(x.to(self.dtype)).float()
