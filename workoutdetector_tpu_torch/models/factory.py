"""Model construction from a ``ModelConfig``.

Port of ``workoutdetector_tpu/models/factory.py`` (``build_model``,
``example_input``) for the model families the port has: TSM, TDN, TPN and
TimeSformer. The others (RepNet, the image classifiers) come with later
slices (ROADMAP §1 item 6).
"""

from __future__ import annotations

import torch

from typing import Tuple

from workoutdetector_tpu_torch.models.tdn import TDN
from workoutdetector_tpu_torch.models.timesformer import (VIT_VARIANTS,
                                                          TimeSformer)
from workoutdetector_tpu_torch.models.tpn import TPN
from workoutdetector_tpu_torch.models.tsm import TSM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_model(cfg, use_kernels: bool = True) -> torch.nn.Module:
    """The model ``cfg.model_type`` names (cfg: ``ModelConfig``).

    The hand kernels are the main path: ``fused_block`` (TSM and TPN's
    backbone) and ``flash_attention`` (TimeSformer) are on unless the
    config says ``'false'``; TDN has no hand kernel. Under autograd the
    1×1 convs' backward always takes the dx/dW kernels
    (``models/resnet.py``); nothing in the port reads ``pallas_conv_bwd``.
    ``use_kernels=False`` builds the plain reference instead.
    """
    mt = cfg.model_type.lower()
    if mt == "timesformer":
        if cfg.moe_experts > 0:
            raise NotImplementedError(
                "TimeSformer MoE MLPs (moe_experts > 0) are not in the "
                "PyTorch port yet (ROADMAP §1 item 6)")
        embed, depth, heads = VIT_VARIANTS.get(
            cfg.base_model, (cfg.embed_dims, cfg.num_layers, cfg.num_heads))
        return TimeSformer(
            cfg.num_class, cfg.num_segments, cfg.image_size, cfg.patch_size,
            embed, depth, heads, cfg.mlp_ratio, cfg.attention_type,
            dtype=DTYPES[cfg.dtype],
            flash=str(cfg.flash_attention).lower() != "false",
            use_kernels=use_kernels, dropout=cfg.dropout,
            drop_path_rate=cfg.drop_path_rate)
    fused = str(cfg.fused_block).lower() != "false"
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
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} (RepNet, the image classifiers) "
            "is not in the PyTorch port yet (ROADMAP §1 item 6)")
    return TSM(cfg.num_class, cfg.num_segments, cfg.base_model,
               is_shift=cfg.is_shift, shift_div=cfg.shift_div,
               shift_place=cfg.shift_place,
               consensus_type=cfg.consensus_type,
               temporal_pool=cfg.temporal_pool, dtype=DTYPES[cfg.dtype],
               shift_round=cfg.shift_round,
               fused_block=fused, fused_stages=tuple(cfg.fused_stages), use_kernels=use_kernels,
               dropout=cfg.dropout, partial_bn=cfg.partial_bn)


def example_input_shape(cfg, batch: int = 1,
                        image_size: int = 224) -> Tuple[int, ...]:
    """The shape of the model's input (JAX ``example_input``, whose zeros
    only its shape serves): (B, T, 5, H, W, 3) bursts for TDN, (B, T, H, W,
    3) windows for the port's other models, TimeSformer at its own
    ``cfg.image_size`` (its patch grid)."""
    mt = cfg.model_type.lower()
    if mt == "timesformer":
        return (batch, cfg.num_segments, cfg.image_size, cfg.image_size, 3)
    if mt == "tdn":
        return (batch, cfg.num_segments, max(cfg.num_frames, 5), image_size,
                image_size, 3)
    return (batch, cfg.num_segments, image_size, image_size, 3)
