"""Model construction from a ``ModelConfig``.

Port of ``workoutdetector_tpu/models/factory.py`` (``build_model``) for
the model families the port has: TSM and TimeSformer. The others come
with later slices (ROADMAP §1 item 6).
"""

from __future__ import annotations

import torch

from workoutdetector_tpu_torch.models.timesformer import (VIT_VARIANTS,
                                                          TimeSformer)
from workoutdetector_tpu_torch.models.tsm import TSM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_model(cfg, use_kernels: bool = True) -> torch.nn.Module:
    """The model ``cfg.model_type`` names (cfg: ``ModelConfig``).

    The hand kernels are the main path: ``fused_block`` (TSM) and
    ``flash_attention`` (TimeSformer) are on unless the config says
    ``'false'``. Under autograd the 1×1 convs' backward always takes the
    dx/dW kernels (``models/resnet.py``); nothing in the port reads
    ``pallas_conv_bwd``. ``use_kernels=False`` builds the plain reference
    instead.
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
    if mt != "tsm":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not in the PyTorch port yet "
            "(ROADMAP §1 item 6)")
    return TSM(cfg.num_class, cfg.num_segments, cfg.base_model,
               is_shift=cfg.is_shift, shift_div=cfg.shift_div,
               shift_place=cfg.shift_place,
               consensus_type=cfg.consensus_type,
               temporal_pool=cfg.temporal_pool, dtype=DTYPES[cfg.dtype],
               shift_round=cfg.shift_round,
               fused_block=str(cfg.fused_block).lower() != "false",
               fused_stages=tuple(cfg.fused_stages), use_kernels=use_kernels,
               dropout=cfg.dropout, partial_bn=cfg.partial_bn)
