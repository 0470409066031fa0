"""Model construction from a ``ModelConfig``.

Port of ``workoutdetector_tpu/models/factory.py`` (``build_model``) for
the model families the port has: TSM. The others come with later slices
(ROADMAP §1 item 4).
"""

from __future__ import annotations

import torch

from workoutdetector_tpu_torch.models.tsm import TSM

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def build_model(cfg, use_kernels: bool = True) -> torch.nn.Module:
    """The model ``cfg.model_type`` names (cfg: ``ModelConfig``).

    The hand kernels are the main path: ``fused_block`` is on unless the
    config says ``'false'``, and the 1×1 backward kernels run whatever
    ``pallas_conv_bwd`` says. ``use_kernels=False`` builds the plain
    reference instead.
    """
    if cfg.model_type.lower() != "tsm":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not in the PyTorch port yet "
            "(ROADMAP §1 item 4)")
    return TSM(cfg.num_class, cfg.num_segments, cfg.base_model,
               is_shift=cfg.is_shift, shift_div=cfg.shift_div,
               shift_place=cfg.shift_place,
               consensus_type=cfg.consensus_type,
               temporal_pool=cfg.temporal_pool, dtype=DTYPES[cfg.dtype],
               shift_round=cfg.shift_round,
               fused_block=str(cfg.fused_block).lower() != "false",
               fused_stages=tuple(cfg.fused_stages), use_kernels=use_kernels,
               dropout=cfg.dropout, partial_bn=cfg.partial_bn)
