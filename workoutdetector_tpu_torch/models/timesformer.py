"""TimeSformer — divided space-time attention video classifier.

Port of ``workoutdetector_tpu/models/timesformer.py``: per-frame 16×16
patch embedding (cuDNN), cls token and position embeddings, a time
embedding over segments, then per block temporal attention (per patch
location, over T, through ``t_fc``), spatial attention (per frame, the cls
token replicated per frame and its outputs averaged back over T) and an
MLP, all pre-LayerNorm (eps 1e-6, exact GELU); ``joint_space_time`` and
``space_only`` run standard ViT blocks.

Tokens live as (B, P, T, D) in the divided blocks, as in the JAX package.
On the main path (``flash=True``) the spatial attention of every divided
block is the hand attention kernel (``ops.kernels``): under autograd the
packed-qkv ``Attention`` function, whose backward is one launch of the
kernel that computes D, dQ, dK and dV (``attention_bwd``; the tiled dK/dV
and dQ kernels where ``short_route`` refuses it: l > 224 or dh ≠ 64). The
temporal attention (l = T) and the joint blocks' attention
are plain torch ops, as they take the XLA path in the JAX package.
Parameters are fp32, compute runs in ``dtype``, logits come back fp32.

Training (``model.train()``): stochastic depth (``drop_path_rate``, per
layer linspace(0, rate, L); per-row masks) and the hidden dropouts wherever
the JAX model has them (``dropout``), every mask drawn in fp32 from the
forward's ``dropout_generator``, so the bf16 and fp32 paths of one step
draw the same masks.

``moe_experts > 0`` puts the Switch MLP (``models/moe.MoEMlp``) in place
of each divided block's MLP; it routes the cls tokens and the patches as
two groups, and the train-mode forward returns the 2·L load-balance
losses beside the logits. One device holds every expert.

Not ported (parallel work): ``seq_mesh``, ``block_barrier``, expert
parallelism, and the attention dropout, which no configuration sets
(ROADMAP).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.moe import MoEMlp
from workoutdetector_tpu_torch.models.resnet import Dense
from workoutdetector_tpu_torch.models.tsm import dropout
from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.ops.conv import conv2d_nhwc

# ViT variants accepted as TimeSformer backbones: (embed, depth, heads)
VIT_VARIANTS = {
    "vit_tiny_patch16_224": (192, 12, 3),
    "vit_small_patch16_224": (384, 12, 6),
    "vit_base_patch16_224": (768, 12, 12),
    "vit_base_patch32_224": (768, 12, 12),
    "vit_large_patch16_224": (1024, 24, 16),
}
ATTENTION_TYPES = ("divided_space_time", "joint_space_time", "space_only")


def vit_patch_size(name: str) -> int:
    """Patch size encoded in a timm ViT name (vit_*_patch{P}_*)."""
    m = re.search(r"patch(\d+)", name)
    return int(m.group(1)) if m else 16


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The JAX package's non-flash attention, in q's dtype:
    softmax(q kᵀ · scale) v over (n, h, l, dh)."""
    attn = torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1)
    return attn @ v


def drop_path(x: torch.Tensor, rate: float,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stochastic depth (``_drop_path``): one keep/drop decision per
    leading row, drawn in fp32; kept rows scaled by 1 / (1 − rate) in x's
    dtype, dropped rows zero."""
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1),
                      generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6)`` over the last axis, in x's dtype."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype),
                            self.bias.to(x.dtype), self.eps)


class MHA(nn.Module):
    """Multi-head self-attention with the packed qkv projection: q, k and v
    are contiguous thirds of its output (torch's in_proj layout).

    ``flash=True`` runs softmax(q kᵀ) v through the ``Attention`` function
    on the packed projection (no copy): the forward kernel, and under
    autograd ``attention_bwd`` (at ViT-B/16's l = 197 one launch that
    computes D, dQ, dK and dV), whose gradient comes back packed;
    otherwise plain torch ops in the compute dtype, as the JAX package's
    XLA path. ``proj_drop``: the hidden dropout after ``proj``.
    """

    def __init__(self, dim: int, num_heads: int, flash: bool = False,
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.proj_drop = proj_drop
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        n, l, d = x.shape
        h = self.num_heads
        scale = (d // h) ** -0.5
        qkv = self.qkv(x)
        if self.flash:
            out = kernels.Attention.apply(qkv, h, scale)
        else:
            q, k, v = kernels.split_heads(qkv, h)
            out = attention_xla(q, k, v, scale)
            out = out.transpose(1, 2).reshape(n, l, d)
        out = self.proj(out)
        if self.training and self.proj_drop > 0:
            out = dropout(out, self.proj_drop, generator)
        return out


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, drop: float = 0.0):
        super().__init__()
        self.drop = drop
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = F.gelu(self.fc1(x))  # exact (erf) GELU
        if self.training and self.drop > 0:
            x = dropout(x, self.drop, generator)
        x = self.fc2(x)
        if self.training and self.drop > 0:
            x = dropout(x, self.drop, generator)
        return x


class DividedBlock(nn.Module):
    """One divided space-time block: cls (B, 1, D) + patches (B, P, T, D)
    → same shapes. ``fold_temporal_fc``: t_fc is merged into t_attn.proj
    (``fold_for_inference``) and the block has no ``t_fc``; such a block
    refuses a train mode whose masks would fall between the two. In train
    mode with ``drop_path`` > 0, three masks:
    per (b·p) row of the temporal branch (before ``t_fc``), per (b·t) row
    of the spatial branch (the cls row and that frame's patches alike),
    and one per sample shared by the cls and patch MLP outputs.
    ``moe_experts > 0``: the MLP is a ``MoEMlp`` (one router and expert
    stack for the cls tokens and the patches, called once on each), whose
    two load-balance losses ``forward`` appends to ``moe_losses`` where
    given."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 flash: bool = False, fold_temporal_fc: bool = False,
                 drop: float = 0.0, drop_path: float = 0.0,
                 moe_experts: int = 0, moe_capacity_factor: float = 1.25):
        super().__init__()
        self.fold_temporal_fc = fold_temporal_fc
        self.drop_path = drop_path
        self.t_norm = LayerNorm(dim)
        self.t_attn = MHA(dim, num_heads, proj_drop=drop)
        if not fold_temporal_fc:
            self.t_fc = Dense(dim, dim)
        self.s_norm = LayerNorm(dim)
        self.s_attn = MHA(dim, num_heads, flash=flash, proj_drop=drop)
        self.mlp_norm = LayerNorm(dim)
        if moe_experts > 0:
            self.mlp = MoEMlp(dim, int(dim * mlp_ratio), moe_experts,
                              moe_capacity_factor, drop)
        else:
            self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def forward(self, cls_tok: torch.Tensor, patches: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                moe_losses: Optional[List[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, p, t, d = patches.shape
        rate = self.drop_path if self.training else 0.0
        if self.fold_temporal_fc and (rate > 0 or self.training
                                      and self.t_attn.proj_drop > 0):
            raise ValueError("a block with t_fc folded is inference-only: "
                             "its masks would fall between proj and t_fc")
        # temporal attention per patch location, over T
        y = self.t_attn(self.t_norm(patches).reshape(b * p, t, d), generator)
        if rate > 0:
            y = drop_path(y, rate, generator)
        y = y.reshape(b, p, t, d)
        if not self.fold_temporal_fc:
            y = self.t_fc(y)
        patches = patches + y

        # spatial attention per frame, the cls token replicated per frame
        sp = patches.transpose(1, 2).reshape(b * t, p, d)
        cls_rep = cls_tok[:, None].expand(b, t, 1, d).reshape(b * t, 1, d)
        sp = self.s_attn(self.s_norm(torch.cat([cls_rep, sp], dim=1)),
                         generator)
        if rate > 0:
            sp = drop_path(sp, rate, generator)
        cls_tok = cls_tok + sp[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
        patches = patches + sp[:, 1:].reshape(b, t, p, d).transpose(1, 2)

        # one MLP over every token, cls and patches alike, and one
        # stochastic-depth mask per sample shared by both
        y_cls = self.mlp(self.mlp_norm(cls_tok), generator)
        y_pat = self.mlp(self.mlp_norm(patches), generator)
        if isinstance(self.mlp, MoEMlp):
            (y_cls, l_cls), (y_pat, l_pat) = y_cls, y_pat
            if moe_losses is not None:
                moe_losses += [l_cls, l_pat]
        if rate > 0:
            keep = 1.0 - rate
            mask = torch.rand((b, 1, 1), generator=generator,
                              device=patches.device) < keep
            zero = torch.zeros((), dtype=y_cls.dtype, device=y_cls.device)
            y_cls = torch.where(mask, y_cls / keep, zero)
            y_pat = torch.where(mask[..., None], y_pat / keep, zero)
        return cls_tok + y_cls, patches + y_pat


class JointBlock(nn.Module):
    """Standard pre-LN ViT block over a flat token sequence; in train mode
    with ``drop_path`` > 0 one per-row mask on each residual branch."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, drop_path: float = 0.0):
        super().__init__()
        self.drop_path = drop_path
        self.s_norm = LayerNorm(dim)
        self.s_attn = MHA(dim, num_heads, proj_drop=drop)
        self.mlp_norm = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.drop_path if self.training else 0.0
        y = self.s_attn(self.s_norm(x), generator)
        x = x + (drop_path(y, rate, generator) if rate > 0 else y)
        y = self.mlp(self.mlp_norm(x), generator)
        return x + (drop_path(y, rate, generator) if rate > 0 else y)


class TimeSformer(nn.Module):
    """TimeSformer video classifier: logits = model(x), x (B, T, H, W, C)
    normalized float → (B, num_class) fp32.

    ``use_kernels=False`` builds the plain reference (no attention kernel);
    ``flash`` picks the kernels for the divided blocks' spatial attention.
    Built in eval mode; ``train()`` turns on stochastic depth and the
    dropouts, whose masks come from ``forward``'s ``dropout_generator``.
    ``moe_experts > 0`` (divided attention) gives each block a ``MoEMlp``;
    the train-mode forward then returns ``(logits, None, moe_losses)``,
    the (2·L,) load-balance losses of the blocks' routing groups (the
    trainer adds ``moe_aux_weight`` × their mean).
    """

    # kernels whose JAX initializer is not lecun_normal, by module name
    # (``init_flax_variables``): the head normal(0.02), t_fc zero
    FLAX_KERNEL_INIT = {"fc": ("normal", 0.02), "t_fc": ("zeros", 0.0)}

    def __init__(self, num_class: int, num_segments: int = 8,
                 image_size: int = 224, patch_size: int = 16,
                 embed_dims: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 attention_type: str = "divided_space_time",
                 dtype: torch.dtype = torch.float32, flash: bool = True,
                 use_kernels: bool = True, dropout: float = 0.0,
                 drop_path_rate: float = 0.0, moe_experts: int = 0,
                 moe_capacity_factor: float = 1.25):
        super().__init__()
        if attention_type not in ATTENTION_TYPES:
            raise ValueError(f"Unknown attention type: {attention_type}")
        if embed_dims % num_heads:
            raise ValueError(f"embed_dims {embed_dims} % heads {num_heads}")
        self.num_class = num_class
        self.num_segments = num_segments
        self.patch_size = patch_size
        self.num_layers = num_layers
        self.attention_type = attention_type
        self.dtype = dtype
        self.dropout = dropout
        self.moe_experts = moe_experts if \
            attention_type == "divided_space_time" else 0
        self.fold_temporal_fc = False  # fold_for_inference sets it
        d = embed_dims
        p = (image_size // patch_size) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.weight = nn.Parameter(
            torch.zeros(d, 3, patch_size, patch_size))
        self.patch_embed.bias = nn.Parameter(torch.zeros(d))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.pos_embed = nn.Parameter(torch.zeros(1, p + 1, d))
        if attention_type != "space_only":
            self.time_embed = nn.Parameter(torch.zeros(1, num_segments, d))
        # per-layer stochastic-depth rates: linspace 0 → drop_path_rate
        rates = np.linspace(0.0, drop_path_rate, num_layers)
        for i in range(num_layers):
            if attention_type == "divided_space_time":
                blk = DividedBlock(d, num_heads, mlp_ratio,
                                   flash=flash and use_kernels, drop=dropout,
                                   drop_path=float(rates[i]),
                                   moe_experts=moe_experts,
                                   moe_capacity_factor=moe_capacity_factor)
            else:
                blk = JointBlock(d, num_heads, mlp_ratio, drop=dropout,
                                 drop_path=float(rates[i]))
            self.add_module(f"block_{i}", blk)
        self.norm = LayerNorm(d)
        self.fc = Dense(d, num_class)
        self.eval()

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None):
        """Logits of (B, T, H, W, C) clips. In train mode stochastic depth
        and the dropouts draw their masks from ``dropout_generator`` (the
        trainer seeds one per step), and a MoE model returns ``(logits,
        None, moe_losses)``."""
        b, t, hh, ww, c = x.shape
        if t != self.num_segments:
            raise ValueError(f"expected T={self.num_segments}, got {t}")
        g = dropout_generator
        rate = self.dropout if self.training else 0.0

        def drop(y):
            return dropout(y, rate, g) if rate > 0 else y

        dt = self.dtype
        ps = self.patch_size
        patches = conv2d_nhwc(x.reshape(b * t, hh, ww, c).to(dt),
                              self.patch_embed.weight, (ps, ps),
                              ((0, 0), (0, 0)), self.patch_embed.bias)
        d = patches.shape[-1]
        p = patches.shape[1] * patches.shape[2]
        patches = patches.reshape(b, t, p, d)
        cls_tok = drop((self.cls_token + self.pos_embed[:, :1]).to(dt)
                       .expand(b, 1, d))
        patches = drop(patches + self.pos_embed[None, :, 1:].to(dt))
        if self.attention_type != "space_only":
            patches = drop(patches + self.time_embed[:, :, None].to(dt))

        if self.attention_type == "divided_space_time":
            patches = patches.transpose(1, 2).contiguous()  # (B, P, T, D)
            losses = [] if self.moe_experts and self.training else None
            for blk in self.blocks():
                cls_tok, patches = blk(cls_tok, patches, g, losses)
            feat = self.norm(cls_tok[:, 0])
            if losses is not None:
                return self.fc(drop(feat)).float(), None, torch.stack(losses)
        elif self.attention_type == "joint_space_time":
            tokens = torch.cat(
                [cls_tok, patches.transpose(1, 2).reshape(b, p * t, d)], dim=1)
            for blk in self.blocks():
                tokens = blk(tokens, g)
            feat = self.norm(tokens[:, 0])
        else:  # space_only: per-frame ViT, cls features averaged over T
            tokens = torch.cat(
                [cls_tok[:, None].expand(b, t, 1, d).reshape(b * t, 1, d),
                 patches.reshape(b * t, p, d)], dim=1)
            for blk in self.blocks():
                tokens = blk(tokens, g)
            feat = self.norm(tokens[:, 0]).reshape(b, t, d).mean(dim=1)
        return self.fc(drop(feat)).float()


def fold_timesformer_tfc(params: Mapping[str, Any]) -> Dict[str, Any]:
    """Fold each divided block's ``t_fc`` into ``t_attn/proj`` on a
    flax-layout params tree (numpy): kernel Wp·Wt, bias bp·Wt + bt, in
    fp32; every ``t_fc`` is dropped. Inference only (exact: at inference
    nothing sits between the two layers)."""
    out = copy.deepcopy(dict(params))
    for key, blk in out.items():
        if not (key.startswith("block_") and isinstance(blk, dict)
                and "t_fc" in blk):
            continue
        proj = blk["t_attn"]["proj"]
        tfc = blk.pop("t_fc")
        wp, bp = (np.asarray(proj[n], np.float32) for n in ("kernel", "bias"))
        wt, bt = (np.asarray(tfc[n], np.float32) for n in ("kernel", "bias"))
        blk["t_attn"] = dict(blk["t_attn"])
        blk["t_attn"]["proj"] = {"kernel": wp @ wt, "bias": bp @ wt + bt}
    return out


def fold_for_inference(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with every ``t_fc`` folded into ``t_attn.proj``
    (W = W_tfc · W_proj, b = W_tfc · b_proj + b_tfc in torch's (out, in)
    layout, fp32, before any cast to the compute dtype), for inference
    only: its blocks refuse train mode, where drop_path and the dropouts
    sit between the two layers. The model itself is returned for anything
    but an unfolded divided TimeSformer."""
    if getattr(model, "attention_type", None) != "divided_space_time" \
            or getattr(model, "fold_temporal_fc", True):
        return model
    folded = copy.deepcopy(model)
    with torch.no_grad():
        for blk in folded.blocks():
            proj, tfc = blk.t_attn.proj, blk.t_fc
            wt = tfc.weight.double()
            proj.weight.copy_((wt @ proj.weight.double()).float())
            proj.bias.copy_((wt @ proj.bias.double() + tfc.bias.double())
                            .float())
            del blk.t_fc
            blk.fold_temporal_fc = True
    folded.fold_temporal_fc = True
    return folded
