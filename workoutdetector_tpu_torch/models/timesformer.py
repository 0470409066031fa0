"""TimeSformer — divided space-time attention video classifier.

Port of ``workoutdetector_tpu/models/timesformer.py`` for inference:
per-frame 16×16 patch embedding (cuDNN), cls token and position
embeddings, a time embedding over segments, then per block temporal
attention (per patch location, over T, through ``t_fc``), spatial
attention (per frame, the cls token replicated per frame and its outputs
averaged back over T) and an MLP, all pre-LayerNorm (eps 1e-6, exact
GELU); ``joint_space_time`` and ``space_only`` run standard ViT blocks.

Tokens live as (B, P, T, D) in the divided blocks, as in the JAX package.
On the main path (``flash=True``) the spatial attention of every divided
block is the hand attention kernel (``ops.kernels.attention``); the
temporal attention (l = T) and the joint blocks' attention are plain torch
ops, as they take the XLA path in the JAX package. Parameters are fp32,
compute runs in ``dtype``, logits come back fp32.

Not ported here (training only, or parallel work): stochastic depth,
dropout, ``seq_mesh``, ``block_barrier`` and the MoE MLP (ROADMAP).
"""

from __future__ import annotations

import copy
import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import Dense
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
    return torch.softmax((q @ k.transpose(-1, -2)) * scale, dim=-1) @ v


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

    ``flash=True`` runs softmax(q kᵀ) v through the attention kernel on the
    views of the packed projection (no copy); otherwise plain torch ops in
    the compute dtype, as the JAX package's XLA path.
    """

    def __init__(self, dim: int, num_heads: int, flash: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.flash = flash
        self.qkv = Dense(dim, 3 * dim)
        self.proj = Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, d = x.shape
        h = self.num_heads
        dh = d // h
        q, k, v = (t.view(n, l, h, dh).transpose(1, 2)
                   for t in self.qkv(x).split(d, dim=-1))  # (n, h, l, dh)
        attend = kernels.attention if self.flash else attention_xla
        out = attend(q, k, v, dh ** -0.5)
        return self.proj(out.transpose(1, 2).reshape(n, l, d))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = Dense(dim, hidden)
        self.fc2 = Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))  # exact (erf) GELU


class DividedBlock(nn.Module):
    """One divided space-time block: cls (B, 1, D) + patches (B, P, T, D)
    → same shapes. ``fold_temporal_fc``: t_fc is merged into t_attn.proj
    (``fold_for_inference``) and the block has no ``t_fc``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 flash: bool = False, fold_temporal_fc: bool = False):
        super().__init__()
        self.fold_temporal_fc = fold_temporal_fc
        self.t_norm = LayerNorm(dim)
        self.t_attn = MHA(dim, num_heads)
        if not fold_temporal_fc:
            self.t_fc = Dense(dim, dim)
        self.s_norm = LayerNorm(dim)
        self.s_attn = MHA(dim, num_heads, flash=flash)
        self.mlp_norm = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, cls_tok: torch.Tensor, patches: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        b, p, t, d = patches.shape
        # temporal attention per patch location, over T
        y = self.t_attn(self.t_norm(patches).reshape(b * p, t, d))
        y = y.reshape(b, p, t, d)
        if not self.fold_temporal_fc:
            y = self.t_fc(y)
        patches = patches + y

        # spatial attention per frame, the cls token replicated per frame
        sp = patches.transpose(1, 2).reshape(b * t, p, d)
        cls_rep = cls_tok[:, None].expand(b, t, 1, d).reshape(b * t, 1, d)
        sp = self.s_attn(self.s_norm(torch.cat([cls_rep, sp], dim=1)))
        cls_tok = cls_tok + sp[:, 0].reshape(b, t, d).mean(dim=1, keepdim=True)
        patches = patches + sp[:, 1:].reshape(b, t, p, d).transpose(1, 2)

        # one MLP over every token, cls and patches alike
        return (cls_tok + self.mlp(self.mlp_norm(cls_tok)),
                patches + self.mlp(self.mlp_norm(patches)))


class JointBlock(nn.Module):
    """Standard pre-LN ViT block over a flat token sequence."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.s_norm = LayerNorm(dim)
        self.s_attn = MHA(dim, num_heads)
        self.mlp_norm = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.s_attn(self.s_norm(x))
        return x + self.mlp(self.mlp_norm(x))


class TimeSformer(nn.Module):
    """TimeSformer video classifier: logits = model(x), x (B, T, H, W, C)
    normalized float → (B, num_class) fp32.

    ``use_kernels=False`` builds the plain reference (no attention kernel);
    ``flash`` picks the kernel for the divided blocks' spatial attention.
    Built in eval mode; training is not in the port yet.
    """

    def __init__(self, num_class: int, num_segments: int = 8,
                 image_size: int = 224, patch_size: int = 16,
                 embed_dims: int = 768, num_layers: int = 12,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 attention_type: str = "divided_space_time",
                 dtype: torch.dtype = torch.float32, flash: bool = True,
                 use_kernels: bool = True):
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
        for i in range(num_layers):
            if attention_type == "divided_space_time":
                blk = DividedBlock(d, num_heads, mlp_ratio,
                                   flash=flash and use_kernels)
            else:
                blk = JointBlock(d, num_heads, mlp_ratio)
            self.add_module(f"block_{i}", blk)
        self.norm = LayerNorm(d)
        self.fc = Dense(d, num_class)
        self.eval()

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_layers)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "TimeSformer training (dropout, stochastic depth, the "
                "attention backward) is queued as ROADMAP §1 slice 6")
        b, t, hh, ww, c = x.shape
        if t != self.num_segments:
            raise ValueError(f"expected T={self.num_segments}, got {t}")
        dt = self.dtype
        ps = self.patch_size
        patches = conv2d_nhwc(x.reshape(b * t, hh, ww, c).to(dt),
                              self.patch_embed.weight, (ps, ps),
                              ((0, 0), (0, 0)), self.patch_embed.bias)
        d = patches.shape[-1]
        p = patches.shape[1] * patches.shape[2]
        patches = patches.reshape(b, t, p, d)
        cls_tok = (self.cls_token + self.pos_embed[:, :1]).to(dt).expand(b, 1, d)
        patches = patches + self.pos_embed[None, :, 1:].to(dt)
        if self.attention_type != "space_only":
            patches = patches + self.time_embed[:, :, None].to(dt)

        if self.attention_type == "divided_space_time":
            patches = patches.transpose(1, 2).contiguous()  # (B, P, T, D)
            for blk in self.blocks():
                cls_tok, patches = blk(cls_tok, patches)
            feat = self.norm(cls_tok[:, 0])
        elif self.attention_type == "joint_space_time":
            tokens = torch.cat(
                [cls_tok, patches.transpose(1, 2).reshape(b, p * t, d)], dim=1)
            for blk in self.blocks():
                tokens = blk(tokens)
            feat = self.norm(tokens[:, 0])
        else:  # space_only: per-frame ViT, cls features averaged over T
            tokens = torch.cat(
                [cls_tok[:, None].expand(b, t, 1, d).reshape(b * t, 1, d),
                 patches.reshape(b * t, p, d)], dim=1)
            for blk in self.blocks():
                tokens = blk(tokens)
            feat = self.norm(tokens[:, 0]).reshape(b, t, d).mean(dim=1)
        return self.fc(feat).float()


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
    layout, fp32, before any cast to the compute dtype). The model itself
    is returned for anything but an unfolded divided TimeSformer."""
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
