"""RepNet-style learnable period estimator.

Port of ``workoutdetector_tpu/models/repnet.py`` (``RepNet``,
``REPNET_VARIANTS``, ``period_of_class``, ``count_from_frame_logits``):

  frames → per-frame embeddings → temporal self-similarity matrix
  → 3×3 conv → one transformer block → per-frame period classification

Class convention: id 0 = aperiodic; id k ≥ 1 = a period of k + 1 frames;
``num_class = T // 2``.

Layout and precision follow the JAX module:
  * the encoder's four 3×3 stride-2 convs pad as flax's default
    ``'SAME'`` (XLA's rule: at an even size (0, 1), not (1, 1)), each
    followed by a BatchNorm (momentum 0.9, eps 1e-5; folded into the conv
    at inference) and ReLU;
  * the embedding is cast to fp32 before ``embed_norm``, and the
    self-similarity (gram, squared norms, the softmax of −distance / τ,
    τ = 13.544) is fp32; from ``sim_conv`` on the model runs in ``dtype``;
  * ``sim_conv``'s output is NHWC (B, T, T, 32) flattened to (B, T, T·32),
    features in (column, channel) order;
  * the attention is plain torch ops (the JAX model takes the XLA path:
    ``MHA`` with ``flash`` off), the MLP's GELU flax's tanh form.

No hand kernel runs here. In train mode the forward returns ``(logits,
frame_logits)`` (the frame-mean consensus and the (B, T, C) per-frame
logits the trainer supervises densely); in eval mode the consensus, or
with ``per_frame=True`` the per-frame logits, which counting needs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import BatchNorm, Conv, Dense
from workoutdetector_tpu_torch.models.timesformer import MHA, LayerNorm
from workoutdetector_tpu_torch.models.tsm import dropout

# base_model → (encoder width, embed dim, transformer dim, heads)
REPNET_VARIANTS = {
    "base": (32, 128, 512, 4),
    "small": (16, 64, 128, 4),
    "tiny": (8, 32, 64, 2),
}

# softmax temperature over the negative squared distances
SIM_TEMPERATURE = 13.544


def period_of_class(class_id):
    """Class id k ≥ 1 → period in frames (k + 1); 0 is aperiodic."""
    return class_id + 1


class RepNet(nn.Module):
    """Per-window period classifier over T = ``num_segments`` frames:
    x (B, T, H, W, C) normalized float → (B, T // 2) fp32 logits."""

    # initializers that are not flax's defaults (``init_flax_variables``):
    # pos_embed is normal(0.02), not truncated
    FLAX_KERNEL_INIT = {"pos_embed": ("normal", 0.02)}

    def __init__(self, num_segments: int = 64, width: int = 32,
                 embed_dim: int = 128, model_dim: int = 512,
                 num_heads: int = 4, sim_channels: int = 32,
                 dropout: float = 0.25, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_segments = num_segments
        self.num_class = num_segments // 2
        self.embed_dim = embed_dim
        self.dropout = dropout
        self.dtype = dtype
        cin = 3
        for i in range(4):
            cout = width * 2 ** min(i, 3)
            self.add_module(f"enc_conv{i}", Conv(cin, cout, 3, stride=2,
                                                 pad="SAME"))
            self.add_module(f"BatchNorm_{i}", BatchNorm(cout))
            cin = cout
        self.embed = Dense(cin, embed_dim)
        self.embed_norm = LayerNorm(embed_dim)
        self.sim_conv = Conv(1, sim_channels, 3, pad="SAME", bias=True)
        self.proj = Dense(num_segments * sim_channels, model_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, num_segments, model_dim))
        self.attn_norm = LayerNorm(model_dim)
        self.attn = MHA(model_dim, num_heads, flash=False, proj_drop=dropout)
        self.mlp_norm = LayerNorm(model_dim)
        self.mlp_fc1 = Dense(model_dim, model_dim * 2)
        self.mlp_fc2 = Dense(model_dim * 2, model_dim)
        self.period_fc = Dense(model_dim, self.num_class)
        self.eval()

    def self_similarity(self, emb: torch.Tensor) -> torch.Tensor:
        """(B, T, D) fp32 embeddings → (B, T, T) softmax(−‖eᵢ − eⱼ‖² / τ)
        over j, from one batched matmul."""
        gram = emb @ emb.transpose(1, 2)
        sq = (emb * emb).sum(-1)
        dist = sq[:, :, None] + sq[:, None, :] - 2.0 * gram
        return torch.softmax(-dist / SIM_TEMPERATURE, dim=-1)

    def forward(self, x: torch.Tensor,
                dropout_generator: Optional[torch.Generator] = None,
                per_frame: bool = False):
        b, t, h, w, c = x.shape
        if t != self.num_segments:
            raise ValueError(f"window length {t} != num_segments "
                             f"{self.num_segments}")
        g = dropout_generator
        rate = self.dropout if self.training else 0.0
        dt = self.dtype
        y = x.reshape(b * t, h, w, c).to(dt)
        for i in range(4):  # BN folded into the conv at inference
            y = F.relu(getattr(self, f"enc_conv{i}")(
                y, getattr(self, f"BatchNorm_{i}")))
        emb = self.embed(y.mean(dim=(1, 2)))
        emb = self.embed_norm(emb.reshape(b, t, self.embed_dim).float())

        sim = self.self_similarity(emb)
        f = F.relu(self.sim_conv(sim[..., None].to(dt)))
        f = self.proj(f.reshape(b, t, -1))
        f = f + self.pos_embed.to(dt)

        f = f + self.attn(self.attn_norm(f), g)
        m = self.mlp_fc1(self.mlp_norm(f))
        f = f + self.mlp_fc2(F.gelu(m, approximate="tanh"))
        if rate > 0:
            f = dropout(f, rate, g)
        frame_logits = self.period_fc(f).float()  # (B, T, C)
        if self.training:
            return frame_logits.mean(dim=1), frame_logits
        if per_frame:
            return frame_logits
        return frame_logits.mean(dim=1)


def count_from_frame_logits(frame_logits: np.ndarray,
                            valid: Optional[np.ndarray] = None,
                            min_periodicity: float = 0.5
                            ) -> Tuple[float, float]:
    """Frame logits → (fractional rep count, mean periodicity).

    count = Σ_t 1 / period(t) over the frames whose periodic probability
    (1 − P[class 0]) reaches ``min_periodicity``; rate-invariant, so one
    model covers every frame rate.

    Args:
        frame_logits: (..., T, C) array (any leading batch dims).
        valid: optional (..., T) bool mask (False = padding frames).
    """
    x = np.asarray(frame_logits, np.float32)
    x = x - x.max(axis=-1, keepdims=True)
    p = np.exp(x)
    p /= p.sum(axis=-1, keepdims=True)
    periodic = 1.0 - p[..., 0]
    best = np.argmax(p[..., 1:], axis=-1) + 1  # best periodic class id
    contrib = np.where(periodic >= min_periodicity,
                       1.0 / period_of_class(best), 0.0)
    if valid is not None:
        contrib = np.where(valid, contrib, 0.0)
        periodic = np.where(valid, periodic, 0.0)
        n = max(int(np.sum(valid)), 1)
    else:
        n = periodic.size
    return float(contrib.sum()), float(periodic.sum() / n)
