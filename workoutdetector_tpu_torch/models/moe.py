"""Mixture-of-Experts MLP: top-1 routing to one of E expert FFNs.

Port of ``workoutdetector_tpu/models/moe.py`` (``MoEMlp``), the Switch
MLP of TimeSformer's divided blocks (``moe_experts > 0``):

  * router: one fp32 Dense(E) per token, softmax gate, top-1 expert (the
    first of equal maxima, as ``jnp.argmax``);
  * capacity: each expert takes at most
    ``max(1, int(ceil(t / E) · capacity_factor))`` of the call's t tokens
    (one routing group); a token's slot is its rank among the tokens
    routed to its expert, in token order, and a token past its expert's
    capacity gives output 0 (the block's residual carries it);
  * the expert's output is scaled by the chosen gate's probability (in
    inference too), the router's gradient path;
  * exact (erf) GELU, a dropout after it and one on the output;
  * the Switch load-balance loss ``E · Σ_e frac_e · prob_e`` (frac: the
    share of tokens routed to e, prob: its mean gate).

The JAX module dispatches and combines through (t, E, cap) one-hot
einsums. Here dispatch copies each token into its slot of fixed (E,
cap, d) buffers and combine gathers each token's slot back; the result is
the same, and the work is the experts' products alone (the
einsums would cost t·E·cap·d multiply-adds each: ≈ 6·10¹⁴ FLOP a block at
TimeSformer-B/16 batch 16). Every shape is static (no ``nonzero``, no
boolean indexing), so ``torch.export`` traces the model. The expert
products are batched matmuls (the JAX package's XLA einsums); no hand
kernel.

``forward`` returns ``(y, moe_loss)``; the divided block hands the losses
of its two calls (cls tokens, patches) to the model, whose train-mode
forward returns them to the trainer (``train.trainer.train_loss``), as
the JAX module sows ``moe_loss``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import Dense
from workoutdetector_tpu_torch.models.tsm import dropout


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert for a routing group of ``tokens`` tokens."""
    return max(1, int(-(-tokens // num_experts) * capacity_factor))


class MoEMlp(nn.Module):
    """Tokens (..., d) → (..., d) through one of ``num_experts`` expert
    FFNs (d → hidden → d) each, plus the call's load-balance loss.
    Parameters are fp32 (the router's ``weight`` (E, d) and ``bias``; the
    experts' ``w1`` (E, d, hidden), ``b1`` (E, 1, hidden), ``w2`` (E,
    hidden, d), ``b2`` (E, 1, d), the flax leaves as they lie); the experts
    compute in x's dtype, the router in fp32."""

    def __init__(self, dim: int, hidden: int, num_experts: int,
                 capacity_factor: float = 1.25, drop: float = 0.0):
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.drop = drop
        self.router = Dense(dim, num_experts)
        self.w1 = nn.Parameter(torch.zeros(num_experts, dim, hidden))
        self.b1 = nn.Parameter(torch.zeros(num_experts, 1, hidden))
        self.w2 = nn.Parameter(torch.zeros(num_experts, hidden, dim))
        self.b2 = nn.Parameter(torch.zeros(num_experts, 1, dim))

    def routing_mask(self, expert: torch.Tensor) -> torch.Tensor:
        """(E, t) bool: token j routed to expert i."""
        arange = torch.arange(self.num_experts, device=expert.device)
        return expert[None, :] == arange[:, None]

    def route(self, tokens: torch.Tensor):
        """(t, d) tokens → (gates (t, E) fp32, expert (t,), slot (t,)
        1-based int32, capacity). The slots are a scan along the routing
        mask's contiguous token axis (a scan down the columns of a (t, E)
        one-hot runs only E lanes over t rows)."""
        e = self.num_experts
        t = tokens.shape[0]
        gates = torch.softmax(self.router(tokens.float()), dim=-1)
        expert = gates.argmax(dim=-1)
        slots = torch.cumsum(self.routing_mask(expert), dim=1,
                             dtype=torch.int32)
        slot = slots.gather(0, expert[None, :])[0]
        return gates, expert, slot, capacity(t, e, self.capacity_factor)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = x.shape
        d = shape[-1]
        e = self.num_experts
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        gates, expert, slot, cap = self.route(tokens)
        gate_p = gates.gather(1, expert[:, None])[:, 0]

        frac = self.routing_mask(expert).float().mean(1)
        loss = e * (frac * gates.mean(0)).sum()

        # every token a row of its own in an (E·cap + t) buffer: its
        # expert's slot, or (dropped) a spare row past the E·cap slots
        # that no expert reads. With no index repeated, dispatch (a copy
        # in) and combine (a gather out) have gathers for backwards, and
        # no scatter-add meets a repeated row
        dest = torch.where(slot <= cap, expert * cap + slot - 1,
                           e * cap + torch.arange(t, device=x.device))
        buf = tokens.new_zeros(e * cap + t, d).index_copy(0, dest, tokens)
        xe = buf[:e * cap].view(e, cap, d)

        dt = x.dtype
        h = torch.baddbmm(self.b1.to(dt), xe, self.w1.to(dt))
        h = F.gelu(h)  # exact (erf) GELU
        train_drop = self.training and self.drop > 0
        if train_drop:
            h = dropout(h, self.drop, generator)
        out = torch.baddbmm(self.b2.to(dt), h, self.w2.to(dt))
        out = torch.cat([out.reshape(e * cap, d), out.new_zeros(t, d)])
        y = out.index_select(0, dest) * gate_p.to(dt)[:, None]
        if train_drop:
            y = dropout(y, self.drop, generator)
        return y.reshape(shape), loss
