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

Over a mesh (``set_moe_mesh``: the trainer's ``parallel/mesh.Mesh``) the
routing group of a call is still every token of the GLOBAL batch, in
JAX's order, whatever the layout (the JAX module runs inside one SPMD
step, where ``x.reshape(1, -1, d)`` is the global array): the capacity
is that of the global token count, a token's slot is its rank among the
global tokens routed to its expert, and ``frac`` and ``prob`` are global
means. Each rank's tokens are ``rows`` leading rows (the batch rows it
holds) of ``chunk`` tokens each, a chunk contiguous in the global order;
the per-(row, expert) counts of every rank that holds distinct tokens
(the data ranks, and the ``model`` ranks too where the call's tokens are
sharded over ``model``: ``split``) are all-gathered and their exclusive
scan in global order gives each chunk's offsets. The tokens routed to
each expert and the gate sums (differentiably) are summed over the same
ranks, so every rank computes the global load-balance loss.

Expert parallelism (``set_moe_mesh`` where the ``model`` axis divides
E): ``model`` rank r holds experts
[r·E/m, (r+1)·E/m) of ``w1``, ``b1``, ``w2`` and ``b2`` at rest and in
compute (``compute_sharded``: ``StateLayout`` never gathers them) and
computes only its experts' slots. Tokens replicated over ``model``: each
rank takes its experts' block of the slot buffer that every rank builds
alike (``share_block``) and the experts' outputs are all-gathered
(``gather_blocks``), whose backward sums the ranks' gradients of them (a
reduce-scatter); the block's backward hands every rank the whole
gradient of the buffer, so what the ``model`` ranks hold alike runs the
one-process forward and backward, bf16 rounding included. Tokens sharded
over ``model`` (sequence parallelism) reach their experts' rank by an
all-to-all of each rank's (E/m, cap, d) slot buffers, disjoint across
senders, and the outputs come back by the inverse one. The slots,
capacity and drops are those of the one-process module.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from workoutdetector_tpu_torch.models.resnet import Dense
from workoutdetector_tpu_torch.models.tsm import Split, dropout, uniform
from workoutdetector_tpu_torch.parallel.distributed import (all_to_all,
                                                            gather_blocks,
                                                            group_sum,
                                                            share_block)
from workoutdetector_tpu_torch.parallel.mesh import dp_size, param_spec

EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert for a routing group of ``tokens`` tokens."""
    return max(1, int(-(-tokens // num_experts) * capacity_factor))


class MoEMlp(nn.Module):
    """Tokens (..., d) → (..., d) through one of ``num_experts`` expert
    FFNs (d → hidden → d) each, plus the call's load-balance loss.
    Parameters are fp32 (the router's ``weight`` (E, d) and ``bias``; the
    experts' ``w1`` (E, d, hidden), ``b1`` (E, 1, hidden), ``w2`` (E,
    hidden, d), ``b2`` (E, 1, d), the flax leaves as they lie; E/m of them
    under expert parallelism); the experts compute in x's dtype, the
    router in fp32."""

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
        self.mesh = None  # the routing group's mesh (``set_moe_mesh``)
        self.experts: Optional[Tuple[int, int]] = None  # [lo, hi) held
        # tokens dropped since the last ``pop_drops`` (a device count)
        self.dropped: Optional[torch.Tensor] = None

    def compute_sharded(self) -> Dict[str, Tuple[str, ...]]:
        """The expert stacks under expert parallelism: the ``model`` axis
        shards them in compute too (``parallel/mesh.compute_sharded``)."""
        if self.experts is None:
            return {}
        return {n: ("model",) for n in EXPERT_LEAVES}

    def routing_mask(self, expert: torch.Tensor) -> torch.Tensor:
        """(E, t) bool: token j routed to expert i."""
        arange = torch.arange(self.num_experts, device=expert.device)
        return expert[None, :] == arange[:, None]

    def _scan_group(self, split: Optional[Split]):
        """(process group, data ways, model ways) of the ranks whose tokens
        make up this call's routing group; group None where this rank's
        tokens are the whole group."""
        mesh = self.mesh
        n_dp = dp_size(mesh) if mesh is not None else 1
        n_m = split.n if split is not None and split.n > 1 else 1
        if n_dp * n_m == 1:
            return None, 1, 1
        return (mesh.all_group if n_m > 1 else mesh.dp_group), n_dp, n_m

    def route(self, tokens: torch.Tensor, rows: int = 1,
              split: Optional[Split] = None):
        """(t, d) tokens, ``rows`` chunks of contiguous global order →
        (gates (t, E) fp32, expert (t,), slot (t,) 1-based int32, capacity)
        of the call's routing group. The slots are a scan along each
        chunk of the routing mask's contiguous token axis (a scan down the
        columns of a (t, E) one-hot runs only E lanes over t rows) plus
        the chunk's offsets: the exclusive scan, in global order, of every
        rank's per-(row, expert) counts."""
        e = self.num_experts
        t = tokens.shape[0]
        gates = torch.softmax(self.router(tokens.float()), dim=-1)
        expert = gates.argmax(dim=-1)
        mask = self.routing_mask(expert).view(e, rows, t // rows)
        within = torch.cumsum(mask, dim=2, dtype=torch.int32)
        counts = within[:, :, -1].t().contiguous()  # (rows, E)
        group, n_dp, n_m = self._scan_group(split)
        every = counts.unsqueeze(0) if group is None else \
            torch.stack(self.mesh.comm.all_gather(counts, group))
        # members in (data, model) order → (data, row, model) global order
        c = every.view(n_dp, n_m, rows, e).transpose(1, 2).reshape(-1, e)
        before = (torch.cumsum(c, 0, dtype=torch.int32) - c).view(
            n_dp, rows, n_m, e)
        me_dp = self.mesh.dp_index if n_dp > 1 else 0
        me_m = split.index if n_m > 1 else 0
        offsets = before[me_dp, :, me_m].t()  # (E, rows)
        slots = (within + offsets[:, :, None]).view(e, t)
        slot = slots.gather(0, expert[None, :])[0]
        return gates, expert, slot, capacity(t * n_dp * n_m, e,
                                             self.capacity_factor)

    def forward(self, x: torch.Tensor,
                generator=None, split: Optional[Split] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``x`` (rows, ..., d): rows are batch rows, each a contiguous run
        of the global token order. ``split``: the tokens of a row are block
        ``split.index`` of ``split.n`` over the ``model`` group (sequence
        parallelism); None where every ``model`` rank holds them all."""
        shape = x.shape
        d = shape[-1]
        e = self.num_experts
        tokens = x.reshape(-1, d)
        t = tokens.shape[0]
        rows = shape[0] if x.dim() > 2 else 1
        gates, expert, slot, cap = self.route(tokens, rows, split)
        # the load-balance loss's means over the routing group: the tokens
        # routed to each expert and the gates summed over its ranks
        routed = self.routing_mask(expert).sum(1)
        gate_sum = gates.sum(0)
        group, n_dp, n_m = self._scan_group(split)
        if group is not None:
            routed = self.mesh.comm.all_reduce(routed, group)
            gate_sum = group_sum(gate_sum, self.mesh.comm, group)
        total = t * n_dp * n_m
        gate_p = gates.gather(1, expert[:, None])[:, 0]
        loss = e * (routed.float() / total * (gate_sum / total)).sum()
        if not torch.compiler.is_compiling():  # no state in an export
            drops = (routed - cap).clamp(min=0).sum()
            self.dropped = drops if self.dropped is None else \
                self.dropped + drops

        # every token a row of its own in an (E·cap + t) buffer: its
        # expert's slot, or (dropped, or another rank's expert) a spare
        # row past the slots that no expert reads. With no index repeated,
        # dispatch (a copy in) and combine (a gather out) have gathers for
        # backwards, and no scatter-add meets a repeated row
        dest = torch.where(slot <= cap, expert * cap + slot - 1,
                           e * cap + torch.arange(t, device=x.device))
        buf = tokens.new_zeros(e * cap + t, d).index_copy(0, dest, tokens)
        xe = buf[:e * cap].view(e, cap, d)
        lo, hi = self.experts if self.experts is not None else (0, e)
        held = hi - lo
        ep = self.experts is not None
        seq = ep and split is not None and split.n > 1
        if seq:  # every expert's slots, sent to the experts' ranks
            xe = self._a2a(xe.reshape(split.n, held * cap, d))
            xe = xe.sum(0).view(held, cap, d)
        elif ep:  # the same tokens on every model rank: its experts' slots
            m = self.mesh.size("model")
            xe = share_block(xe, self.mesh.comm, self.mesh.group("model"),
                             lo // held, m)

        dt = x.dtype
        h = torch.baddbmm(self.b1.to(dt), xe, self.w1.to(dt))
        h = F.gelu(h)  # exact (erf) GELU
        train_drop = self.training and self.drop > 0
        if train_drop:  # the whole (E, cap, hidden) draw, this rank's rows
            base = getattr(generator, "generator", generator)
            keep_p = 1.0 - self.drop
            u = uniform((e, cap, h.shape[-1]), base, h.device)[lo:hi]
            h = torch.where(u < keep_p, h / keep_p,
                            torch.zeros((), dtype=dt, device=h.device))
        out = torch.baddbmm(self.b2.to(dt), h, self.w2.to(dt))
        if seq:  # each sender gets every expert's outputs back
            out = self._a2a(out.reshape(1, held * cap, d).expand(
                split.n, held * cap, d))
        elif ep:  # every expert's outputs on every model rank
            out = gather_blocks(out, self.mesh.comm, self.mesh.group("model"),
                                lo // held)
        out = torch.cat([out.reshape(e * cap, d), out.new_zeros(t, d)])
        y = out.index_select(0, dest) * gate_p.to(dt)[:, None]
        if train_drop:
            y = dropout(y, self.drop, generator,
                        None if split is None else
                        Split(t // rows, split.n, split.index))
        return y.reshape(shape), loss

    def _a2a(self, t: torch.Tensor) -> torch.Tensor:
        return all_to_all(t.contiguous(), self.mesh.comm,
                          self.mesh.group("model"))


def set_moe_mesh(model: nn.Module, mesh) -> int:
    """Give every ``MoEMlp`` of ``model`` the mesh whose global batch is
    its routing group (None: the call's own tokens) and, where the
    ``model`` axis shards the expert stacks (``param_spec``), its block of
    experts: expert parallelism. Call it before the model's state is laid
    out (``StateLayout``), on full expert stacks; returns the experts each
    rank holds (E when not expert-parallel)."""
    held = 0
    for mod in model.modules():
        if not isinstance(mod, MoEMlp):
            continue
        mod.mesh = mesh
        mod.experts = None
        e = mod.num_experts
        held = e
        if mesh is None or mesh.size("model") <= 1:
            continue
        if all(param_spec(tuple(getattr(mod, n).shape), mesh,
                          kernel=False)[:1] == ("model",)
               for n in EXPERT_LEAVES):
            k = e // mesh.size("model")
            lo = mesh.coords["model"] * k
            mod.experts = (lo, lo + k)
            held = k
    return held


def pop_drops(model: nn.Module) -> int:
    """The tokens that every ``MoEMlp`` of ``model`` dropped (past its
    experts' capacity) in the calls since the last pop, over each call's
    whole routing group (the same count on every rank of a mesh)."""
    total = 0
    for mod in model.modules():
        if isinstance(mod, MoEMlp):
            if mod.dropped is not None:
                total += int(mod.dropped)
            mod.dropped = None
    return total
