"""Optimizer policies, LR schedules, gradient clipping and EMA in PyTorch.

Port of ``workoutdetector_tpu/train/optim.py``. The JAX package labels
every parameter with a TSN policy group and runs an optax
``multi_transform``; here the groups are ``torch.optim`` param groups:

    group              (lr_mult, decay_mult)
    first_conv_weight  (1, 1)    first_conv_bias (2, 0)
    normal_weight      (1, 1)    normal_bias     (2, 0)
    bn                 (1, 0)    frozen          (0, 0)  [partial BN]
    lr5_weight         (5, 1)    lr10_bias       (10, 0) [fc_lr5]

Equivalences with the optax chain (``_sgd_group``): weight decay is added
to the gradient before momentum (torch's SGD does the same), optax
``trace`` equals torch's momentum buffer with dampening 0, and the learning
rate is the schedule at the optimizer's update count taken before the
increment, times the group's ``lr_mult``. The frozen group is left out of
the torch optimizer, so it never moves; its parameters keep
``requires_grad`` because the global-norm clip, which wraps the whole
``multi_transform`` in the JAX package, counts every gradient.

With a ``StateLayout`` (``parallel/mesh.py``: sharded trainer state) the
optimizer updates each sharded parameter's block, so the momenta are
blocks too; its gradient is that block of the full (data-parallel
averaged) gradient; the clip's global norm sums each block's squares once
over the mesh (an all-reduce), and ``state_dict`` gathers the momenta
whole, so a checkpoint loads into any layout.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

POLICY_TABLE: Dict[str, Tuple[float, float]] = {
    "first_conv_weight": (1.0, 1.0),
    "first_conv_bias": (2.0, 0.0),
    "normal_weight": (1.0, 1.0),
    "normal_bias": (2.0, 0.0),
    "bn": (1.0, 0.0),
    "frozen": (0.0, 0.0),
    "lr5_weight": (5.0, 1.0),
    "lr10_bias": (10.0, 0.0),
}

# params exempted from weight decay by leaf name (TimeSformer tokens)
NO_DECAY_LEAVES = ("cls_token", "pos_embed", "time_embed")

Schedule = Callable[[int], float]


def flax_path(name: str, param: torch.Tensor) -> Tuple[str, ...]:
    """A port parameter name → its path in the flax tree: ``weight`` is
    ``kernel`` for a conv or dense weight and ``scale`` for a BN's, as
    ``models/convert.port_state_to_flax`` maps them."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "kernel" if param.dim() >= 2 else "scale"
    return tuple(mods) + (leaf,)


def _is_bn_module(mod: str) -> bool:
    return mod.startswith("bn") or mod.endswith("bn") or "BatchNorm" in mod


def _is_stem_bn(path: Tuple[str, ...]) -> bool:
    """The stem's bn1: the only BN that stays live under partial BN."""
    return path[-2] == "bn1" and not any(
        p.startswith("layer") or p.startswith("resnext") for p in path)


def classify_param(path: Tuple[str, ...], partial_bn: bool = True,
                   fc_lr5: bool = True) -> str:
    """A flax param path → its TSN policy group."""
    leaf = path[-1]
    mod = path[-2] if len(path) >= 2 else ""
    if _is_bn_module(mod) and leaf in ("scale", "bias"):
        if partial_bn and not _is_stem_bn(path):
            return "frozen"
        return "bn"
    if mod in ("fc", "new_fc", "head"):
        if fc_lr5:
            return "lr5_weight" if leaf == "kernel" else "lr10_bias"
        return "normal_weight" if leaf == "kernel" else "normal_bias"
    if mod == "conv1" and not any(
            p.startswith("layer") or p.startswith("resnext") or p == "mse"
            for p in path):
        return "first_conv_weight" if leaf == "kernel" else "first_conv_bias"
    if leaf == "kernel":
        return "normal_weight"
    return "normal_bias"


def label_params(named: Iterable[Tuple[str, torch.Tensor]],
                 partial_bn: bool = True, fc_lr5: bool = True
                 ) -> Dict[str, str]:
    """{port parameter name: policy group} for ``model.named_parameters()``."""
    return {n: classify_param(flax_path(n, p), partial_bn, fc_lr5)
            for n, p in named}


def build_schedule(cfg, base_lr: float, steps_per_epoch: int,
                   max_epochs: int) -> Schedule:
    """LR at update count n: steplr | cosine | multistep after an optional
    linear warmup from base_lr / warmup_multiplier (the optax schedules of
    the JAX package, evaluated in Python floats)."""
    policy = cfg.policy.lower()
    warmup = int(cfg.warmup_epochs * steps_per_epoch)
    main_epochs = max(max_epochs - cfg.warmup_epochs, 1)
    if policy in ("steplr", "step"):
        period = cfg.step * steps_per_epoch

        def main(n: int) -> float:
            if period <= 0:
                return base_lr
            return base_lr * cfg.gamma ** math.floor(n / period)
    elif policy == "cosine":
        decay = int(main_epochs * steps_per_epoch)
        alpha = cfg.eta_min / base_lr

        def main(n: int) -> float:
            frac = min(n, decay) / decay if decay > 0 else 1.0
            cos = 0.5 * (1 + math.cos(math.pi * frac))
            return base_lr * ((1 - alpha) * cos + alpha)
    elif policy == "multistep":
        bounds = sorted({int((m - cfg.warmup_epochs) * steps_per_epoch)
                         for m in cfg.lr_steps})

        def main(n: int) -> float:
            return base_lr * cfg.gamma ** sum(1 for b in bounds if n >= b)
    else:
        raise NotImplementedError(f"lr policy '{cfg.policy}' not supported")
    if warmup <= 0:
        return main
    start = base_lr / cfg.warmup_multiplier

    def schedule(n: int) -> float:
        if n < warmup:  # optax.linear_schedule's form
            return (start - base_lr) * (1 - n / warmup) + base_lr
        return main(n - warmup)
    return schedule


def global_norm(grads: List[torch.Tensor], names: Sequence[str] = (),
                layout=None) -> torch.Tensor:
    """sqrt(Σ ‖g‖²) over every gradient: fp32 squares summed in float64,
    returned in fp32. With a ``layout`` a sharded leaf's gradient
    (``names`` name them) is this rank's block: the blocks' squares are
    summed once over the mesh (an all-reduce). Summed in float64, the
    blocks' total rounds to the same fp32 norm as the whole leaves' (not
    so in fp32), so a sharded run clips as the unsharded one does."""
    if not grads:
        return torch.zeros(())
    zero = grads[0].new_zeros((), dtype=torch.float64)

    def squares(gs):
        return sum((g.float().square().sum(dtype=torch.float64) for g in gs),
                   zero)

    if layout is None or not layout.specs:
        return torch.sqrt(squares(grads)).float()
    whole = [g for n, g in zip(names, grads) if not layout.sharded(n)]
    blocks = [g for n, g in zip(names, grads)
              if layout.sharded(n) and layout.owns(n)]
    mesh = layout.mesh
    shared = mesh.comm.all_reduce(squares(blocks).reshape(1),
                                  mesh.all_group)[0]
    return torch.sqrt(squares(whole) + shared).float()


class TrainOptimizer:
    """The JAX package's full update: global-norm clip (or its delayed
    variant) over every gradient, the policy-group (or flat) SGD / AdamW
    step at the scheduled learning rate, and gradient accumulation.

    ``step()`` reads ``p.grad`` of every parameter. With
    ``grad_accum_steps`` k > 1 it keeps the running mean of k micro-batch
    gradients (``optax.MultiSteps``, which wraps the clip too) and on every
    k-th call clips that mean and updates the parameters; the schedule
    counts updates, not calls.
    """

    def __init__(self, model: torch.nn.Module, opt_cfg, sched_cfg,
                 steps_per_epoch: int, max_epochs: int,
                 partial_bn: bool = True, fc_lr5: bool = True,
                 grad_accum_steps: int = 1, layout=None):
        self.layout = layout
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.sources = [p for _, p in named]  # their .grad is read
        if layout is not None:  # sharded leaves update their blocks
            named = [(n, layout.shards.get(n, p)) for n, p in named]
        self.params = [p for _, p in named]
        self.schedule = build_schedule(sched_cfg, opt_cfg.lr, steps_per_epoch,
                                       max_epochs)
        self.max_norm = opt_cfg.grad_clip
        self.delayed = opt_cfg.grad_clip_delayed
        self.accum = max(grad_accum_steps, 1)
        self.count = 0       # parameter updates made (the schedule's count)
        self.mini_step = 0   # micro-batches accumulated toward the next one
        self.prev_norm: Optional[torch.Tensor] = None  # the delayed clip's state
        self._acc: Optional[List[torch.Tensor]] = None
        method = opt_cfg.method.lower()
        if opt_cfg.use_tsn_policies and method == "sgd":
            labels = label_params(named, partial_bn, fc_lr5)
            groups = []
            for label, (lr_mult, decay_mult) in POLICY_TABLE.items():
                ps = [p for n, p in named if labels[n] == label]
                if ps and lr_mult > 0:
                    groups.append(dict(params=ps, lr_mult=lr_mult,
                                       weight_decay=opt_cfg.weight_decay
                                       * decay_mult))
            self.opt = torch.optim.SGD(groups, lr=opt_cfg.lr,
                                       momentum=opt_cfg.momentum,
                                       nesterov=opt_cfg.nesterov)
        elif method in ("sgd", "adamw"):
            decay = [p for n, p in named
                     if n.rsplit(".", 1)[-1] not in NO_DECAY_LEAVES]
            keep = [p for n, p in named
                    if n.rsplit(".", 1)[-1] in NO_DECAY_LEAVES]
            groups = [dict(params=ps, lr_mult=1.0, weight_decay=wd)
                      for ps, wd in ((decay, opt_cfg.weight_decay), (keep, 0.0))
                      if ps]
            if method == "sgd":
                self.opt = torch.optim.SGD(groups, lr=opt_cfg.lr,
                                           momentum=opt_cfg.momentum,
                                           nesterov=opt_cfg.nesterov)
            else:
                self.opt = torch.optim.AdamW(groups, lr=opt_cfg.lr,
                                             eps=opt_cfg.eps)
        else:
            raise NotImplementedError(
                f"optimizer '{opt_cfg.method}' not supported")
        # torch's state index of each parameter → its name
        ids = {id(p): n for n, p in named}
        self._index_names = [ids[id(p)] for g in self.opt.param_groups
                             for p in g["params"]]

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm <= 0:
            return
        norm = global_norm(grads, self.names, self.layout)
        if self.delayed:  # scale by the previous call's raw norm
            prev, self.prev_norm = self.prev_norm, norm
            if prev is not None:
                scale = torch.clamp(self.max_norm / torch.clamp(prev, min=1e-16),
                                    max=1.0)
                for g in grads:
                    g.mul_(scale.to(g.dtype))
            return
        # optax: g unchanged below max_norm, else (g / norm) * max_norm;
        # selected on the device, so the step never waits for the norm
        under = norm < self.max_norm
        div = torch.where(under, torch.ones_like(norm), norm)
        mul = torch.where(under, torch.ones_like(norm),
                          torch.full_like(norm, self.max_norm))
        for g in grads:
            g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))

    @torch.no_grad()
    def step(self) -> bool:
        """Apply one call's gradients; True when the parameters moved."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.sources]
        if self.layout is not None:
            grads = [self.layout.local(n, g) for n, g in zip(self.names, grads)]
        if self.accum > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            k = self.mini_step
            for a, g in zip(self._acc, grads):  # running mean of the calls
                a.add_((g - a) / (k + 1))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return False
            grads, self._acc, self.mini_step = self._acc, None, 0
        self._clip(grads)
        lr = self.schedule(self.count)
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.opt.step()
        self.count += 1
        return True

    def zero_grad(self) -> None:
        for p in self.sources + self.params:
            p.grad = None

    def state_dict(self) -> dict:
        """The optimizer's state, sharded momenta gathered whole (a
        collective under a layout)."""
        opt = self.opt.state_dict()
        acc = self._acc
        if self.layout is not None and self.layout.specs:
            blocks, names = {}, {}
            for i, st in opt["state"].items():
                n = self._index_names[i]
                for k, v in st.items():
                    if self.layout.sharded(n) and torch.is_tensor(v) and v.dim():
                        blocks[(i, k)], names[(i, k)] = v, n
            if acc is not None:
                for j, (n, a) in enumerate(zip(self.names, acc)):
                    if self.layout.sharded(n):
                        blocks[("acc", j)], names[("acc", j)] = a, n
            full = self.layout.gather(blocks, names)
            opt["state"] = {i: {k: full.get((i, k), v) for k, v in st.items()}
                            for i, st in opt["state"].items()}
            if acc is not None:
                acc = [full.get(("acc", j), a) for j, a in enumerate(acc)]
        return {"opt": opt, "count": self.count,
                "mini_step": self.mini_step, "prev_norm": self.prev_norm,
                "acc": acc}

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict()`` of any layout, its tensors moved to
        the parameters' device (a checkpoint loads on the CPU) and cut to
        this rank's blocks under a layout."""
        opt = state["opt"]
        if self.layout is not None:
            cut = self.layout.local
            opt = dict(opt, state={
                i: {k: cut(self._index_names[i], v)
                    if torch.is_tensor(v) and v.dim() else v
                    for k, v in st.items()}
                for i, st in opt["state"].items()})
        self.opt.load_state_dict(opt)
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        dev = self.params[0].device if self.params else None
        prev = state["prev_norm"]
        self.prev_norm = prev.to(dev) if prev is not None else None
        acc = state["acc"]
        if acc is not None and self.layout is not None:
            acc = [self.layout.local(n, a) for n, a in zip(self.names, acc)]
        self._acc = [a.to(p.device) for a, p in zip(acc, self.params)] \
            if acc is not None else None


class EMA:
    """Exponential moving average of the parameters, a distinct copy:
    ``e ← e·decay + p·(1 − decay)`` after every train step (no debias),
    seeded at the parameters it is built from. Under a ``StateLayout`` a
    sharded parameter's average is its block, like the parameter."""

    def __init__(self, model: torch.nn.Module, decay: float, layout=None):
        self.decay = decay
        self.layout = layout
        self.params = {n: self._source(n, p).detach().clone()
                       for n, p in model.named_parameters()}

    def _source(self, name: str, p: torch.Tensor) -> torch.Tensor:
        if self.layout is not None and self.layout.sharded(name):
            return self.layout.shards[name]
        return p

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        d = self.decay
        for n, p in model.named_parameters():
            e = self.params[n]
            e.copy_(e * d + self._source(n, p) * (1.0 - d))

    def full_params(self) -> Dict[str, torch.Tensor]:
        """The averages whole (a collective under a layout)."""
        if self.layout is None or not self.layout.specs:
            return self.params
        sharded = {n: e for n, e in self.params.items()
                   if self.layout.sharded(n)}
        return dict(self.params, **self.layout.gather(
            sharded, {n: n for n in sharded}))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.full_params()

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        """Averages of any layout, cut to this rank's blocks."""
        with torch.no_grad():
            for n, e in self.params.items():
                full = state[n]
                if self.layout is not None:
                    full = self.layout.local(n, full)
                e.copy_(full)
