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
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Tuple

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


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ ‖g‖²) over every gradient, in fp32."""
    if not grads:
        return torch.zeros(())
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


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
                 grad_accum_steps: int = 1):
        self.params = [p for p in model.parameters() if p.requires_grad]
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
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
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

    @torch.no_grad()
    def _clip(self, grads: List[torch.Tensor]) -> None:
        if self.max_norm <= 0:
            return
        norm = global_norm(grads)
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
                 for p in self.params]
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
        for p in self.params:
            p.grad = None

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "count": self.count,
                "mini_step": self.mini_step, "prev_norm": self.prev_norm,
                "acc": self._acc}

    def load_state_dict(self, state: dict) -> None:
        """Restore a ``state_dict()``, its tensors moved to the parameters'
        device (a checkpoint loads on the CPU)."""
        self.opt.load_state_dict(state["opt"])
        self.count = state["count"]
        self.mini_step = state["mini_step"]
        dev = self.params[0].device if self.params else None
        prev = state["prev_norm"]
        self.prev_norm = prev.to(dev) if prev is not None else None
        acc = state["acc"]
        self._acc = [a.to(p.device) for a, p in zip(acc, self.params)] \
            if acc is not None else None


class EMA:
    """Exponential moving average of the parameters, a distinct copy:
    ``e ← e·decay + p·(1 − decay)`` after every train step (no debias),
    seeded at the parameters it is built from."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = decay
        self.params = {n: p.detach().clone()
                       for n, p in model.named_parameters()}

    @torch.no_grad()
    def update(self, model: torch.nn.Module) -> None:
        d = self.decay
        for n, p in model.named_parameters():
            e = self.params[n]
            e.copy_(e * d + p * (1.0 - d))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return self.params

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        with torch.no_grad():
            for n, e in self.params.items():
                e.copy_(state[n])
