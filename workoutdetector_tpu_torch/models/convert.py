"""Carry flax variables across into the port's modules.

The port's own copy of the key and layout map of
``workoutdetector_tpu/models/convert.py`` (``flax_to_torch_dict``), aimed
at this package's module names, which follow the flax tree:

  * conv ``kernel`` HWIO → ``weight`` OIHW (the 1×1 kernels are turned into
    the kernels' (C, O) layout at the call, ``Conv.matrix``);
  * Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
  * BN and LayerNorm ``scale`` → ``weight``, ``mean`` → ``running_mean``,
    ``var`` → ``running_var``; ``bias`` stays ``bias``;
  * the TimeSformer's ``cls_token``, ``pos_embed`` and ``time_embed``
    parameters keep their names and shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var",
         "bias": "bias", "kernel": "weight"}
_RAW = ("cls_token", "pos_embed", "time_embed")  # carried as they are


def _flatten(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_port_state(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """{'params', 'batch_stats'} → {dotted port key: numpy array}."""
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, v in _flatten(variables.get(coll, {})):
            leaf = path[-1]
            a = np.asarray(v)
            if leaf in _RAW:
                out[".".join(path)] = a
                continue
            if leaf not in _LEAF:
                raise KeyError(f"unknown flax leaf {'/'.join(path)}")
            if leaf == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            out[".".join(path[:-1] + (_LEAF[leaf],))] = a
    return out


def load_flax_variables(model: torch.nn.Module,
                        variables: Mapping[str, Any]) -> torch.nn.Module:
    """Set every parameter and buffer of ``model`` from a flax variable
    tree (nested dicts of numpy arrays). Strict: a port tensor the tree
    does not set, a leaf left over, or a shape mismatch raises."""
    src = flax_to_port_state(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(src))
    extra = sorted(set(src) - set(own))
    if missing or extra:
        raise KeyError(f"flax tree does not match the model: missing "
                       f"{missing[:8]}, left over {extra[:8]}")
    with torch.no_grad():
        for k, t in own.items():
            a = src[k]
            if tuple(a.shape) != tuple(t.shape):
                raise ValueError(f"{k}: flax {a.shape} vs port {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.ascontiguousarray(a)).to(t.dtype))
    return model


_FLAX_LEAF = {"running_mean": "mean", "running_var": "var", "bias": "bias"}


def port_state_to_flax(state: Mapping[str, Any]) -> Dict[str, Any]:
    """Inverse of ``flax_to_port_state``: {port key: array} → nested
    {'params', 'batch_stats'} in the flax layout."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for key, v in state.items():
        *mods, leaf = key.split(".")
        a = np.asarray(v)
        coll = "batch_stats" if leaf.startswith("running_") else "params"
        if leaf == "weight":
            if a.ndim == 4:
                a, leaf = a.transpose(2, 3, 1, 0), "kernel"
            elif a.ndim == 2:
                a, leaf = a.T, "kernel"
            else:
                leaf = "scale"
        elif leaf not in _RAW:
            leaf = _FLAX_LEAF[leaf]
        node = tree[coll]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(a)
    return tree


def _truncated_normal(rng: np.random.Generator, shape, std: float
                      ) -> np.ndarray:
    """std · N(0, 1) redrawn outside ±2 (flax's truncated normal)."""
    a = rng.standard_normal(shape)
    out = np.abs(a) > 2
    while out.any():
        a[out] = rng.standard_normal(int(out.sum()))
        out = np.abs(a) > 2
    return a * std


def random_flax_variables(model: torch.nn.Module, seed: int = 0
                          ) -> Dict[str, Any]:
    """A numpy-seeded flax-layout variable tree for ``model``: He-normal
    convs, N(0, 1/fan_in) dense kernels (a TimeSformer's ``t_fc``
    included: its JAX init is zero, which would hide the temporal branch),
    randomised BN/LayerNorm affine and BN running statistics, and
    truncated-normal(0.02) TimeSformer embeddings."""
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf in _RAW:
            a = _truncated_normal(rng, shape, 0.02)
        elif leaf == "weight" and len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif leaf == "weight" and len(shape) == 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif leaf == "weight":
            a = rng.uniform(0.5, 1.0, shape)
        elif leaf == "bias":
            a = rng.normal(0.0, 0.1, shape)
        elif leaf == "running_mean":
            a = rng.normal(0.0, 0.2, shape)
        else:  # running_var
            a = rng.uniform(0.5, 1.5, shape)
        state[key] = a.astype(np.float32)
    return port_state_to_flax(state)


def init_flax_variables(model: torch.nn.Module, seed: int = 0
                        ) -> Dict[str, Any]:
    """A fresh model's variables with the JAX models' initializers, drawn
    from a numpy seed. Conv and Dense kernels ``lecun_normal`` (truncated
    normal, fan-in scaling) unless the model's ``FLAX_KERNEL_INIT`` names
    the module (``("normal", std)`` or ``("zeros", 0)``, its bias zero as
    every bias); BN and LayerNorm scale 1 and bias 0, running mean 0 and
    var 1; TimeSformer's ``cls_token``, ``pos_embed`` and ``time_embed``
    truncated normal(0.02). The distributions are flax's; the draws are
    not jax.random's."""
    kernel_init = getattr(model, "FLAX_KERNEL_INIT", {})
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        *mods, leaf = key.split(".")
        if leaf in _RAW:
            a = _truncated_normal(rng, shape, 0.02)
        elif leaf == "weight" and len(shape) in (2, 4):
            kind, std = kernel_init.get(mods[-1], ("lecun_normal", None))
            if kind == "normal":
                a = rng.normal(0.0, std, shape)
            elif kind == "zeros":
                a = np.zeros(shape)
            else:
                fan_in = int(np.prod(shape[1:]))
                # std of N(0, 1) cut at ±2 is 0.8796...
                a = _truncated_normal(
                    rng, shape, np.sqrt(1.0 / fan_in) / 0.87962566103423978)
        elif leaf in ("weight", "running_var") and len(shape) == 1:
            a = np.ones(shape)
        else:  # biases, running means
            a = np.zeros(shape)
        state[key] = a.astype(np.float32)
    return port_state_to_flax(state)
