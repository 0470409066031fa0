"""Carry flax variables across into the port's modules.

The port's own copy of the key and layout map of
``workoutdetector_tpu/models/convert.py`` (``flax_to_torch_dict``), aimed
at this package's module names, which follow the flax tree:

  * conv ``kernel`` HWIO → ``weight`` OIHW (the 1×1 kernels are turned into
    the kernels' (C, O) layout at the call, ``Conv.matrix``), and a 3-D
    conv's DHWIO → OIDHW (TPN's neck);
  * Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
  * BN and LayerNorm ``scale`` → ``weight``, ``mean`` → ``running_mean``,
    ``var`` → ``running_var``; ``bias`` stays ``bias``;
  * the TimeSformer's ``cls_token``, ``pos_embed`` and ``time_embed``
    parameters keep their names and shapes.

It also keeps its copy of the reference-checkpoint port
(``load_torch_checkpoint``, ``strip_ddp_prefix``, ``strip_shift_wrappers``,
``port_tsm_checkpoint``, ``port_tdn_checkpoint``, JAX
``convert.py:28-155, 203-261, 550``): a reference PyTorch TSM or TDN
state dict (torchvision ResNet names under ``base_model.``, DDP's
``module.`` prefixes, the shift's ``.net.`` wrappers, ``new_fc``; TDN's
``layer{i}_bak``, ``resnext_layer1``, ``conv1_5.{0,1}`` and the
``shift.conv`` Conv1d) becomes a flax-layout tree, which
``load_flax_variables`` sets on the port's model.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_LEAF = {"scale": "weight", "mean": "running_mean", "var": "running_var",
         "bias": "bias", "kernel": "weight"}
# kernel layouts by rank: Dense (in, out) ↔ (out, in) (and TDN's (C, 3)
# shift taps ↔ (3, C)), conv HWIO ↔ OIHW, 3-D conv DHWIO ↔ OIDHW
_KERNEL_TO_PORT = {2: lambda a: a.T,
                   4: lambda a: a.transpose(3, 2, 0, 1),
                   5: lambda a: a.transpose(4, 3, 0, 1, 2)}
_KERNEL_TO_FLAX = {2: lambda a: a.T,
                   4: lambda a: a.transpose(2, 3, 1, 0),
                   5: lambda a: a.transpose(2, 3, 4, 1, 0)}
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
                a = _KERNEL_TO_PORT[a.ndim](a)
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
            if a.ndim in _KERNEL_TO_FLAX:
                a, leaf = _KERNEL_TO_FLAX[a.ndim](a), "kernel"
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


def shift_taps(shape, n_div: int) -> np.ndarray:
    """TDN's shift taps at their JAX init (``TemporalShiftConv``, mode
    'shift'), in the port's (3, C) layout of [prev, self, next] rows: the
    first C/n_div channels take the next frame, the second the previous
    one, the rest their own."""
    _, c = shape
    fold = c // n_div
    w = np.zeros(shape)
    w[2, :fold] = 1.0
    w[0, fold:2 * fold] = 1.0
    w[1, 2 * fold:] = 1.0
    return w


def random_flax_variables(model: torch.nn.Module, seed: int = 0
                          ) -> Dict[str, Any]:
    """A numpy-seeded flax-layout variable tree for ``model``: He-normal
    convs (2-D and 3-D), N(0, 1/fan_in) dense kernels (a TimeSformer's
    ``t_fc`` included: its JAX init is zero, which would hide the temporal
    branch), TDN's shift taps at their shift pattern plus N(0, 0.2²)
    noise, randomised BN/LayerNorm affine and BN running statistics, and
    truncated-normal(0.02) TimeSformer embeddings."""
    kernel_init = getattr(model, "FLAX_KERNEL_INIT", {})
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        *mods, leaf = key.split(".")
        kind = kernel_init.get(mods[-1] if mods else "", ("", None))
        if leaf in _RAW:
            a = _truncated_normal(rng, shape, 0.02)
        elif leaf == "weight" and kind[0] == "shift":
            a = shift_taps(shape, kind[1]) + rng.normal(0.0, 0.2, shape)
        elif leaf == "weight" and len(shape) in (4, 5):
            fan_in = int(np.prod(shape[1:]))
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
    from a numpy seed. Conv (2-D and 3-D, grouped: fan-in
    in/groups · kernel size, as flax's) and Dense kernels
    ``lecun_normal`` (truncated normal, fan-in scaling) unless the model's
    ``FLAX_KERNEL_INIT`` names the module (``("normal", std)``,
    ``("zeros", 0)``, or ``("shift", n_div)`` for TDN's shift taps, which
    start as the shift pattern; a bias zero as every bias); BN and
    LayerNorm scale 1 and bias 0, running mean 0 and var 1; TimeSformer's
    ``cls_token``, ``pos_embed`` and ``time_embed`` truncated
    normal(0.02). The distributions are flax's; the draws are not
    jax.random's."""
    kernel_init = getattr(model, "FLAX_KERNEL_INIT", {})
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        *mods, leaf = key.split(".")
        if leaf in _RAW:
            a = _truncated_normal(rng, shape, 0.02)
        elif leaf == "weight" and len(shape) in (2, 4, 5):
            kind, std = kernel_init.get(mods[-1], ("lecun_normal", None))
            if kind == "normal":
                a = rng.normal(0.0, std, shape)
            elif kind == "zeros":
                a = np.zeros(shape)
            elif kind == "shift":
                a = shift_taps(shape, std)
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


# ------------------------------------------------ reference torch checkpoints


def _to_numpy(v: Any) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return tree


def strip_ddp_prefix(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the leading 'module.' that DDP training adds (reference
    tsm.py:463-464)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def strip_shift_wrappers(state_dict: Mapping[str, Any]) -> Dict[str, Any]:
    """Remove the '.net' segments the reference's TemporalShift module adds
    around the convs it wraps (reference tsm.py:134-136)."""
    return {k.replace(".net.", "."): v for k, v in state_dict.items()}


def _torch_key_to_flax(key: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    """One torchvision-ResNet-style key → (flax path, 'params' or
    'batch_stats'); None for keys to skip (num_batches_tracked)."""
    if key.endswith("num_batches_tracked"):
        return None
    parts = key.split(".")
    # layer{i}.{j}.rest → layer{i}_{j}.rest; downsample.0 → downsample_conv,
    # downsample.1 → downsample_bn
    mapped = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if re.fullmatch(r"layer\d+", p) and i + 1 < len(parts) and \
                parts[i + 1].isdigit():
            mapped.append(f"{p}_{parts[i + 1]}")
            i += 2
            continue
        if p == "downsample" and i + 1 < len(parts) and parts[i + 1] in ("0", "1"):
            mapped.append("downsample_conv" if parts[i + 1] == "0" else
                          "downsample_bn")
            i += 2
            continue
        mapped.append(p)
        i += 1

    leaf = mapped[-1]
    module = mapped[-2] if len(mapped) >= 2 else ""
    is_bn = module.startswith("bn") or module.endswith("bn")
    if leaf == "running_mean":
        return tuple(mapped[:-1] + ["mean"]), "batch_stats"
    if leaf == "running_var":
        return tuple(mapped[:-1] + ["var"]), "batch_stats"
    if is_bn and leaf == "weight":
        return tuple(mapped[:-1] + ["scale"]), "params"
    if is_bn and leaf == "bias":
        return tuple(mapped[:-1] + ["bias"]), "params"
    if leaf == "weight":
        return tuple(mapped[:-1] + ["kernel"]), "params"
    if leaf == "bias":
        return tuple(mapped[:-1] + ["bias"]), "params"
    return tuple(mapped), "params"


def _convert_value(path: Tuple[str, ...], v: np.ndarray) -> np.ndarray:
    if path[-1] == "kernel":
        if v.ndim == 4:  # conv OIHW → HWIO
            return np.transpose(v, (2, 3, 1, 0))
        if v.ndim == 2:  # linear (out, in) → (in, out)
            return np.transpose(v, (1, 0))
        if v.ndim == 3:  # conv1d (out, in/groups, k)
            return np.transpose(v, (2, 1, 0))
    return v


def torch_resnet_to_flax(state_dict: Mapping[str, Any],
                         prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """A torchvision-style ResNet state dict → {'params', 'batch_stats'}
    nested dicts with the flax module names."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in state_dict.items():
        m = _torch_key_to_flax(k)
        if m is None:
            continue
        path, coll = m
        arr = _convert_value(path, _to_numpy(v))
        (params if coll == "params" else stats)[prefix + path] = arr
    return {"params": _unflatten(params), "batch_stats": _unflatten(stats)}


def merge_into(target: Mapping[str, Any], source: Mapping[str, Any]
               ) -> Dict[str, Any]:
    """Overlay ``source`` leaves onto ``target`` where paths and shapes
    match, in the target's dtype (the strict=False load of reference
    tsm.py:473)."""
    tgt = dict(_flatten(target))
    for k, v in _flatten(source):
        if k in tgt and tuple(np.shape(tgt[k])) == tuple(np.shape(v)):
            tgt[k] = np.asarray(v, dtype=np.asarray(tgt[k]).dtype)
    return _unflatten(tgt)


def port_tsm_checkpoint(state_dict: Mapping[str, Any],
                        num_class: int,
                        target_params: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Any]:
    """A reference PyTorch TSM checkpoint → the flax TSM layout (JAX
    ``convert.port_tsm_checkpoint``): strip 'module.', drop the '.net'
    shift wrappers, 'base_model.*' → 'backbone.*', 'new_fc.*' → 'fc.*'.
    fc weights whose output dim is not ``num_class`` are dropped and the
    caller keeps its own head; with ``target_params`` the ported params
    are overlaid onto it where paths and shapes match."""
    sd = strip_shift_wrappers(strip_ddp_prefix(dict(state_dict)))
    remapped: Dict[str, Any] = {}
    for k, v in sd.items():
        if k.startswith("base_model."):
            remapped["backbone." + k[len("base_model."):]] = v
        elif k.startswith("new_fc."):
            remapped["fc." + k[len("new_fc."):]] = v
        else:
            remapped[k] = v
    fc_w = remapped.get("fc.weight")
    if fc_w is not None and _to_numpy(fc_w).shape[0] != num_class:
        remapped = {k: v for k, v in remapped.items() if not k.startswith("fc.")}
    tree = torch_resnet_to_flax(remapped)
    if target_params is not None:
        tree["params"] = merge_into(target_params, tree["params"])
    return tree


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """A .pth/.ckpt file → its raw state dict (the 'state_dict' nesting of
    torch-lightning and mmcv unwrapped)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        return ckpt["state_dict"]
    return ckpt


def _tdn_torch_key_rename(key: str) -> str:
    """A reference TDN key (the TSN wrapper over TDN_Net) → the port's
    dotted module path before the ResNet map: ``base_model.`` dropped,
    ``conv1_5.0``/``conv1_5.1`` → ``conv1_5``/``bn1_5``,
    ``layer{i}_bak.{j}`` → ``layer{i}.{j}``, ``resnext_layer1.{j}`` →
    ``resnext_layer1_{j}``."""
    k = key
    if k.startswith("base_model."):
        k = k[len("base_model."):]
    k = re.sub(r"^conv1_5\.0\.", "conv1_5.", k)
    k = re.sub(r"^conv1_5\.1\.", "bn1_5.", k)
    k = re.sub(r"^layer(\d+)_bak\.", r"layer\1.", k)
    k = re.sub(r"^resnext_layer1\.(\d+)\.", r"resnext_layer1_\1.", k)
    return k


def port_tdn_checkpoint(state_dict: Mapping[str, Any],
                        num_class: int,
                        target_params: Optional[Mapping[str, Any]] = None
                        ) -> Dict[str, Any]:
    """A reference PyTorch TDN checkpoint → the flax TDN layout (JAX
    ``convert.port_tdn_checkpoint``): strip 'module.' and the '.net' shift
    wrappers, rename the stages (``_tdn_torch_key_rename``), and squeeze
    each ShiftModule's Conv1d weight (C, 1, 3) into the (C, 3) taps.
    ``new_fc`` weights whose output dim is not ``num_class`` are dropped;
    with ``target_params`` the ported params are overlaid onto it where
    paths and shapes match."""
    sd = strip_shift_wrappers(strip_ddp_prefix(dict(state_dict)))
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    fc_w = sd.get("new_fc.weight")
    drop_fc = fc_w is not None and _to_numpy(fc_w).shape[0] != num_class
    for key, v in sd.items():
        k = _tdn_torch_key_rename(key)
        if drop_fc and k.startswith("new_fc."):
            continue
        if k.endswith(".shift.conv.weight"):
            parts = k.split(".")[:-3]  # the module path up to the block
            merged = []
            i = 0
            while i < len(parts):
                if re.fullmatch(r"layer\d+", parts[i]) and \
                        i + 1 < len(parts) and parts[i + 1].isdigit():
                    merged.append(f"{parts[i]}_{parts[i + 1]}")
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            params[tuple(merged) + ("shift", "kernel")] = _to_numpy(v)[:, 0, :]
            continue
        m = _torch_key_to_flax(k)
        if m is None:
            continue
        path, coll = m
        arr = _convert_value(path, _to_numpy(v))
        (params if coll == "params" else stats)[path] = arr
    tree = {"params": _unflatten(params), "batch_stats": _unflatten(stats)}
    if target_params is not None:
        tree["params"] = merge_into(target_params, tree["params"])
    return tree
