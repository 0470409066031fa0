"""Carry flax variables across into the port's modules.

The port's own copy of the key and layout map of
``workoutdetector_tpu/models/convert.py`` (``flax_to_torch_dict``), aimed
at this package's module names, which follow the flax tree:

  * conv ``kernel`` HWIO → ``weight`` OIHW (the 1×1 kernels are turned into
    the kernels' (C, O) layout at the call, ``Conv.matrix``), and a 3-D
    conv's DHWIO → OIDHW (TPN's neck); a ``ConvTranspose`` kernel (pose's
    ``deconv{i}``, (kh, kw, in, out)) takes the same 4-D rule, so its
    ``weight`` is (out, in, kh, kw) unflipped, and ``models/pose.Deconv``
    flips and swaps it at the call;
  * Dense ``kernel`` (in, out) → ``Linear.weight`` (out, in);
  * BN and LayerNorm ``scale`` → ``weight``, ``mean`` → ``running_mean``,
    ``var`` → ``running_var``; ``bias`` stays ``bias``;
  * the TimeSformer's (and RepNet's) ``cls_token``, ``pos_embed`` and
    ``time_embed`` parameters, ConvNeXt's γ layer scales (``gamma``) and
    the MoE MLP's stacked expert leaves (``w1`` (E, d, h), ``b1``, ``w2``,
    ``b2``) keep their names and shapes; a ConvNeXt depthwise kernel (7,
    7, 1, C) HWIO becomes (C, 1, 7, 7) by the same 4-D rule.

It also keeps its copy of the reference-checkpoint port
(``load_torch_checkpoint``, ``strip_ddp_prefix``, ``strip_shift_wrappers``,
``port_tsm_checkpoint``, ``port_tdn_checkpoint``, JAX
``convert.py:28-155, 203-261, 550``; ``port_convnext_checkpoint``,
``port_timesformer_checkpoint`` and ``port_vit_checkpoint``, JAX
``:328-627``): a reference PyTorch TSM or TDN
state dict (torchvision ResNet names under ``base_model.``, DDP's
``module.`` prefixes, the shift's ``.net.`` wrappers, ``new_fc``; TDN's
``layer{i}_bak``, ``resnext_layer1``, ``conv1_5.{0,1}`` and the
``shift.conv`` Conv1d), a timm or facebook ConvNeXt, an mmaction or
HuggingFace TimeSformer, or a timm ViT state dict becomes a flax-layout
tree, which ``load_flax_variables`` sets on the port's model.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from workoutdetector_tpu_torch.models.convnext import LAYER_SCALE_INIT

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
_EMBED = ("cls_token", "pos_embed", "time_embed")
_EXPERT_KERNELS = ("w1", "w2")  # MoEMlp's stacked (E, in, out) kernels
_EXPERT = _EXPERT_KERNELS + ("b1", "b2")
_RAW = _EMBED + _EXPERT + ("gamma",)  # carried as they are


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
    noise, randomised BN/LayerNorm affine, ConvNeXt γ and BN running
    statistics, truncated-normal(0.02) TimeSformer and RepNet embeddings,
    and MoE expert kernels N(0, 1/fan_in) (fan-in E·in, flax's for a 3-D
    leaf) with N(0, 0.1²) biases."""
    kernel_init = getattr(model, "FLAX_KERNEL_INIT", {})
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}
    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        *mods, leaf = key.split(".")
        kind = kernel_init.get(mods[-1] if mods else "", ("", None))
        if leaf in _EMBED:
            a = _truncated_normal(rng, shape, 0.02)
        elif leaf in _EXPERT_KERNELS:
            a = rng.normal(0.0, 1.0 / np.sqrt(np.prod(shape[:-1])), shape)
        elif leaf == "weight" and kind[0] == "shift":
            a = shift_taps(shape, kind[1]) + rng.normal(0.0, 0.2, shape)
        elif leaf == "weight" and len(shape) in (4, 5):
            fan_in = int(np.prod(shape[1:]))
            a = rng.normal(0.0, np.sqrt(2.0 / fan_in), shape)
        elif leaf == "weight" and len(shape) == 2:
            a = rng.normal(0.0, 1.0 / np.sqrt(shape[1]), shape)
        elif leaf in ("weight", "gamma"):
            a = rng.uniform(0.5, 1.0, shape)
        elif leaf in ("bias", "b1", "b2"):
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
    normal(0.02) unless ``FLAX_KERNEL_INIT`` names the leaf (RepNet's
    ``pos_embed``: ``("normal", 0.02)``, untruncated); the MoE experts'
    3-D ``w1``/``w2`` ``lecun_normal`` with flax's fan-in of a 3-D leaf,
    E · in (every axis but the last); ConvNeXt's γ 1e-6; a bias the
    model's ``FLAX_BIAS_INIT`` names by module starts at that constant (the
    detector's heatmap prior, −2.19). The distributions are flax's; the
    draws are not jax.random's."""
    kernel_init = getattr(model, "FLAX_KERNEL_INIT", {})
    bias_init = getattr(model, "FLAX_BIAS_INIT", {})
    rng = np.random.default_rng(seed)
    state: Dict[str, np.ndarray] = {}

    def lecun(shape, fan_in):
        # std of N(0, 1) cut at ±2 is 0.8796...
        return _truncated_normal(
            rng, shape, np.sqrt(1.0 / fan_in) / 0.87962566103423978)

    for key, t in model.state_dict().items():
        shape = tuple(t.shape)
        *mods, leaf = key.split(".")
        if leaf == "gamma":
            a = np.full(shape, LAYER_SCALE_INIT)
        elif leaf in _EMBED:
            kind, std = kernel_init.get(leaf, ("truncated_normal", 0.02))
            a = rng.normal(0.0, std, shape) if kind == "normal" else \
                _truncated_normal(rng, shape, std)
        elif leaf in _EXPERT_KERNELS:
            a = lecun(shape, int(np.prod(shape[:-1])))
        elif leaf == "weight" and len(shape) in (2, 4, 5):
            kind, std = kernel_init.get(mods[-1], ("lecun_normal", None))
            if kind == "normal":
                a = rng.normal(0.0, std, shape)
            elif kind == "zeros":
                a = np.zeros(shape)
            elif kind == "shift":
                a = shift_taps(shape, std)
            else:
                a = lecun(shape, int(np.prod(shape[1:])))
        elif leaf in ("weight", "running_var") and len(shape) == 1:
            a = np.ones(shape)
        elif leaf == "bias" and mods and mods[-1] in bias_init:
            a = np.full(shape, bias_init[mods[-1]])
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


# ------------------------------------------------ image and ViT checkpoints


def _torch_leaf(arr: np.ndarray, leaf: str, kind: str
                ) -> Tuple[np.ndarray, str]:
    """A torch ``weight`` leaf → its flax leaf: a conv's OIHW → HWIO
    ``kernel`` (a depthwise (C, 1, 7, 7) → (7, 7, 1, C)), a dense's
    (out, in) → (in, out) ``kernel``, a LayerNorm's → ``scale``; other
    leaves as they are."""
    if leaf != "weight":
        return arr, leaf
    if kind == "conv":
        return np.transpose(arr, (2, 3, 1, 0)), "kernel"
    if kind == "dense":
        return np.transpose(arr, (1, 0)), "kernel"
    return arr, "scale"


def _convnext_key_to_flax(key: str) -> Optional[Tuple[Tuple[str, ...], str]]:
    """One timm-ConvNeXt state-dict key → (flax path, leaf kind), timm's
    block names (conv_dw, mlp.fc1) or facebook's original ones (dwconv,
    pwconv1); None for keys to skip. A stage's ``downsample.0`` is its
    LayerNorm (``down{i}_norm``, applied first), ``downsample.1`` its
    conv."""
    k = key.replace(".dwconv.", ".conv_dw.")
    k = k.replace(".pwconv1.", ".mlp.fc1.").replace(".pwconv2.", ".mlp.fc2.")
    parts = k.split(".")
    if parts[-1] == "num_batches_tracked":
        return None
    if parts[0] == "stem":
        mod = "stem_conv" if parts[1] == "0" else "stem_norm"
        return (mod, parts[-1]), ("conv" if mod == "stem_conv" else "norm")
    if parts[0] == "stages":
        i = parts[1]
        if parts[2] == "downsample":
            if parts[3] == "0":
                return (f"down{i}_norm", parts[-1]), "norm"
            return (f"down{i}_conv", parts[-1]), "conv"
        if parts[2] == "blocks":
            block = f"stage{i}_block{parts[3]}"
            rest = parts[4:]
            if rest == ["gamma"]:
                return (block, "gamma"), "gamma"
            if rest[0] == "conv_dw":
                return (block, "conv_dw", rest[-1]), "conv"
            if rest[0] == "norm":
                return (block, "norm", rest[-1]), "norm"
            if rest[:2] in (["mlp", "fc1"], ["mlp", "fc2"]):
                return (block, rest[1], rest[-1]), "dense"
    if parts[0] == "head":
        if parts[1] == "norm":
            return ("head_norm", parts[-1]), "norm"
        if parts[1] in ("fc", "head"):
            return ("head", parts[-1]), "dense"
    return None


def port_convnext_checkpoint(state_dict: Mapping[str, Any], num_class: int,
                             target_params: Optional[Mapping[str, Any]] = None,
                             prefix: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """A timm or facebook ConvNeXt state dict → the flax ConvNeXt layout
    under ``prefix`` (``("backbone_img",)`` for an ``ImageClassifier``),
    JAX ``convert.port_convnext_checkpoint``. 'module.' and 'model.'
    prefixes are stripped; a head whose output width is not
    ``num_class`` is dropped; with ``target_params`` the ported params are
    overlaid onto it where paths and shapes match."""
    sd = strip_ddp_prefix(dict(state_dict))
    sd = {(k[len("model."):] if k.startswith("model.") else k): v
          for k, v in sd.items()}
    head_w = sd.get("head.fc.weight", sd.get("head.weight"))
    drop_head = head_w is not None and \
        _to_numpy(head_w).shape[0] != num_class
    items = []
    for k, v in sd.items():
        m = _convnext_key_to_flax(k)
        if m is not None:
            items.append((m[0], m[1], _to_numpy(v)))
    tree = _port_params(items, drop_head, prefix, head="head")
    if target_params is not None:
        tree["params"] = merge_into(target_params, tree["params"])
    return tree


def _timesformer_normalize_key(key: str) -> str:
    """An mmaction-TimeSformer key (the layout of the checkpoint the
    reference config loads) → the HuggingFace layout
    ``_timesformer_key_to_flax`` reads; HF keys pass through."""
    k = key
    if not (k.startswith("backbone.") or k.startswith("cls_head.")):
        return k
    for old, new in (
            ("backbone.cls_token", "timesformer.embeddings.cls_token"),
            ("backbone.pos_embed",
             "timesformer.embeddings.position_embeddings"),
            ("backbone.time_embed", "timesformer.embeddings.time_embeddings"),
            ("backbone.patch_embed.projection",
             "timesformer.embeddings.patch_embeddings.projection"),
            ("backbone.norm.", "timesformer.layernorm."),
            ("cls_head.fc_cls", "classifier")):
        k = k.replace(old, new)
    m = re.match(r"backbone\.transformer_layers\.layers\.(\d+)\.(.*)", k)
    if m:
        i, rest = m.group(1), m.group(2)
        for old, new in (
                ("attentions.0.norm", "temporal_layernorm"),
                ("attentions.0.attn.in_proj_weight",
                 "temporal_attention.attention.qkv.weight"),
                ("attentions.0.attn.in_proj_bias",
                 "temporal_attention.attention.qkv.bias"),
                ("attentions.0.attn.out_proj", "temporal_attention.output.dense"),
                ("attentions.0.temporal_fc", "temporal_dense"),
                ("attentions.1.norm", "layernorm_before"),
                ("attentions.1.attn.in_proj_weight",
                 "attention.attention.qkv.weight"),
                ("attentions.1.attn.in_proj_bias",
                 "attention.attention.qkv.bias"),
                ("attentions.1.attn.out_proj", "attention.output.dense"),
                ("ffns.0.norm", "layernorm_after"),
                ("ffns.0.layers.0.0", "intermediate.dense"),
                ("ffns.0.layers.1", "output.dense")):
            rest = rest.replace(old, new)
        k = f"timesformer.encoder.layer.{i}.{rest}"
    return k


_TIMESFORMER_BLOCK = {
    ("temporal_layernorm",): (("t_norm",), "norm"),
    ("temporal_attention", "attention", "qkv"): (("t_attn", "qkv"), "dense"),
    ("temporal_attention", "output", "dense"): (("t_attn", "proj"), "dense"),
    ("temporal_dense",): (("t_fc",), "dense"),
    ("layernorm_before",): (("s_norm",), "norm"),
    ("attention", "attention", "qkv"): (("s_attn", "qkv"), "dense"),
    ("attention", "output", "dense"): (("s_attn", "proj"), "dense"),
    ("layernorm_after",): (("mlp_norm",), "norm"),
    ("intermediate", "dense"): (("mlp", "fc1"), "dense"),
    ("output", "dense"): (("mlp", "fc2"), "dense"),
}


def _timesformer_key_to_flax(key: str
                             ) -> Optional[Tuple[Tuple[str, ...], str]]:
    """One HF-layout TimeSformer key → (flax path, leaf kind); None for
    keys to skip."""
    parts = key.split(".")
    if parts[0] == "classifier":
        return ("fc", parts[-1]), "dense"
    if parts[0] != "timesformer":
        return None
    if parts[1] == "layernorm":
        return ("norm", parts[-1]), "norm"
    if parts[1] == "embeddings":
        embed = {"cls_token": "cls_token", "position_embeddings": "pos_embed",
                 "time_embeddings": "time_embed"}.get(parts[2])
        if embed is not None:
            return (embed,), "embed"
        if parts[2] == "patch_embeddings":
            return ("patch_embed", parts[-1]), "conv"
        return None
    if parts[1] == "encoder" and parts[2] == "layer":
        hit = _TIMESFORMER_BLOCK.get(tuple(parts[4:-1]))
        if hit is None:
            return None
        path, kind = hit
        return (f"block_{parts[3]}",) + path + (parts[-1],), kind
    return None


def _port_params(items, drop_head: bool, prefix: Tuple[str, ...] = (),
                 head: str = "fc") -> Dict[str, Any]:
    """(flax path, leaf kind, array) triples → {'params', 'batch_stats'}
    under ``prefix``, the ``head`` module left out when ``drop_head``; an
    embedding's path is its leaf."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    for path, kind, arr in items:
        if drop_head and path[0] == head:
            continue
        if kind == "embed":
            params[prefix + path] = arr
            continue
        arr, leaf = _torch_leaf(arr, path[-1], kind)
        params[prefix + path[:-1] + (leaf,)] = arr
    return {"params": _unflatten(params), "batch_stats": {}}


def port_timesformer_checkpoint(state_dict: Mapping[str, Any],
                                num_class: int,
                                target_params: Optional[Mapping[str, Any]]
                                = None) -> Dict[str, Any]:
    """An mmaction (the reference config's pretrained file) or HuggingFace
    ``TimesformerForVideoClassification`` state dict → the flax
    TimeSformer layout, JAX ``convert.port_timesformer_checkpoint``. A head
    whose output width is not ``num_class`` is dropped; with
    ``target_params`` the ported params are overlaid onto it."""
    sd = strip_ddp_prefix(dict(state_dict))
    sd = {_timesformer_normalize_key(k): v for k, v in sd.items()}
    head_w = sd.get("classifier.weight")
    drop_head = head_w is not None and \
        _to_numpy(head_w).shape[0] != num_class
    items = []
    for k, v in sd.items():
        m = _timesformer_key_to_flax(k)
        if m is not None:
            items.append((m[0], m[1], _to_numpy(v)))
    tree = _port_params(items, drop_head)
    if target_params is not None:
        tree["params"] = merge_into(target_params, tree["params"])
    return tree


_VIT_BLOCK = {
    "norm1": (("s_norm",), "norm"), "attn.qkv": (("s_attn", "qkv"), "dense"),
    "attn.proj": (("s_attn", "proj"), "dense"),
    "norm2": (("mlp_norm",), "norm"), "mlp.fc1": (("mlp", "fc1"), "dense"),
    "mlp.fc2": (("mlp", "fc2"), "dense"),
}


def port_vit_checkpoint(state_dict: Mapping[str, Any], num_class: int,
                        target_params: Optional[Mapping[str, Any]] = None,
                        prefix: Tuple[str, ...] = ("backbone_img",)
                        ) -> Dict[str, Any]:
    """A timm-layout ViT state dict (``cls_token``, ``pos_embed``,
    ``patch_embed.proj``, ``blocks.N.{norm1, attn.qkv, attn.proj, norm2,
    mlp.fc1, mlp.fc2}``, ``norm``, ``head``) → the ``ImageClassifier``'s
    ViT branch (TimeSformer ``space_only`` at T = 1) under ``prefix``, JAX
    ``convert.port_vit_checkpoint``. A head whose output width is not
    ``num_class`` is dropped; with ``target_params`` the ported params are
    overlaid onto it."""
    sd = strip_ddp_prefix(dict(state_dict))
    head_w = sd.get("head.weight")
    drop_head = head_w is not None and \
        _to_numpy(head_w).shape[0] != num_class
    blk = re.compile(r"blocks\.(\d+)\.(.*)")
    items = []
    for k, v in sd.items():
        leaf = k.rsplit(".", 1)[-1]
        if k in ("cls_token", "pos_embed"):
            path, kind = (k,), "embed"
        elif k.startswith("patch_embed.proj."):
            path, kind = ("patch_embed", leaf), "conv"
        elif k.startswith("norm."):
            path, kind = ("norm", leaf), "norm"
        elif k.startswith("head."):
            path, kind = ("fc", leaf), "dense"
        else:
            m = blk.match(k)
            hit = _VIT_BLOCK.get(m.group(2).rsplit(".", 1)[0]) if m else None
            if hit is None:
                continue
            path = (f"block_{m.group(1)}",) + hit[0] + (leaf,)
            kind = hit[1]
        items.append((path, kind, _to_numpy(v)))
    tree = _port_params(items, drop_head, prefix)
    if target_params is not None:
        tree["params"] = merge_into(target_params, tree["params"])
    return tree
