"""Model export: the inference graph as a ``torch.export`` artifact.

Port of ``workoutdetector_tpu/utils/export.py``. The JAX package serializes
its jitted inference graph with ``jax.export`` (StableHLO, weights baked
in) to a ``.jaxm`` file; the port saves a ``torch.export`` program
(``torch.export.save``) to a ``.pt2`` file with the same JSON sidecar
(``input_shape``, ``input_dtype``, ``labels``, and from the CLI
``model_type``, ``num_class`` and ``checkpoint``; ``device`` takes the
place of ``platforms``).

The graph is uint8 windows → ``normalize_clip`` → the model with
``fold_for_inference`` applied → fp32 logits, its weights held by the
program; a RepNet's graph returns its per-frame logits (B, T, C), which
counting needs (their frame mean is the consensus), as the JAX export
does. The hand kernels appear in it as the ops ``torch.ops.wd.*``
(``ops/kernels/library.py``): a program exported on ``cuda`` launches
the same kernels as the live model, one exported on the CPU runs their
plain versions. So, unlike a ``.jaxm``, the artifact is not
self-contained: it replays wherever this package is importable, which
registers the ops (``load_exported`` imports them), on the device it was
exported for. The derived weights the live model caches (folded BN, the
kernels' weight layouts) are taken from one forward run just before the
export and held by the program as constants, as the live engine holds
them, so the graph does not recompute them on every call.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.models.repnet import RepNet
from workoutdetector_tpu_torch.models.timesformer import fold_for_inference
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip

SUFFIX = ".pt2"


class InferenceModule(torch.nn.Module):
    """The deployed graph: uint8 (B, T, H, W, 3) windows (TDN's (B, T, 5,
    H, W, 3) bursts, an image model's (B, H, W, 3) frames) → logits
    (a RepNet's per-frame (B, T, C)), without autograd."""

    def __init__(self, model: torch.nn.Module):
        super().__init__()
        self.model = model
        self.per_frame = isinstance(model, RepNet)

    def forward(self, x_u8: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            x = normalize_clip(x_u8)
            if self.per_frame:
                return self.model(x, per_frame=True)
            return self.model(x)


def make_inference_fn(model: torch.nn.Module) -> InferenceModule:
    """Deployment graph over ``model``'s weights, with the inference-only
    exact rewrites applied first (a TimeSformer's t_fc folded into
    t_attn.proj, as ``InferenceEngine`` does)."""
    return InferenceModule(fold_for_inference(model)).eval()


def export_model(model: torch.nn.Module,
                 path: str,
                 input_shape: Sequence[int] = (1, 8, 224, 224, 3),
                 labels: Optional[Sequence[str]] = None,
                 device: Union[str, torch.device, None] = "cuda",
                 meta: Optional[Dict[str, Any]] = None) -> str:
    """Export the inference graph for uint8 input of ``input_shape`` on
    ``device`` to ``path`` (``.pt2`` appended) and write its sidecar
    ``<path>.json``. Returns the artifact's path."""
    device = resolve_device(device)
    fn = make_inference_fn(model).to(device)
    example = torch.zeros(tuple(input_shape), dtype=torch.uint8, device=device)
    fn(example)  # fills the derived-weight caches the program takes
    program = torch.export.export(fn, (example,))
    if not path.endswith(SUFFIX):
        path += SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    sidecar = {
        "input_shape": list(input_shape),
        "input_dtype": "uint8",
        "device": device.type,
        "labels": list(labels) if labels else None,
        "num_class": int(model.num_class),
    }
    if meta:
        sidecar.update(meta)
    with open(path + ".json", "w") as f:
        json.dump(sidecar, f, indent=2)
    return path


class ExportedModel:
    """A loaded artifact: callable like the inference graph on a uint8
    tensor on its device."""

    def __init__(self, program: "torch.export.ExportedProgram",
                 meta: Dict[str, Any]):
        self.program = program
        self.meta = meta
        self._module = program.module()

    def __call__(self, x_u8: torch.Tensor) -> torch.Tensor:
        return self._module(x_u8)

    @property
    def input_shape(self) -> Tuple[int, ...]:
        return tuple(self.meta.get("input_shape", ()))


def load_exported(path: str, device: Union[str, torch.device, None] = None
                  ) -> ExportedModel:
    """Load a ``.pt2`` artifact and its sidecar. ``device``, where given,
    must be the one the artifact was exported for."""
    # registers the wd:: ops the program calls
    import workoutdetector_tpu_torch.ops.kernels  # noqa: F401

    if not path.endswith(SUFFIX):
        path += SUFFIX
    meta: Dict[str, Any] = {}
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    if device is not None and "device" in meta and \
            torch.device(device).type != meta["device"]:
        raise ValueError(f"{path} was exported for {meta['device']}, not "
                         f"{torch.device(device).type}: export it again on "
                         "that device")
    return ExportedModel(torch.export.load(path), meta)
