"""Named checkpoints ('best', 'last', ...) with resume, via ``torch.save``.

Port of ``workoutdetector_tpu/train/checkpoint.py`` (``CheckpointManager``).
A checkpoint is one file ``<dir>/<name>`` holding whatever ``state_dict()``
the saved object returns (the trainer's: model, optimizer, EMA, step),
plus ``<name>.meta.json``. Writes go to a temporary file renamed into
place, so a crash never leaves a torn checkpoint; the meta is written after
the checkpoint it describes. Saves are synchronous, so
``wait_until_finished`` has nothing to wait for. The format is not the JAX
package's orbax layout; loading one from the other is queued
(ROADMAP §1).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch


class CheckpointManager:
    """Named checkpoints in one directory."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _resolve(self, path_or_name: str) -> str:
        if os.path.isabs(path_or_name) or os.path.sep in path_or_name:
            return os.path.abspath(path_or_name)
        return self._path(path_or_name)

    def save(self, state: Any, name: str = "last",
             meta: Optional[Dict[str, Any]] = None) -> str:
        """Write ``state.state_dict()`` (or ``state`` itself, a dict) as
        checkpoint ``name``, then its meta."""
        path = self._path(name)
        payload = state.state_dict() if hasattr(state, "state_dict") else state
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        if meta is not None:
            with open(path + ".meta.json.tmp", "w") as f:
                json.dump(meta, f, default=str)
            os.replace(path + ".meta.json.tmp", path + ".meta.json")
        return path

    def wait_until_finished(self) -> None:
        """Saves are synchronous: every returned save is already durable."""

    def load(self, path_or_name: str) -> Dict[str, Any]:
        """The raw saved dict, tensors on the CPU."""
        return torch.load(self._resolve(path_or_name), map_location="cpu",
                          weights_only=False)

    def restore(self, path_or_name: str, target: Any) -> Tuple[Any, Dict[str, Any]]:
        """Load checkpoint ``path_or_name`` into ``target`` (its
        ``load_state_dict``); returns (target, meta)."""
        path = self._resolve(path_or_name)
        target.load_state_dict(self.load(path))
        meta: Dict[str, Any] = {}
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        return target, meta

    def restore_variables(self, path_or_name: str,
                          prefer_ema: bool = True) -> Dict[str, Dict[str, torch.Tensor]]:
        """Just the model variables, {'params', 'batch_stats'} keyed by the
        port's names, without knowing the optimizer's layout. With
        ``prefer_ema`` and an EMA in the checkpoint, its weights are the
        'params' (the averaged weights are the ones to deploy)."""
        raw = self.load(path_or_name)
        model = raw.get("model", raw)
        params = {k: v for k, v in model.items()
                  if not k.rsplit(".", 1)[-1].startswith("running_")}
        if prefer_ema and raw.get("ema") is not None:
            params = dict(raw["ema"])
        stats = {k: v for k, v in model.items() if k not in params
                 and k.rsplit(".", 1)[-1].startswith("running_")}
        return {"params": params, "batch_stats": stats}

    def exists(self, name: str) -> bool:
        return os.path.exists(self._path(name))
