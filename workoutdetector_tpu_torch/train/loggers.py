"""Metric loggers: CSV, TensorBoard, W&B, and a collection that fans out to
each.

Port of ``workoutdetector_tpu/train/loggers.py``. Each backend is optional
and a failing one never stops training:

* ``CSVLogger``: ``<save_dir>/csv/metrics.csv`` and ``hparams.json``; a
  histogram becomes its mean and max columns (and the label of its
  largest entry where labels are given).
* ``TensorBoardLogger``: scalars, histograms and the ``hparams`` text
  through ``tensorboardX``'s ``SummaryWriter``, the JAX package's writer,
  where it is installed (the same events, and no TensorFlow import: the
  ``tensorboard`` package imports TensorFlow where that is installed),
  else through ``torch.utils.tensorboard`` (the ``tensorboard``
  package, which the card's machine has); with neither it does
  nothing.
* ``WandbLogger``: ``wandb`` imported when it is built; without it (or
  when ``wandb.init`` fails) it does nothing.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


class CSVLogger:
    """``<save_dir>/<name>/metrics.csv`` (one row per call) and
    ``hparams.json``."""

    def __init__(self, save_dir: str, name: str = "csv"):
        self.dir = os.path.join(save_dir, name)
        os.makedirs(self.dir, exist_ok=True)
        self.path = os.path.join(self.dir, "metrics.csv")
        self._fields: List[str] = ["step"]
        self._rows: List[Dict[str, Any]] = []

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        with open(os.path.join(self.dir, "hparams.json"), "w") as f:
            json.dump(params, f, indent=2, default=str)

    def log_histograms(self, hists: Dict[str, Any], step: int = 0,
                       labels: Optional[List[str]] = None) -> None:
        """CSV has no histogram type: ``<tag>/mean`` and ``<tag>/max``, and
        ``<tag>/argmax_leaf`` (the label of the largest entry) where
        ``labels`` has one label per entry."""
        row: Dict[str, Any] = {}
        for tag, values in hists.items():
            v = np.asarray(values)
            row[f"{tag}/mean"] = float(v.mean()) if v.size else 0.0
            row[f"{tag}/max"] = float(v.max()) if v.size else 0.0
            if labels and v.size == len(labels):
                row[f"{tag}/argmax_leaf"] = labels[int(v.argmax())]
        self.log_metrics(row, step=step)

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        row = {"step": step, **metrics}
        new_fields = [k for k in row if k not in self._fields]
        self._rows.append(row)
        if new_fields or not os.path.exists(self.path):
            # the header grew (e.g. the first val/ row): rewrite once
            self._fields.extend(new_fields)
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=self._fields)
                w.writeheader()
                w.writerows(self._rows)
        else:
            with open(self.path, "a", newline="") as f:
                csv.DictWriter(f, fieldnames=self._fields).writerow(row)


class TensorBoardLogger:
    """Events under ``<save_dir>/<name>`` (module docstring); a no-op
    without a writer."""

    def __init__(self, save_dir: str, name: str = "tensorboard"):
        self.writer = None
        try:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                from torch.utils.tensorboard import SummaryWriter
            self.writer = SummaryWriter(os.path.join(save_dir, name))
        except Exception:
            pass

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self.writer is not None:
            self.writer.add_text("hparams", json.dumps(params, default=str))

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        if self.writer is None:
            return
        for k, v in metrics.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass  # a text column (e.g. a label)

    def log_histograms(self, hists: Dict[str, Any], step: int = 0,
                       labels: Optional[List[str]] = None) -> None:
        del labels  # a histogram is an unlabelled distribution
        if self.writer is None:
            return
        for tag, values in hists.items():
            try:
                self.writer.add_histogram(tag, np.asarray(values), step)
            except Exception:
                pass

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()


class WandbLogger:
    """A W&B run (offline by default); a no-op without ``wandb``."""

    def __init__(self, save_dir: str, project: str, name: Optional[str],
                 offline: bool = True):
        self.run = None
        try:
            import wandb
            mode = "offline" if offline else "online"
            self.run = wandb.init(project=project, name=name, dir=save_dir,
                                  mode=mode)
        except Exception:
            pass

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        if self.run is not None:
            self.run.config.update(params, allow_val_change=True)

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        if self.run is not None:
            self.run.log(metrics, step=step)

    def log_histograms(self, hists: Dict[str, Any], step: int = 0,
                       labels: Optional[List[str]] = None) -> None:
        del labels
        if self.run is None:
            return
        try:
            import wandb
            self.run.log({k: wandb.Histogram(v) for k, v in hists.items()},
                         step=step)
        except Exception:
            pass


class LoggerCollection:
    def __init__(self, loggers: List[Any]):
        self.loggers = loggers

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step=step)

    def log_histograms(self, hists: Dict[str, Any], step: int = 0,
                       labels: Optional[List[str]] = None) -> None:
        """The gradient and parameter watch (1-D arrays, e.g. per-leaf
        norms, with their leaves' labels): each backend renders them its
        own way (TensorBoard and W&B histograms, CSV summaries)."""
        for lg in self.loggers:
            if hasattr(lg, "log_histograms"):
                lg.log_histograms(hists, step=step, labels=labels)

    def close(self) -> None:
        for lg in self.loggers:
            if hasattr(lg, "close"):
                lg.close()


def build_loggers(cfg, log_dir: str) -> LoggerCollection:
    loggers: List[Any] = []
    if cfg.log.csv_enable:
        loggers.append(CSVLogger(log_dir))
    if cfg.log.tensorboard_enable:
        loggers.append(TensorBoardLogger(log_dir))
    if cfg.log.wandb.enable:
        loggers.append(WandbLogger(log_dir, cfg.log.wandb.project,
                                   cfg.log.wandb.name, cfg.log.wandb.offline))
    return LoggerCollection(loggers)
