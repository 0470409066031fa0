"""Metric loggers: CSV, and a collection that fans out to each.

Port of ``workoutdetector_tpu/train/loggers.py`` (``CSVLogger``,
``LoggerCollection``, ``build_loggers``). TensorBoard and W&B are not in
the port yet: ``build_loggers`` skips them with a note.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Dict, List


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


class LoggerCollection:
    def __init__(self, loggers: List[Any]):
        self.loggers = loggers

    def log_hyperparams(self, params: Dict[str, Any]) -> None:
        for lg in self.loggers:
            lg.log_hyperparams(params)

    def log_metrics(self, metrics: Dict[str, Any], step: int = 0) -> None:
        for lg in self.loggers:
            lg.log_metrics(metrics, step=step)

    def close(self) -> None:
        for lg in self.loggers:
            if hasattr(lg, "close"):
                lg.close()


def build_loggers(cfg, log_dir: str) -> LoggerCollection:
    loggers: List[Any] = []
    if cfg.log.csv_enable:
        loggers.append(CSVLogger(log_dir))
    skipped = [name for name, on in (("TensorBoard", cfg.log.tensorboard_enable),
                                     ("W&B", cfg.log.wandb.enable)) if on]
    if skipped:
        print(f"[loggers] {' and '.join(skipped)} not in the PyTorch port yet; "
              "logging to CSV only")
    return LoggerCollection(loggers)
