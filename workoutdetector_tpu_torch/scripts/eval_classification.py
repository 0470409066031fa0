"""Classifier sweep: per-class accuracy of the state classifier over the
configured dataset's splits.

The port's own copy of ``workoutdetector_tpu/scripts/eval_classification.py``:
``evaluate_split`` scores a dataset's batches through
``InferenceEngine.score_windows`` (the hand kernels on the card) and the
CLI writes ``{split: {"class_<k>": acc, ..., "overall": acc}}``.

    python -m workoutdetector_tpu_torch.scripts.eval_classification \
        --cfg workoutdetector_tpu/configs/repcount_12_tsm.yaml \
        [--checkpoint ckpt/best] [--splits val test] [-o acc.json] [--cpu] \
        [key=value ...]

It runs on the card (and raises without one) unless ``--cpu`` is given.
The engine is ``infer/engine.engine_from_checkpoint``'s, as every CLI's:
``--checkpoint`` takes a port checkpoint (``train/checkpoint.py``, its
EMA weights where it has them) or a ``.pt2`` artifact; without one the
model takes the port's initializers drawn from seed 0.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Dict

import numpy as np

from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.data.datasets import build_dataset
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.infer.engine import (InferenceEngine,
                                                    engine_from_checkpoint)


def evaluate_split(engine: InferenceEngine, dataset, batch_size: int = 16,
                   num_workers: int = 4) -> Dict[str, float]:
    """Per-class and overall accuracy of the engine over a dataset (its
    whole batches: the loader drops a partial tail, as the JAX sweep's
    does)."""
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=False,
                        num_workers=num_workers)
    correct: Dict[int, int] = defaultdict(int)
    total: Dict[int, int] = defaultdict(int)
    for x, y in loader:
        logits = engine.score_windows(x)
        preds = np.argmax(logits, axis=1)
        for p, t in zip(preds, y):
            total[int(t)] += 1
            correct[int(t)] += int(p == t)
    out = {f"class_{k}": correct[k] / total[k] for k in sorted(total)}
    n = sum(total.values())
    out["overall"] = sum(correct.values()) / n if n else 0.0
    return out


def main(argv=None) -> Dict[str, Dict[str, float]]:
    parser = argparse.ArgumentParser(description="Evaluate state classifier")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="a port checkpoint (train/checkpoint.py) or a "
                        ".pt2 artifact")
    parser.add_argument("--splits", nargs="+", default=["val", "test"])
    parser.add_argument("-o", "--out-json", default=None)
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("opts", nargs="*")
    args = parser.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.cfg, args.opts)
    engine = engine_from_checkpoint(cfg, args.checkpoint,
                                    image_size=cfg.data.image_size,
                                    window_batch=cfg.data.batch_size,
                                    device=device)
    results = {}
    for split in args.splits:
        ds = build_dataset(cfg.data, split, device)
        results[split] = evaluate_split(engine, ds, cfg.data.batch_size,
                                        cfg.data.num_workers)
        print(split, results[split])
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
