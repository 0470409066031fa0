#!/usr/bin/env python3
"""The flagship TSM-R50 train step of the PyTorch port on one CUDA card.

    python3 tools/tsm_train_step_bench.py [--repo DIR] [--steps 20]

Runs ``Trainer.train_step`` of ``DIR``'s ``workoutdetector_tpu_torch``
(default: this checkout) on ``chip_smoke.py`` phase 6's configuration
(``repcount_12_tsm.yaml`` built in code: TSM-R50 224², 8 segments, 12
classes, bf16, batch 32, SGD with the TSN groups, partial BN; random
numpy-seeded weights; one DebugDataset batch), so that two checkouts can
be compared on one card, one process each, alternated. Three warm-up
steps, then ``--steps`` steps each drained before the next; prints the
median, quartiles and minimum in ms beside the card's name and power
limit, as one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

TREE = Path(__file__).resolve().parent.parent


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--repo", default=str(TREE),
                        help="checkout whose port is timed")
    parser.add_argument("--steps", type=int, default=20)
    args = parser.parse_args()
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("tsm_train_step_bench: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.data.datasets import DebugDataset
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.ops.kernels import _build
    from workoutdetector_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    trainer = Trainer(cs.train_config(Config, 0, 0, "unused"), device="cuda")
    state = trainer.init_state(
        steps_per_epoch=10,
        variables=random_flax_variables(trainer.model, seed=0))
    ds = DebugDataset(cs.NUM_CLASS, cs.FRAMES, cs.TRAIN_BATCH, cs.SIZE)
    x = np.stack([ds[i][0] for i in range(cs.TRAIN_BATCH)])
    y = np.array([ds[i][1] for i in range(cs.TRAIN_BATCH)])
    for _ in range(3):
        trainer.train_step(state, x, y)
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        trainer.train_step(state, x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(times, [25, 50, 75])
    print(json.dumps({"repo": str(repo), "step_ms_median": float(q[1]),
                      "step_ms_q1": float(q[0]), "step_ms_q3": float(q[2]),
                      "step_ms_min": min(times), "steps": args.steps,
                      "batch": cs.TRAIN_BATCH, "card": cs.card_line()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
