#!/usr/bin/env python3
"""The TimeSformer-B/16 train step of the PyTorch port on one CUDA card:
its wall time, and the host's time to issue each part of it.

    python3 tools/ts_train_step_bench.py [--repo DIR] [--tag NAME]
                                         [--rounds 6] [--steps 5]

Runs ``Trainer.train_step`` of ``DIR``'s ``workoutdetector_tpu_torch``
(default: this checkout) on ``timesformer.yaml``'s model and optimizer as
``chip_smoke.py`` phase 8 builds them (ViT-B/16 224², 8 segments, batch 16,
bf16; random numpy-seeded weights; one random uint8 batch), so that two
checkouts can be compared on one card, one process each, alternated.

- ``step_ms``: per round, the mean of ``--steps`` steps issued back to back
  and drained once (phase 8's ``train step`` metric), ``--rounds`` rounds.
- ``host_ms``: medians over ``--rounds`` × ``--steps`` steps, each drained
  before the next, of the host's time from the call to the end of the
  forward (a forward hook), to the optimizer's step (loss, zero_grad and
  ``backward()``), through the optimizer, to the call's return, and the
  wait for the device after it; ``wall_ms`` their sum.
- then one step under ``chip_smoke.profile_call`` (device busy time and
  idle share).

Prints one JSON line last.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

TREE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=TREE,
                    help="checkout whose workoutdetector_tpu_torch runs")
    ap.add_argument("--tag", default="")
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args()
    repo = args.repo.resolve()
    sys.path.insert(0, str(repo))
    spec = importlib.util.spec_from_file_location("chip_smoke", TREE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    import workoutdetector_tpu_torch as port
    from workoutdetector_tpu_torch.models import build_model
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer

    if not torch.cuda.is_available():
        print("ts_train_step_bench: no CUDA device", file=sys.stderr)
        return 2
    if Path(port.__file__).resolve().parent.parent != repo:
        raise AssertionError(f"imported {port.__file__}, not from {repo}")
    card = smoke.card_line()
    cfg = smoke.ts_train_config(repo, 0, 0, "unused")
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=random_flax_variables(
        build_model(cfg.model), seed=0))
    rng = np.random.default_rng(0)
    b = smoke.TS_TRAIN_BATCH
    x_u8 = rng.integers(0, 256, (b, smoke.FRAMES, smoke.SIZE, smoke.SIZE, 3),
                        dtype=np.uint8)
    y = rng.integers(0, smoke.NUM_CLASS, b)
    step = lambda: trainer.train_step(state, x_u8, y)  # noqa: E731
    for _ in range(2):  # cuDNN plans, the allocator, the kernels' build
        step()
    torch.cuda.synchronize()

    step_ms = []
    for _ in range(args.rounds):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3 / args.steps)

    marks = {}
    state.model.register_forward_hook(
        lambda *_: marks.__setitem__("forward", time.perf_counter()))
    real_opt_step = state.optimizer.step

    def opt_step():
        marks["backward"] = time.perf_counter()
        moved = real_opt_step()
        marks["optimizer"] = time.perf_counter()
        return moved

    state.optimizer.step = opt_step
    parts = {k: [] for k in ("forward", "backward", "optimizer", "return",
                             "device_wait")}
    for _ in range(args.rounds * args.steps):
        t0 = time.perf_counter()
        step()
        marks["return"] = time.perf_counter()
        torch.cuda.synchronize()
        marks["device_wait"] = time.perf_counter()
        prev = t0
        for k in parts:
            parts[k].append((marks[k] - prev) * 1e3)
            prev = marks[k]
    host_ms = {k: statistics.median(v) for k, v in parts.items()}
    wall = [sum(v) for v in zip(*parts.values())]
    smoke.log(f"{args.tag}: step_ms {[round(t, 3) for t in step_ms]}, host "
              f"medians {host_ms}, wall {min(wall):.3f}-{max(wall):.3f} ms on {card}")
    smoke.profile_call(torch, step, top=8)
    print(json.dumps({"tag": args.tag, "repo": str(repo), "card": card,
                      "torch": torch.__version__, "batch": b,
                      "step_ms": step_ms, "host_ms": host_ms,
                      "wall_ms": {"median": statistics.median(wall),
                                  "min": min(wall), "max": max(wall)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
