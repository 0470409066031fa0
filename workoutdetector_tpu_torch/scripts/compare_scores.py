"""Score-JSON parity checker: diff two inference_dataset output dirs.

The port's own copy of ``workoutdetector_tpu/scripts/compare_scores.py``:
per-video score deltas, argmax agreement and downstream count agreement
between two directories of ``.score.json`` files (the port's and the JAX
package's, or the port's kernel and plain paths).

    python -m workoutdetector_tpu_torch.scripts.compare_scores ours/ theirs/ \
        [--threshold 0.5] [--softmax]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List

import numpy as np

from workoutdetector_tpu_torch.counting import pred_to_count, scores_to_preds


def compare_dirs(dir_a: str, dir_b: str, threshold: float = 0.5,
                 softmax: bool = False) -> Dict[str, float]:
    files = sorted(set(f for f in os.listdir(dir_a) if f.endswith(".json")) &
                   set(f for f in os.listdir(dir_b) if f.endswith(".json")))
    if not files:
        raise FileNotFoundError("no common .json files between the two dirs")
    max_abs: List[float] = []
    argmax_agree: List[float] = []
    count_agree = 0
    count_diff: List[int] = []
    skipped = 0
    for f in files:
        with open(os.path.join(dir_a, f)) as fa, \
                open(os.path.join(dir_b, f)) as fb:
            a, b = json.load(fa)["scores"], json.load(fb)["scores"]
        common = sorted(set(a) & set(b), key=int)
        if not common:
            skipped += 1  # no shared window keys (e.g. different steps):
            continue      # not comparable — must not count as disagreement
        va = np.asarray([[a[k][c] for c in sorted(a[k], key=int)] for k in common])
        vb = np.asarray([[b[k][c] for c in sorted(b[k], key=int)] for k in common])
        if va.shape == vb.shape:
            max_abs.append(float(np.abs(va - vb).max()))
            argmax_agree.append(float((va.argmax(1) == vb.argmax(1)).mean()))
        ca, _ = pred_to_count(scores_to_preds(a, threshold, softmax), step=8)
        cb, _ = pred_to_count(scores_to_preds(b, threshold, softmax), step=8)
        count_agree += int(ca == cb)
        count_diff.append(abs(ca - cb))
    n = len(files) - skipped
    return {
        "videos": len(files),
        "skipped_no_common_windows": skipped,
        "max_abs_score_delta": max(max_abs) if max_abs else float("nan"),
        "mean_argmax_agreement": float(np.mean(argmax_agree)) if argmax_agree
        else float("nan"),
        "count_agreement": count_agree / n if n else float("nan"),
        "mean_count_diff": float(np.mean(count_diff)) if count_diff else 0.0,
    }


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="Compare score-JSON dirs")
    parser.add_argument("dir_a")
    parser.add_argument("dir_b")
    parser.add_argument("--threshold", type=float, default=0.5)
    parser.add_argument("--softmax", action="store_true")
    args = parser.parse_args(argv)
    res = compare_dirs(args.dir_a, args.dir_b, args.threshold, args.softmax)
    print(json.dumps(res, indent=2))


if __name__ == "__main__":
    main()
