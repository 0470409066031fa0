"""Repetition counting state machine and count metrics.

The port's own copy of ``workoutdetector_tpu/counting.py``: ``pred_to_count``
and ``majority_vote_states`` (reference
workoutdetector/utils/inference_count.py:114-165, :221-231), ``obo_mae``,
``to_softmax``, ``scores_to_preds``, ``eval_score_dir`` and
``analyze_count`` (reference workoutdetector/utils/eval.py:11-24, :58-180).
pandas is imported only inside the two functions that read or write CSVs.
"""

from __future__ import annotations

import json
import math
import os
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def pred_to_count(preds: Sequence[int], step: int) -> Tuple[int, List[int]]:
    """Convert a per-chunk state-prediction sequence to a repetition count.

    States come in (even, odd) pairs per action: class ``2k`` is the "start"
    half-state of action ``k`` and ``2k+1`` the "end" half-state. A rep is
    counted when the state flips even→odd *within the same action* (prev ==
    pred - 1 with pred odd). -1 marks background and is skipped.

    Returns (count, reps) where reps is [start_1, end_1, start_2, end_2, ...]
    in frame indices (chunk index × step).
    """
    count = 0
    reps: List[int] = []
    last: Optional[int] = None  # last non-background prediction
    prev_state_start_idx = 0  # where the current run of identical preds began
    for idx, pred in enumerate(preds):
        if pred == -1:
            continue
        if last is not None and last != pred:
            if pred % 2 == 1 and last == pred - 1:
                count += 1
                reps.append(prev_state_start_idx * step)
                reps.append(idx * step)
        last = pred
        if pred != preds[prev_state_start_idx]:
            prev_state_start_idx = idx
    assert count * 2 == len(reps)
    return count, reps


def obo_mae(preds: Sequence[float],
            targets: Sequence[float],
            ratio: bool = True) -> Tuple[float, float]:
    """Raw-count metrics: MAE = mean |pred - gt|; OBO = fraction with
    |pred - gt| == 1 (exact-one definition of reference utils/eval.py:11-24;
    the helper's ≤1 definition lives in data.repcount.RepcountHelper)."""
    if len(preds) == 0:  # len(): callers pass lists AND numpy arrays
        raise ValueError("obo_mae: no predictions (empty score dir or "
                         "no videos matched the annotation)")
    mae = 0.0
    off_by_one = 0.0
    for pred, target in zip(preds, targets):
        mae += abs(pred - target)
        off_by_one += (abs(pred - target) == 1)
    n = len(preds)
    if ratio:
        return mae / n, off_by_one / n
    return mae / n, off_by_one


def to_softmax(scores: Dict[str, float]) -> Dict[str, float]:
    """Numerically-stable softmax over a {class: score} dict."""
    keys = list(scores.keys())
    vals = np.array([scores[k] for k in keys], dtype=np.float64)
    vals = vals - vals.max()
    e = np.exp(vals)
    p = e / e.sum()
    return dict(zip(keys, p.tolist()))


def scores_to_preds(scores: Dict[str, Dict[str, float]],
                    threshold: float = 0.5,
                    softmax: bool = False) -> List[int]:
    """Turn a .score.json `scores` dict into a per-chunk class sequence.

    Max-scoring class if its score >= threshold, else -1 (background).
    Mirrors reference utils/eval.py:152-164.
    """
    preds: List[int] = []
    for v in scores.values():
        if softmax:
            v = to_softmax(v)
        class_id, score = max(v.items(), key=lambda x: x[1])
        preds.append(int(class_id) if score >= threshold else -1)
    return preds


def eval_score_dir(json_dir: str,
                   anno_path: str,
                   out_csv: Optional[str] = None,
                   softmax: bool = False,
                   threshold: float = 0.5,
                   step: int = 8) -> Tuple[float, float, List[dict]]:
    """Evaluate a directory of per-video ``*.score.json`` files.

    Reads score JSONs written by infer.inference_dataset, converts scores →
    state sequences → counts, compares with the annotation csv, and returns
    (mae, obo, per-video rows). Mirrors reference utils/eval.py:117-180.
    """
    import pandas as pd

    files = sorted(f for f in os.listdir(json_dir) if f.endswith(".json"))
    anno = pd.read_csv(anno_path, index_col="name")
    rows: List[dict] = []
    preds: List[int] = []
    gts: List[int] = []
    for f in files:
        video_name = f.split(".")[0] + ".mp4"
        with open(os.path.join(json_dir, f)) as fp:
            data = json.load(fp)
        pred_seq = scores_to_preds(data["scores"], threshold=threshold, softmax=softmax)
        pred_count, pred_rep = pred_to_count(pred_seq, step=step)
        gt_count = int(anno.loc[video_name]["count"])
        preds.append(pred_count)
        gts.append(gt_count)
        rows.append(
            dict(name=video_name,
                 gt_count=gt_count,
                 pred_count=pred_count,
                 gt_rep=anno.loc[video_name]["reps"],
                 pred_rep=pred_rep,
                 split=anno.loc[video_name]["split"],
                 action=data["action"]))
    mae, obo = obo_mae(preds, gts)
    if out_csv:
        pd.DataFrame(rows).to_csv(out_csv)
    return mae, obo, rows


def analyze_count(csv_path: str, out_csv: Optional[str] = None):
    """Per-action × split aggregation of an eval csv → meta csv.

    Mirrors reference utils/eval.py:58-114.
    """
    import pandas as pd

    df = pd.read_csv(csv_path, index_col="name")
    actions = df.action.unique()
    splits = df.split.unique()
    out = []
    split_out = {
        sp: {"mae": 0.0, "obo": 0.0, "total": 0, "sum_count": 0.0} for sp in splits
    }
    for split in splits:
        for action in actions:
            da = df.loc[(df.action == action) & (df.split == split)]
            if len(da) == 0:
                continue
            mae, obo = obo_mae(da.pred_count.values, da.gt_count.values, ratio=False)
            out.append([action, split, mae, obo, len(da), float(np.mean(da.gt_count.values))])
            split_out[split]["mae"] += mae * len(da)
            split_out[split]["obo"] += obo
            split_out[split]["total"] += len(da)
            split_out[split]["sum_count"] += float(da.gt_count.values.sum())
    df_out = pd.DataFrame(
        out, columns=["action", "split", "mae", "obo_acc", "total", "avg_count"])
    for split in splits:
        total = split_out[split]["total"]
        if total == 0:
            continue
        row = pd.DataFrame(
            {
                "action": "all",
                "split": split,
                "mae": split_out[split]["mae"] / total,
                "obo_acc": split_out[split]["obo"],
                "total": total,
                "avg_count": split_out[split]["sum_count"] / total,
            },
            index=[0])
        df_out = pd.concat([df_out, row], ignore_index=True)
    if out_csv:
        df_out.to_csv(out_csv)
    return df_out


def majority_vote_states(argmax_seq: Sequence[int], window: int = 7) -> List[int]:
    """Sliding majority vote used by the image-model counter: at each frame,
    the state is 1 if ≥4 of the last 7 per-frame argmaxes are 1."""
    states: List[int] = []
    que: deque = deque(maxlen=window)
    for a in argmax_seq:
        que.append(int(a))
        states.append(int(sum(que) >= math.ceil((window + 1) / 2)))
    return states
