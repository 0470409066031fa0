"""Repetition counting and dataset scoring / evaluation.

Port of ``workoutdetector_tpu/infer/inference_count.py``: the counters
of the video state classifier (``count_by_video_model``), the per-frame
image classifier (``count_by_image_model``), the learnable period model
(``count_by_repnet`` over a RepNet engine's per-frame logits) and the two
training-free ones (``count_by_similarity`` over a headless image
engine's features, ``count_by_motion_periodicity`` over pixels, no
engine), ``inference_dataset`` (the same per-video score-JSON schema),
``eval_dataset``, ``eval_count_shards`` and the dataset CLI (``main``:
``--score``, ``--eval``, ``--merge-shards``).

One difference from the JAX CLI: ``--score`` exits with status 1 when its
shard scored nothing and its failure manifest is not empty, so a sweep in
which every video failed does not look like a success to a script.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
import time
from bisect import bisect_left
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from workoutdetector_tpu_torch.counting import (majority_vote_states,
                                                pred_to_count)
from workoutdetector_tpu_torch.data.repcount import RepcountHelper
from workoutdetector_tpu_torch.data.video import VideoReader, write_video
from workoutdetector_tpu_torch.infer.engine import (InferenceEngine,
                                                    score_video_chunked)
from workoutdetector_tpu_torch.models.repnet import (RepNet,
                                                     count_from_frame_logits,
                                                     period_of_class)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
from workoutdetector_tpu_torch.utils.similarity import (
    count_by_periodicity, count_by_spatial_periodicity, video_cnn_features)

MODEL_TYPES = ("video", "image", "similarity", "motion", "repnet")


def write_count_video(video_path: str, output_path: str, reps: List[int],
                      states: Sequence[int], step: int = 8) -> None:
    """Overlay the predicted class and the running count on the video
    (reference write_to_video, utils/inference_count.py:70-111)."""
    import cv2
    with VideoReader(video_path) as r:
        fps = r.fps or 30.0
        frames = r.read_raw()
    per_frame = np.repeat(np.asarray(states), step)[:len(frames)]
    h, w = frames.shape[1:3]
    out = []
    for idx, f in enumerate(frames[:len(per_frame)]):
        f = f.copy()
        count_idx = bisect_left(reps[::2], idx)
        cv2.putText(f, f"class {int(per_frame[idx])}", (int(w * 0.2), int(h * 0.25)),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (255, 0, 0), 2)
        cv2.putText(f, f"count {count_idx}", (int(w * 0.25), int(h * 0.5)),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, (237, 136, 12), 2)
        out.append(f)
    if out:
        write_video(output_path, np.stack(out), fps)


def count_by_video_model(engine: InferenceEngine,
                         video: Union[str, np.ndarray],
                         ground_truth: Optional[List[int]] = None,
                         video_out_path: Optional[str] = None
                         ) -> Tuple[int, List[int]]:
    """Count reps with the 8-frame video state classifier: consecutive
    non-overlapping 8-frame chunks → argmax class per chunk →
    pred_to_count(step=8). The last partial chunk is dropped, as in the
    reference.

    ``video`` is a path, decoded with
    ``VideoReader(path).read_prepped(256, engine.image_size)``, or an
    already decoded (T, H, W, 3) uint8 array. ``video_out_path`` (a path
    input only) writes the video with the states and counts drawn on it.
    """
    if isinstance(video, np.ndarray):
        frames = video
    else:
        with VideoReader(video) as r:
            frames = r.read_prepped(256, engine.image_size)
    n_chunks = len(frames) // 8
    if n_chunks == 0:
        return 0, []
    starts = np.arange(0, n_chunks * 8, 8)
    _, logits = engine.score_video(frames, stride=1, starts=starts)
    states = [int(np.argmax(l)) for l in logits]
    count, reps = pred_to_count(states, step=8)
    if video_out_path is not None:
        if isinstance(video, np.ndarray):
            raise ValueError("video_out_path needs the video's path")
        write_count_video(video, video_out_path, reps, states, step=8)
    return count, reps


def count_by_similarity(feature_engine: InferenceEngine, video_path: str,
                        min_period: int = 4, min_strength: float = 0.05
                        ) -> Tuple[int, int, float]:
    """Training-free count from the temporal self-similarity of per-frame
    features: the fundamental period of their lag profile, count =
    duration / period. Even a randomly initialised backbone carries the
    photometric signal of a periodic motion, so no checkpoint is needed.

    Args:
        feature_engine: a rank-4 engine over a headless image model
            (``ImageClassifier(base, num_class=0)``); the similarity runs
            on its device.

    Returns:
        (count, period_frames, strength); count 0 when no periodic
        structure clears ``min_strength``.
    """
    feats = video_cnn_features(feature_engine, video_path)
    return count_by_periodicity(feats, min_period=min_period,
                                min_strength=min_strength,
                                device=feature_engine.device)


def count_by_motion_periodicity(video_path: str, grid: int = 8,
                                image_size: int = 64, min_period: int = 4,
                                min_strength: float = 0.05,
                                device: Union[str, torch.device, None]
                                = "cuda") -> Tuple[int, int, float]:
    """Training-free count from per-cell pixel periodicity (no checkpoint
    and no backbone): the video decoded at ``image_size``, each cell of a
    grid × grid split with its own lag profile (one batched matmul on
    ``device``), the strongest cell's waveform cycle-counted
    (``utils.similarity.count_by_spatial_periodicity``).

    Returns:
        (count, period_frames, strength); count 0 when no periodic
        structure clears ``min_strength``.
    """
    scale = max(image_size, round(image_size * 256 / 224))
    with VideoReader(video_path) as r:
        frames = r.read_prepped(scale, image_size)
    return count_by_spatial_periodicity(frames, grid=grid,
                                        min_period=min_period,
                                        min_strength=min_strength,
                                        device=device)


def repnet_frame_logits_fn(engine: InferenceEngine):
    """The per-frame period-logits call of a RepNet engine, kept on the
    engine: a (window_batch, T, S, S, 3) uint8 tensor → (window_batch, T,
    C) fp32 on the engine's device. A live engine runs its model with
    ``per_frame=True``; a ``.pt2`` artifact of a RepNet already returns
    exactly these (``utils/export``)."""
    fn = getattr(engine, "_repnet_fn", None)
    if fn is not None:
        return fn
    if engine.model is None:
        if engine.meta.get("model_type") != "repnet":
            raise ValueError("the artifact was not exported from a RepNet "
                             f"(model_type {engine.meta.get('model_type')!r})")
        fn = engine._run
    else:
        model = engine.model
        if not isinstance(model, RepNet):
            raise ValueError(f"a RepNet engine is needed, not one over "
                             f"{type(model).__name__}")

        @torch.no_grad()
        def fn(x_u8: torch.Tensor) -> torch.Tensor:
            return model(normalize_clip(x_u8.to(engine.device)),
                         per_frame=True)
    engine._repnet_fn = fn
    return fn


def repnet_frame_logits_batch(engine: InferenceEngine):
    """Any-N (N, T, S, S, 3) uint8 windows → (N, T, C) frame logits on the
    host, through the engine's chunk-and-pad loop (``chunked_call``), so
    every device call has the engine's one window batch. The score
    function the serving batcher takes."""
    fn = repnet_frame_logits_fn(engine)
    return lambda windows: engine.chunked_call(fn, windows)


def count_by_repnet(engine: InferenceEngine, video_path: str,
                    rates: Sequence[int] = (1, 2, 4, 8),
                    min_periodicity: float = 0.5,
                    grid: bool = False) -> Tuple[int, int, float]:
    """Count reps with the learnable RepNet period model.

    The video is scored at several temporal subsampling rates; the rate
    whose frames look most periodic to the model wins. The count itself
    (Σ 1/period over periodic frames, ``count_from_frame_logits``) is
    rate-invariant; the rate decides which periods fall in the model's
    range (2..T/2 window frames). Windows are T consecutive (subsampled)
    frames, the last padded with its last frame and masked out of the
    count.

    ``grid=True`` also scores the four quadrants of a 2× decode (and its
    2× subsampled whole frame) and keeps the most periodic view: motion
    confined to a small region fills a quadrant.

    Returns:
        (count, period_frames, strength): the period in source frames
        (the median over periodic frames), the strength the mean periodic
        probability at the winning rate and view.
    """
    t_win = engine.num_segments
    score_windows = repnet_frame_logits_batch(engine)
    s = engine.image_size
    with VideoReader(video_path) as r:
        if grid:
            big = r.read_prepped(round(2 * s * 256 / 224), 2 * s)
            views = [big[:, ::2, ::2], big[:, :s, :s], big[:, :s, s:],
                     big[:, s:, :s], big[:, s:, s:]]
        else:
            views = [r.read_prepped(round(s * 256 / 224), s)]
    best = (0, 0, 0.0)  # (count, period_frames, strength)
    best_strength = -1.0
    for video, rate in ((v, r_) for v in views for r_ in rates):
        xs = video[::rate]
        if len(xs) < 2:
            continue
        n_win = -(-len(xs) // t_win)
        pad = n_win * t_win - len(xs)
        valid = np.arange(n_win * t_win) < len(xs)
        if pad:
            xs = np.concatenate([xs, np.repeat(xs[-1:], pad, axis=0)])
        wins = xs.reshape(n_win, t_win, *xs.shape[1:])
        valid = valid.reshape(n_win, t_win)
        fl = score_windows(wins)  # (n_win, T, C)
        count, strength = count_from_frame_logits(fl, valid,
                                                  min_periodicity)
        if strength > best_strength:
            p = np.exp(fl - fl.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            periodic = (1.0 - p[..., 0] >= min_periodicity) & valid
            if periodic.any():
                ids = np.argmax(p[..., 1:], -1)[periodic] + 1
                period = int(np.median(period_of_class(ids))) * rate
            else:
                period = 0
            best = (int(round(count)), period, float(strength))
            best_strength = strength
    return best


def count_by_image_model(engine: InferenceEngine, video_path: str,
                         ground_truth: Optional[List[int]] = None,
                         video_out_path: Optional[str] = None,
                         pred_out_path: Optional[str] = None,
                         threshold: float = 0.1) -> Tuple[int, List[int]]:
    """Count reps with a per-frame image state classifier (reference
    count_by_image_model, :192-243): per-frame argmax over
    ``engine.score_images`` → 7-deep majority vote (≥ 4) → state per frame
    → pred_to_count(step=7).

    ``threshold``: frames whose largest softmax score falls below it
    become -1 (background), which pred_to_count skips — the reference's
    documented semantics, which its code never applies. ``pred_out_path``
    writes {video_path, step: 1, scores: {frame: [logits]}} (the frame
    keys strings, as JSON writes int keys).
    """
    with VideoReader(video_path) as r:
        video = r.read_prepped(256, engine.image_size)
    if len(video) == 0:
        return 0, []
    scores = engine.score_images(video)
    argmaxes = np.argmax(scores, axis=1)
    states = majority_vote_states(argmaxes, window=7)
    if threshold > 0:
        e = np.exp(scores - scores.max(axis=1, keepdims=True))
        max_prob = (e / e.sum(axis=1, keepdims=True)).max(axis=1)
        states = [-1 if p < threshold else s
                  for s, p in zip(states, max_prob)]
    count, reps = pred_to_count(states, step=7)
    if pred_out_path is not None:
        d = {"video_path": video_path, "step": 1,
             "scores": {i: s.tolist() for i, s in enumerate(scores)}}
        if not pred_out_path.endswith(".json"):
            pred_out_path += ".json"
        with open(pred_out_path, "w") as f:
            json.dump(d, f)
    if video_out_path is not None:
        write_count_video(video_path, video_out_path, reps, states, step=7)
    return count, reps


def _shard_items(items: List, shard: Tuple[int, int]) -> List:
    """Deterministic disjoint shard of a video list: worker i of n takes
    every n-th item of the name-sorted list, so n workers with
    ``shard=(i, n)`` cover a split exactly once without coordination."""
    i, n = shard
    if n < 1 or not 0 <= i < n:
        # validated before the n == 1 shortcut: shard=(1, 1) is a typo,
        # not the whole split
        raise ValueError(f"invalid shard {shard}: need 0 <= i < n")
    if n == 1:
        return items
    return sorted(items, key=lambda it: it.video_name)[i::n]


def _failures_path(out_dir: str, shard: Tuple[int, int]) -> str:
    """Per-shard failure manifest path, under ``failures/`` so that the
    score directory itself holds only ``*.score.json`` files."""
    i, n = shard
    return osp.join(out_dir, "failures", f"shard_{i}of{n}.json")


def _atomic_json_dump(obj, path: str) -> None:
    """Write JSON visible whole or not at all (temporary file, then
    ``os.replace``): a kill mid-write never leaves a truncated file that a
    resumed shard would trust."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class _SweepFailures:
    """Incremental per-shard failure manifest for dataset sweeps.

    Entries persist across restarts: a video that failed in an earlier run
    keeps its record until a later run scores it. Written atomically after
    every change, so a preempted shard leaves an exact record."""

    def __init__(self, path: str):
        self.path = path
        self.failed: Dict[str, Dict[str, str]] = {}
        if osp.isfile(path):
            try:
                with open(path) as f:
                    self.failed = json.load(f)
            except (json.JSONDecodeError, OSError):
                self.failed = {}

    def record(self, name: str, stage: str, exc: BaseException) -> None:
        self.failed[name] = {"stage": stage,
                             "error": f"{type(exc).__name__}: {exc}"}
        os.makedirs(osp.dirname(self.path), exist_ok=True)
        _atomic_json_dump(self.failed, self.path)

    def clear(self, name: str) -> None:
        if name in self.failed:
            del self.failed[name]
            _atomic_json_dump(self.failed, self.path)


def inference_dataset(engine: InferenceEngine,
                      splits: List[str],
                      out_dir: str,
                      checkpoint: str,
                      data_root: Optional[str] = None,
                      anno_path: Optional[str] = None,
                      step: int = 8,
                      stride: int = 2,
                      decode_workers: int = 2,
                      shard: Tuple[int, int] = (0, 1),
                      chunk_frames: Optional[int] = None,
                      skip_existing: bool = False,
                      on_error: str = "raise") -> Dict[str, object]:
    """Score every RepCount video of ``splits`` → per-video
    ``<name>.score.json`` in ``out_dir``.

    The JSON holds video_name / model / input_shape / checkpoint /
    total_frames / ground_truth / action / scores{start_frame:
    {class_id: logit}}, the sparse 8-of-16 windows every ``step`` frames.

    ``decode_workers`` threads decode the next videos and stage them on
    the device (``engine.stage_video``) while the current one is scored;
    for an artifact engine (no device gather) they decode only, and the
    windows are gathered on the host.
    ``shard=(i, n)`` scores worker i's disjoint slice of the split.
    ``chunk_frames`` bounds decode memory per video
    (``score_video_chunked``; videos then decode and score one after the
    other). ``skip_existing=True`` skips videos whose score JSON already
    parses. ``on_error='skip'`` records a video that fails to decode or
    score in the shard's manifest under ``out_dir/failures/`` and goes on;
    ``'raise'`` (default) raises.

    Returns ``{"scored": [...], "skipped": [...], "failed": {name:
    {stage, error}}}`` for this shard's slice.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip': {on_error!r}")
    os.makedirs(out_dir, exist_ok=True)
    if data_root is None:
        data_root = osp.expanduser("~/data/RepCount/")
    if anno_path is None:
        anno_path = osp.join(data_root, "annotation.csv")
    helper = RepcountHelper(data_root, anno_path)
    data = helper.get_rep_data(splits, action=["all"])

    items = _shard_items(list(data.values()), shard)
    failures = _SweepFailures(_failures_path(out_dir, shard))
    summary: Dict[str, object] = {"scored": [], "skipped": [],
                                  "failed": failures.failed}

    if skip_existing:
        remaining = []
        for item in items:
            path = osp.join(out_dir, f"{item.video_name}.score.json")
            done = False
            if osp.isfile(path):
                try:
                    with open(path) as f:
                        json.load(f)
                    done = True
                except (json.JSONDecodeError, OSError):
                    done = False
            if done:
                summary["skipped"].append(item.video_name)
                failures.clear(item.video_name)
            else:
                remaining.append(item)
        items = remaining
    if not items:
        return summary

    def finish(item) -> None:
        summary["scored"].append(item.video_name)
        failures.clear(item.video_name)

    def fail(item, stage: str, exc: BaseException) -> None:
        if on_error == "raise":
            raise exc
        failures.record(item.video_name, stage, exc)

    if chunk_frames is not None:
        for item in items:
            try:
                n_frames, starts, logits = score_video_chunked(
                    engine, item.video_path, step=step, stride=stride,
                    chunk_frames=chunk_frames)
                _write_score_json(engine, item, n_frames, starts, logits,
                                  checkpoint, out_dir)
            except Exception as e:
                fail(item, "score", e)
            else:
                finish(item)
        return summary

    device_gather = engine.supports_device_gather

    def decode(it):
        with VideoReader(it.video_path) as r:
            video = r.read_prepped(256, engine.image_size)
        # an artifact engine gathers on the host: keep the decoded video
        return engine.stage_video(video) if device_gather else video

    from concurrent.futures import ThreadPoolExecutor
    workers = max(1, decode_workers)
    with ThreadPoolExecutor(workers) as pool:
        futures = [pool.submit(decode, it) for it in items[:workers]]
        for k, item in enumerate(items):
            fut = futures.pop(0)
            # keep the decode pipeline fed even when this video fails
            if k + workers < len(items):
                futures.append(pool.submit(decode, items[k + workers]))
            try:
                payload = fut.result()
            except Exception as e:
                fail(item, "decode", e)
                continue
            try:
                if device_gather:
                    n_frames = payload.video.shape[0]
                    starts = engine.windows_for_video(n_frames, step=step)
                    logits = engine.score_staged(payload, starts,
                                                 stride=stride)
                else:
                    n_frames = payload.shape[0]
                    starts = engine.windows_for_video(n_frames, step=step)
                    logits = engine.score_windows(engine.gather_windows(
                        payload, starts, stride=stride))
                _write_score_json(engine, item, n_frames, starts, logits,
                                  checkpoint, out_dir)
            except Exception as e:
                fail(item, "score", e)
            else:
                finish(item)
    return summary


def _write_score_json(engine, item, total_frames, starts, logits, checkpoint,
                      out_dir) -> None:
    scores: Dict[int, Dict[int, float]] = {
        int(s): {int(c): float(v) for c, v in enumerate(l)}
        for s, l in zip(starts, logits)
    }
    res = dict(video_name=item.video_name,
               model="video_model",
               input_shape=[1, engine.num_segments, 3, engine.image_size,
                            engine.image_size],
               checkpoint=checkpoint,
               total_frames=int(total_frames),
               ground_truth=item.reps,
               action=item.class_,
               scores=scores)
    out_path = os.path.join(out_dir, f"{item.video_name}.score.json")
    _atomic_json_dump(res, out_path)


def eval_dataset(engine: InferenceEngine,
                 action: List[str],
                 split: str,
                 data_root: str,
                 anno_path: Optional[str] = None,
                 model_type: str = "video",
                 output_dir: Optional[str] = None,
                 csv_name: Optional[str] = None,
                 save_video: bool = False,
                 threshold: float = 0.0,
                 grid: bool = False,
                 shard: Tuple[int, int] = (0, 1),
                 counts_out: Optional[str] = None,
                 resume: bool = False,
                 on_error: str = "raise",
                 device: Union[str, torch.device, None] = "cuda"
                 ) -> Tuple[float, float]:
    """Per-video counting over a split → ``RepcountHelper.eval_count``'s
    MAE/OBO, and a per-video CSV in ``output_dir`` when given (pandas,
    imported there).

    ``model_type``: ``'video'`` (``count_by_video_model``), ``'image'``
    (``count_by_image_model``, a rank-4 engine; ``threshold`` goes to it
    alone, default 0: the reference's counts), ``'similarity'``
    (``count_by_similarity``, a rank-4 engine over a headless model) or
    ``'motion'`` (``count_by_motion_periodicity``, no engine: pass None; it
    runs on ``device``) or ``'repnet'`` (``count_by_repnet`` over a RepNet
    engine, with ``grid``, which only it reads).

    ``shard=(i, n)`` counts worker i's disjoint slice of the split; the
    metrics are divided by the whole split's size, so the shards' partial
    metrics add up, and ``eval_count_shards`` merges their
    ``counts_out`` files exactly. ``on_error='skip'`` records an
    uncountable video in a per-shard manifest next to ``counts_out`` (or
    in ``output_dir``) and goes on. ``resume=True`` (needs
    ``counts_out``) reloads the counts file and skips its videos; counts
    are written atomically after every video.
    """
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip': {on_error!r}")
    if resume and counts_out is None:
        raise ValueError("resume=True needs counts_out (the file that "
                         "carries the finished counts across restarts)")
    if anno_path is None:
        anno_path = os.path.join(data_root, "annotation.csv")
    if model_type not in MODEL_TYPES:
        raise ValueError(f"Invalid model type: {model_type}")
    helper = RepcountHelper(data_root, anno_path)
    items = helper.get_rep_data(split=[split], action=action)
    if output_dir is not None:
        # before the loop: cv2.VideoWriter drops every frame when the
        # directory does not exist
        os.makedirs(output_dir, exist_ok=True)
    fail_dir = osp.dirname(osp.abspath(counts_out)) if counts_out \
        else (output_dir or ".")
    failures = _SweepFailures(_failures_path(fail_dir, shard))
    pred_dict: Dict[str, int] = {}
    if resume and osp.isfile(counts_out):
        try:
            with open(counts_out) as f:
                pred_dict = {k: int(v) for k, v in json.load(f).items()}
        except (json.JSONDecodeError, OSError):
            pred_dict = {}
    for item in _shard_items(list(items.values()), shard):
        name = item.video_name
        if resume and name in pred_dict:
            continue
        out_path = None
        if save_video and output_dir is not None:
            out_path = os.path.join(output_dir, name)
        try:
            if model_type == "motion":
                count, _, _ = count_by_motion_periodicity(item.video_path,
                                                          device=device)
            elif model_type == "repnet":
                count, _, _ = count_by_repnet(engine, item.video_path,
                                              grid=grid)
            elif model_type == "similarity":
                count, _, _ = count_by_similarity(engine, item.video_path)
            elif model_type == "video":
                count, _ = count_by_video_model(engine, item.video_path,
                                                ground_truth=item.reps,
                                                video_out_path=out_path)
            else:
                count, _ = count_by_image_model(engine, item.video_path,
                                                ground_truth=item.reps,
                                                video_out_path=out_path,
                                                threshold=threshold)
        except Exception as e:
            if on_error == "raise":
                raise
            failures.record(name, "count", e)
            continue
        pred_dict[name] = count
        failures.clear(name)
        if counts_out is not None:
            _atomic_json_dump(pred_dict, counts_out)
    if counts_out is not None:
        _atomic_json_dump(pred_dict, counts_out)
    mae, obo_acc, eval_res = helper.eval_count(pred_dict, action=action,
                                               split=[split])
    if output_dir is not None:
        import pandas as pd
        rows = []
        for item in eval_res.values():
            d = dict(item.__dict__)
            d.pop("video_path", None)
            d.pop("frames_path", None)
            rows.append(d)
        if csv_name is None:
            tag = f"_shard{shard[0]}of{shard[1]}" if shard[1] > 1 else ""
            csv_name = f"eval_count_{model_type}_model{tag}.csv"
        if os.path.isfile(os.path.join(output_dir, csv_name)):
            csv_name = csv_name.split(".")[0] + "_" + str(time.time()) + ".csv"
        pd.DataFrame(rows).to_csv(os.path.join(output_dir, csv_name))
    return mae, obo_acc


def eval_count_shards(counts_files: Sequence[str],
                      data_root: str,
                      anno_path: Optional[str] = None,
                      action: Sequence[str] = ("all",),
                      split: Sequence[str] = ("test",)
                      ) -> Tuple[float, float, Dict]:
    """Exact global MAE/OBO from per-shard counts JSONs: the disjoint
    dicts merged, then ``RepcountHelper.eval_count`` once over the union.
    Shards that share a video are refused."""
    merged: Dict[str, int] = {}
    for p in counts_files:
        with open(p) as f:
            d = json.load(f)
        overlap = merged.keys() & d.keys()
        if overlap:
            raise ValueError(
                f"shards overlap on {sorted(overlap)[:3]} — did two workers "
                "run with the same shard index?")
        merged.update(d)
    if anno_path is None:
        anno_path = os.path.join(data_root, "annotation.csv")
    helper = RepcountHelper(data_root, anno_path)
    return helper.eval_count(merged, action=list(action), split=list(split))


def similarity_engine(cfg, device: Union[str, torch.device, None] = "cuda"
                      ) -> InferenceEngine:
    """The CLI's checkpoint-free feature engine for ``count_by_similarity``:
    a headless fp32 ResNet (``cfg.model.base_model`` where it is one of
    the zoo's, else resnet18; no fused kernel: they take bf16) from the
    port's initializers at seed 0, rank 4, window batch 16, at
    ``cfg.data.image_size``. The JAX CLI draws its weights from
    ``PRNGKey(0)``, which the port cannot reproduce, so the two CLIs'
    counts on the same video may differ (ROADMAP §3)."""
    from workoutdetector_tpu_torch.models import (ImageClassifier,
                                                  init_flax_variables,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.resnet import STAGE_SIZES
    base = cfg.model.base_model if cfg.model.base_model in STAGE_SIZES \
        else "resnet18"
    net = ImageClassifier(base, num_class=0, fused_block=False)
    load_flax_variables(net, init_flax_variables(net, seed=0))
    return InferenceEngine(net, window_batch=16,
                           image_size=cfg.data.image_size, device=device,
                           input_rank=4)


def main(argv: Optional[List[str]] = None) -> None:
    """Dataset-level scoring / evaluation CLI (the JAX package's
    ``wd-eval``).

    Modes:
      --score OUT_DIR   score a split → per-video .score.json
                        (inference_dataset); exits 1 when the shard
                        scored nothing and its failure manifest is not
                        empty
      --eval            count + MAE/OBO over a split (eval_dataset);
                        prints one JSON line
      --merge-shards F1 F2 ...  merge per-shard counts JSONs → exact
                        global metrics (no engine, no device)
    Worker i of n passes --shard i/n to either mode. The engine runs on
    the card unless --cpu is given.
    """
    import argparse

    parser = argparse.ArgumentParser(
        description="Dataset scoring / rep-count evaluation")
    parser.add_argument("-ckpt", "--checkpoint", default=None,
                        help="port checkpoint file (CheckpointManager)")
    parser.add_argument("--cfg", default=None)
    parser.add_argument("--model-type", default="video", choices=MODEL_TYPES)
    parser.add_argument("--action", default="all")
    parser.add_argument("--split", default="test")
    parser.add_argument("--data-root", default=None)
    parser.add_argument("--anno", default=None)
    parser.add_argument("--score", default=None, metavar="OUT_DIR",
                        help="write .score.json per video into OUT_DIR")
    parser.add_argument("--eval", action="store_true",
                        help="count per video and print MAE/OBO")
    parser.add_argument("--threshold", type=float, default=0.0)
    parser.add_argument("-o", "--output-dir", default=None,
                        help="eval: per-video CSV (and annotated videos "
                             "with --save-video)")
    parser.add_argument("--save-video", action="store_true")
    parser.add_argument("--grid", action="store_true",
                        help="repnet: also score quadrant crops")
    parser.add_argument("--shard", default="0/1", metavar="I/N",
                        help="this worker's slice of the split")
    parser.add_argument("--counts-out", default=None,
                        help="eval: write this shard's counts JSON here")
    parser.add_argument("--merge-shards", nargs="+", default=None,
                        metavar="JSON",
                        help="merge counts JSONs → global metrics")
    parser.add_argument("--chunk-frames", type=int, default=None,
                        help="bound decode memory: stream each video in "
                             "chunks of this many frames")
    parser.add_argument("--skip-existing", action="store_true",
                        help="score: resume a preempted shard — skip "
                             "videos whose .score.json already parses")
    parser.add_argument("--resume", action="store_true",
                        help="eval: reload --counts-out and skip its "
                             "videos")
    parser.add_argument("--on-error", default="skip",
                        choices=["skip", "raise"],
                        help="per-video failure policy: 'skip' (default "
                             "for the CLI: a video that fails is recorded "
                             "in the shard's failures manifest and the "
                             "sweep continues) or 'raise'")
    parser.add_argument("--cpu", action="store_true",
                        help="run the engine on the CPU")
    parser.add_argument("opts", nargs="*", help="dotted config overrides")
    args = parser.parse_args(argv)

    try:
        i, n = map(int, args.shard.split("/"))
    except ValueError:
        parser.error(f"--shard must be I/N, got {args.shard!r}")
    if n < 1 or not 0 <= i < n:
        parser.error(f"--shard needs 0 <= I < N, got {args.shard!r}")
    if args.score is not None and args.model_type != "video":
        parser.error("--score writes windowed class-score JSONs and only "
                     "works with --model-type video (the reference's "
                     "inference_dataset is the video scorer); counting-only "
                     "model types go through --eval")
    data_root = args.data_root or osp.expanduser("~/data/RepCount/")
    anno_path = args.anno or osp.join(data_root, "annotation.csv")

    if args.merge_shards:
        mae, obo, res = eval_count_shards(args.merge_shards, data_root,
                                          anno_path,
                                          action=[args.action],
                                          split=[args.split])
        print(json.dumps({"mae": mae, "obo_acc": obo, "n_pred": len(res)}))
        return

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.infer import engine as engine_mod

    device = "cpu" if args.cpu else "cuda"
    cfg = load_config(args.cfg, args.opts)
    engine = None
    if args.model_type == "similarity":
        engine = similarity_engine(cfg, device)
    elif args.model_type != "motion":
        if args.model_type in ("image", "repnet"):
            # image: per-frame, a rank-4 engine
            cfg.model.model_type = args.model_type
        engine = engine_mod.engine_from_checkpoint(
            cfg, args.checkpoint, image_size=cfg.data.image_size,
            device=device)

    if args.score is not None:
        summary = inference_dataset(
            engine, [args.split], args.score,
            checkpoint=args.checkpoint or "none",
            data_root=data_root, anno_path=anno_path,
            shard=(i, n), chunk_frames=args.chunk_frames,
            skip_existing=args.skip_existing, on_error=args.on_error)
        print(json.dumps({"scored": len(summary["scored"]),
                          "skipped": len(summary["skipped"]),
                          "failed": sorted(summary["failed"]),
                          "shard": [i, n]}))
        if not summary["scored"] and summary["failed"]:
            print(f"wd-eval: shard {i}/{n} scored no video and "
                  f"{len(summary['failed'])} failed (manifest "
                  f"{_failures_path(args.score, (i, n))})", file=sys.stderr)
            sys.exit(1)
        return
    if not args.eval:
        parser.error("pass --score OUT_DIR, --eval, or --merge-shards")
    if args.resume and args.counts_out is None:
        parser.error("--resume needs --counts-out")
    mae, obo = eval_dataset(engine, action=[args.action], split=args.split,
                            data_root=data_root, anno_path=anno_path,
                            model_type=args.model_type,
                            output_dir=args.output_dir,
                            save_video=args.save_video,
                            threshold=args.threshold,
                            grid=args.grid,
                            shard=(i, n), counts_out=args.counts_out,
                            resume=args.resume, on_error=args.on_error,
                            device=device)
    print(json.dumps({"mae": mae, "obo_acc": obo, "shard": [i, n]}))


if __name__ == "__main__":
    main()
