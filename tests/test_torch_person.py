"""PyTorch port, the person crop and its tooling: ``data/synthetic.py``,
``data/person.py`` (the motion boxes, ``Detector``, ``PersonCrop``),
``build_dataset`` with a test split's ``person_crop``, one learned
backend shared by loader threads, ``scripts/bbox.py``, ``data/countix.py``
and ``utils/view.py``, against the JAX package on the CPU.

Everything here is numpy, cv2 or file IO on both sides, so the bar is
identity: arrays, boxes, items, JSON and written files bit for bit.
"""

import filecmp
import json
import os
import pickle
import sys
import threading

import cv2
import numpy as np
import pytest
import torch

from workoutdetector_tpu.config import Config as JaxConfig
from workoutdetector_tpu.data import countix as jcountix
from workoutdetector_tpu.data import person as jperson
from workoutdetector_tpu.data import synthetic as jsyn
from workoutdetector_tpu.data.datasets import build_dataset as j_build_dataset
from workoutdetector_tpu.data.repcount import RepcountHelper as JaxHelper
from workoutdetector_tpu.scripts import bbox as jbbox
from workoutdetector_tpu.utils import view as jview
from workoutdetector_tpu_torch.config import Config
from workoutdetector_tpu_torch.data import countix as tcountix
from workoutdetector_tpu_torch.data import person as tperson
from workoutdetector_tpu_torch.data import synthetic as tsyn
from workoutdetector_tpu_torch.data.datasets import build_dataset
from workoutdetector_tpu_torch.data.repcount import RepcountHelper
from workoutdetector_tpu_torch.models import detector as tdet
from workoutdetector_tpu_torch.models.convert import (load_flax_variables,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.scripts import bbox as tbbox
from workoutdetector_tpu_torch.utils import view as tview


def _same_list(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def _moving_clip(t=16, h=72, w=96, seed=0):
    """A textured block drifting over a noisy background, one flash."""
    rng = np.random.default_rng(seed)
    clip = rng.integers(20, 40, (t, h, w, 3), np.uint8)
    rows = (200 + (np.arange(h // 2) % 3) * 10)[:, None, None]
    for i in range(t):
        x = 10 + 3 * i
        clip[i, h // 4:h // 4 + h // 2, x:x + 14] = rows
    clip[t // 2] = np.clip(clip[t // 2].astype(int) + 50, 0, 255)
    return clip


# --------------------------------------------------------------- synthetic
@pytest.mark.parametrize("name,kw", [
    ("person_scene", dict(size=64, t=8, drift=1.5)),
    ("person_scene", dict(size=96, t=1, drift=0.0)),
    ("pose_scene", dict(size=64, t=3, jitter=0.02)),
    ("repcount_video_frames", dict(action="squat", n_reps=3, size=32)),
    ("repcount_video_frames", dict(action="situp", n_reps=0, size=24))])
def test_scenes_are_bit_identical(name, kw):
    got = getattr(tsyn, name)(np.random.default_rng(7), **kw)
    want = getattr(jsyn, name)(np.random.default_rng(7), **kw)
    for g, w in zip(got, want):
        if isinstance(w, list):
            assert g == w
        else:
            assert g.dtype == w.dtype and np.array_equal(g, w)


@pytest.mark.parametrize("name", ["person_dataset", "pose_dataset"])
def test_datasets_are_bit_identical(name):
    got = getattr(tsyn, name)(6, size=48, seed=2)
    want = getattr(jsyn, name)(6, size=48, seed=2)
    assert np.array_equal(got[0], want[0])
    _same_list(got[1], want[1])


def test_corpus_files_and_iou_are_identical(tmp_path):
    got = tsyn.build_repcount_corpus(str(tmp_path / "a"), n_videos=6,
                                     size=32, seed=1)
    want = jsyn.build_repcount_corpus(str(tmp_path / "b"), n_videos=6,
                                      size=32, seed=1)
    assert got.equals(want)
    names = []
    for root, _, files in os.walk(tmp_path / "b"):
        for f in files:
            names.append(f)
            mine = os.path.join(root, f).replace(str(tmp_path / "b"),
                                                 str(tmp_path / "a"))
            assert filecmp.cmp(mine, os.path.join(root, f), shallow=False), f
    assert "annotation.csv" in names and len(names) == 8
    assert tsyn.REPCOUNT_ACTIONS == jsyn.REPCOUNT_ACTIONS
    rng = np.random.default_rng(0)
    for _ in range(20):
        a, b = rng.uniform(0, 50, (2, 4)).astype(np.float32)
        assert tsyn.iou(a, b) == jsyn.iou(a, b)


# ---------------------------------------------------------------- person
@pytest.mark.parametrize("t", [1, 2, 16])
def test_motion_boxes_match_jax(t):
    clip = _moving_clip(t=t)
    _same_list(tperson._motion_boxes(clip), jperson._motion_boxes(clip))
    for kw in ({}, dict(window=3, k_sigma=1.5, min_aspect=1.5)):
        _same_list(tperson.aggregate_motion_boxes(clip, **kw),
                   jperson.aggregate_motion_boxes(clip, **kw))
    still = np.zeros((4, 16, 16, 3), np.uint8)
    _same_list(tperson._motion_boxes(still), jperson._motion_boxes(still))
    _same_list(tperson.aggregate_motion_boxes(still),
               jperson.aggregate_motion_boxes(still))


@pytest.mark.parametrize("backend", ["motion", "motion-agg", "none"])
def test_person_crop_matches_jax(backend):
    clip = _moving_clip()
    if backend == "none":
        port = tperson.Detector(lambda c: [np.zeros((0, 4))] * len(c))
        jax = jperson.Detector(lambda c: [np.zeros((0, 4))] * len(c))
    else:
        port, jax = tperson.Detector(backend), jperson.Detector(backend)
    got, want = tperson.PersonCrop(port)(clip), jperson.PersonCrop(jax)(clip)
    assert np.array_equal(got, want)
    assert (got is clip) == (backend == "none")
    assert repr(tperson.PersonCrop()) == "PersonCrop()"


def test_detector_passes_the_threshold_by_signature():
    seen = []

    def scored(clip, threshold=0.3):
        seen.append(threshold)
        return [np.zeros((0, 4))] * len(clip)

    def unscored(clip):
        seen.append("none")
        raise TypeError("a backend's own error")

    clip = _moving_clip(t=3)
    tperson.Detector(scored).detect(clip, threshold=0.7)
    tperson.Detector(scored).detect(clip)
    with pytest.raises(TypeError, match="own error"):
        tperson.Detector(unscored).detect(clip, threshold=0.7)
    assert seen == [0.7, 0.3, "none"]
    _same_list(tperson.Detector("motion").detect(clip, threshold=0.9),
               jperson.Detector("motion").detect(clip, threshold=0.9))
    with pytest.raises(ValueError, match="checkpoint"):
        tperson.Detector(backend="learned")


# ---------------------------------------------------------- build_dataset
@pytest.fixture(scope="module")
def rawframes(tmp_path_factory):
    """Two rawframe folders of 12 JPEGs at 96×72 and their list."""
    root = tmp_path_factory.mktemp("frames")
    lines = []
    for k in range(2):
        d = root / f"v{k}"
        d.mkdir()
        for i, f in enumerate(_moving_clip(t=12, seed=k)):
            cv2.imwrite(str(d / f"img_{i + 1:05}.jpg"), f[..., ::-1])
        lines.append(f"v{k} 1 12 {k}")
    (root / "test.txt").write_text("\n".join(lines) + "\n")
    return root


def _crop_configs(root, **data):
    cfgs = []
    for cfg in (Config(), JaxConfig()):
        d = cfg.data
        d.data_root, d.num_segments, d.image_size = str(root), 4, 32
        d.test.anno, d.test.person_crop = str(root / "test.txt"), True
        for k, v in data.items():
            setattr(d, k, v)
        cfgs.append(d)
    return cfgs


def test_build_dataset_person_crop_matches_jax(rawframes):
    """A test split's ``person_crop`` with the motion backend: the items
    of the JAX dataset, bit for bit (the crop replaces the decoder's
    resize and centre crop, on both sides)."""
    port, jax = _crop_configs(rawframes)
    got_ds, want_ds = build_dataset(port, "test"), j_build_dataset(jax, "test")
    assert type(got_ds.transform.person_crop).__name__ == "PersonCrop"
    for i in range(2):
        got, want = got_ds[i], want_ds[i]
        assert got[1] == want[1] and got[0].shape == (4, 32, 32, 3)
        assert np.array_equal(got[0], want[0])


def test_build_dataset_learned_crop_and_device(rawframes, tmp_path):
    """The learned backend through ``build_dataset``: on the CPU when the
    caller names it, a refusal without a card by default; a train split
    builds no detector."""
    model = tdet.CenterNetDetector()
    load_flax_variables(model, random_flax_variables(model, seed=0))
    path = str(tmp_path / "det.pt")
    tdet.LearnedDetectorBackend(model, input_size=64, device="cpu").save(path)
    cfg = _crop_configs(rawframes, person_backend="learned",
                        person_checkpoint=path)[0]
    ds = build_dataset(cfg, "test", device="cpu")
    item, label = ds[1]
    assert item.shape == (4, 32, 32, 3) and label == 1
    backend = ds.transform.person_crop.detector._fn
    assert isinstance(backend, tdet.LearnedDetectorBackend)
    assert backend.device.type == "cpu" and backend.input_size == 64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            build_dataset(cfg, "test")
    cfg.train = cfg.test
    assert build_dataset(cfg, "train").transform.__class__.__name__ == \
        "TrainTransform"


def test_one_backend_serves_many_threads():
    """Loader threads share one learned backend: 8 threads × 6 calls give
    the boxes of sequential calls."""
    model = tdet.CenterNetDetector()
    load_flax_variables(model, random_flax_variables(model, seed=1))
    backend = tdet.LearnedDetectorBackend(model, input_size=32, batch=4,
                                          device="cpu")
    clips = [_moving_clip(t=5 + k, h=40, w=48, seed=k) for k in range(8)]
    want = [backend(c, threshold=0.05) for c in clips]
    got = [None] * (8 * 6)
    errors = []

    def work(k):
        try:
            for j in range(6):
                got[k * 6 + j] = backend(clips[k], threshold=0.05)
        except Exception as exc:  # reported below
            errors.append(exc)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads) and not errors
    for i, boxes in enumerate(got):
        _same_list(boxes, want[i // 6])


# --------------------------------------------------------------- scripts
@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bbox") / "move.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24, (96, 72))
    for f in _moving_clip(t=20):
        w.write(f[..., ::-1])
    w.release()
    return path


def test_bbox_script_matches_jax(video, tmp_path):
    got = tbbox.bboxes_to_json(video, str(tmp_path / "a.json"))
    want = jbbox.bboxes_to_json(video, str(tmp_path / "b.json"))
    assert got == want and got["total_frames"] == 20
    assert filecmp.cmp(tmp_path / "a.json", tmp_path / "b.json",
                       shallow=False)
    tbbox.main(["json", "-i", video, "-o", str(tmp_path / "c.json"),
                "--backend", "motion-agg"])
    agg = jbbox.bboxes_to_json(video, None, jperson.Detector("motion-agg"))
    assert json.loads((tmp_path / "c.json").read_text()) == agg
    for fn in ("draw_boxes", "crop_and_save"):
        getattr(tbbox, fn)(video, str(tmp_path / f"{fn}_a.mp4"))
        getattr(jbbox, fn)(video, str(tmp_path / f"{fn}_b.mp4"))
        assert filecmp.cmp(tmp_path / f"{fn}_a.mp4", tmp_path / f"{fn}_b.mp4",
                           shallow=False), fn
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tbbox.main(["json", "-i", video, "-o", str(tmp_path / "d.json"),
                        "--backend", "learned", "--checkpoint", "x.pt"])


def test_countix_matches_jax(tmp_path):
    anno, data = tmp_path / "anno", tmp_path / "data"
    anno.mkdir()
    (data / "pose").mkdir(parents=True)
    head = ("video_id,class,kinetics_start,kinetics_end,repetition_start,"
            "repetition_end,count\n")
    (anno / "workouts_train.csv").write_text(
        head + "abc,squat,0.0,10.0,1.5,8.25,7\nxyz,situp,3,13,4.0,12.0,12\n")
    (anno / "workouts_val.csv").write_text(
        head + "val1,push up,0,10,0.5,9.5,3\n")
    items = [{"frame_dir": "abc", "keypoint": np.zeros((1, 2, 17, 2))},
             {"frame_dir": "zzz", "keypoint": np.ones((1, 2, 17, 2))}]
    with open(data / "pose" / "countix_train.pkl", "wb") as f:
        pickle.dump(items, f)
    got = tcountix.Countix(str(anno), str(data), load_pose=True)
    want = jcountix.Countix(str(anno), str(data), load_pose=True)
    assert len(got.anno_all) == len(want.anno_all) == 3
    assert got.anno_all == want.anno_all.to_dict("records")
    for vid in ("abc", "xyz", "val1"):
        assert got.get_count(vid) == want.get_count(vid)
        assert got.get_video(vid) == want.get_video(vid)
    assert sorted(got.pose_data) == sorted(want.pose_data) == ["abc", "zzz"]
    assert got.get_pose("abc")["count"] == want.get_pose("abc")["count"] == 7
    assert "count" not in got.get_pose("zzz")
    for fn, arg in (("get_count", "nope"), ("get_pose", "xyz"),
                    ("get_anno", "test")):
        with pytest.raises(ValueError):
            getattr(got, fn)(arg)
    assert repr(got).startswith("Countix(")


def test_view_gallery_matches_jax(tmp_path):
    root = tmp_path / "RepCount"
    frames = root / "rawframes" / "val" / "v0"
    frames.mkdir(parents=True)
    for i, f in enumerate(_moving_clip(t=12)):
        cv2.imwrite(str(frames / f"img_{i + 1:05}.jpg"), f[..., ::-1])
    (root / "annotation.csv").write_text(
        ",class_,split,name,vid,start,end,count,reps\n"
        "0,squat,val,v0.mp4,syn00000000,0,12,2.0,0 4 6 11\n")
    anno = str(root / "annotation.csv")
    got = tview.rep_frames_for_video(RepcountHelper(str(root), anno), "v0.mp4")
    want = jview.rep_frames_for_video(JaxHelper(str(root), anno), "v0.mp4")
    assert got[1] == want[1] and len(got[1]) == 6
    _same_list(got[0], want[0])
    out = tview.show_one_video(RepcountHelper(str(root), anno), "v0.mp4",
                               str(tmp_path / "g.png"))
    assert out == str(tmp_path / "g.png") and os.path.getsize(out) > 0
