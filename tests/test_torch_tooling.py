"""PyTorch port, the tooling: ``utils/profiling`` (``trace``, ``annotate``),
the trainer's ``log.profile_steps`` and ``log.watch_every_n_steps``, the
CSV, TensorBoard and W&B loggers, and the dataset, label and eval
scripts, each against the JAX package's on the same inputs.

One CPU fit (TSM-R18 at 32², ``profile_steps`` 2, ``watch_every_n_steps``
2, TensorBoard on, W&B on through a stand-in module) serves the profile,
watch, TensorBoard and W&B checks of the trainer. The script fixtures are copies of
``tests/test_utils_scripts.py``'s and ``tests/test_validate_dataset.py``'s
inputs. Nothing here opens a network connection: the download checks take
the paths that skip a present file, a missing yt-dlp and a local archive.
"""

import csv
import filecmp
import json
import os
import sys
import types
import warnings
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

import workoutdetector_tpu.scripts.build_datasets as j_build
import workoutdetector_tpu.scripts.cut as j_cut
import workoutdetector_tpu.scripts.download as j_download
import workoutdetector_tpu.scripts.extract_frames as j_extract
import workoutdetector_tpu.scripts.relabel as j_relabel
import workoutdetector_tpu.scripts.validate_dataset as j_validate
import workoutdetector_tpu.scripts.video_codecs as j_codecs
import workoutdetector_tpu.train.loggers as j_loggers
import workoutdetector_tpu_torch.scripts.build_datasets as build
import workoutdetector_tpu_torch.scripts.cut as cut
import workoutdetector_tpu_torch.scripts.download as download
import workoutdetector_tpu_torch.scripts.extract_frames as extract
import workoutdetector_tpu_torch.scripts.relabel as relabel
import workoutdetector_tpu_torch.scripts.validate_dataset as validate
import workoutdetector_tpu_torch.scripts.video_codecs as codecs
import workoutdetector_tpu_torch.train.loggers as loggers
from workoutdetector_tpu_torch.config import Config
from workoutdetector_tpu_torch.train.trainer import Trainer
from workoutdetector_tpu_torch.utils.profiling import annotate, trace

cv2 = pytest.importorskip("cv2")

SIZE, SEG = 32, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _debug_cfg(root: Path):
    cfg = Config()
    cfg.model.base_model, cfg.model.num_class = "resnet18", 2
    cfg.model.num_segments, cfg.model.dtype = SEG, "float32"
    d = cfg.data
    d.dataset_type, d.image_size, d.num_segments = "DebugDataset", SIZE, SEG
    d.debug_size, d.debug_num_class, d.batch_size, d.num_workers = 16, 2, 4, 2
    cfg.trainer.default_root_dir = str(root / "runs")
    cfg.trainer.max_epochs, cfg.trainer.log_every_n_steps = 1, 1
    cfg.callbacks.modelcheckpoint.dirpath = str(root / "ckpt")
    return cfg


class _Run:
    """A stand-in W&B run: records what the logger calls."""

    def __init__(self, calls):
        self.calls = calls
        self.config = types.SimpleNamespace(
            update=lambda params, **kw: calls.append(("config", params, kw)))

    def log(self, data, step=None):
        self.calls.append(("log", {k: v.values if isinstance(v, _Histogram)
                                   else v for k, v in data.items()}, step))


class _Histogram:
    def __init__(self, values):
        self.values = np.asarray(values).tolist()


def fake_wandb(calls):
    mod = types.ModuleType("wandb")
    mod.Histogram = _Histogram

    def init(**kw):
        calls.append(("init", kw))
        return _Run(calls)

    mod.init = init
    return mod


def _trace_events(path):
    with open(path) as f:
        return json.load(f)["traceEvents"]


def _accumulator(directory):
    """tensorboard's ``EventAccumulator`` over ``directory``, loaded whole.
    It reads local files through tensorboard's TensorFlow stub (its
    ``notf`` switch), not through TensorFlow, whose import takes ≈ 9 s."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorboard.compat.notf",
                   types.ModuleType("tensorboard.compat.notf"))
        from tensorboard.backend.event_processing.event_accumulator import \
            EventAccumulator
        acc = EventAccumulator(str(directory), size_guidance={
            "scalars": 0, "histograms": 0, "tensors": 0})
        acc.Reload()
    return acc


# ---------------------------------------------------------------- profiling

def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path):
    """The counterpart of ``test_extras.py::test_profiler_trace``: a trace
    file is written, and it holds the annotated region."""
    with trace(str(tmp_path / "prof")) as prof:
        with annotate("matmul"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = (tmp_path / "prof").iterdir()
    assert path.name.endswith(".pt.trace.json")
    names = {e.get("name") for e in _trace_events(path)}
    assert "matmul" in names and "aten::matmul" in names
    assert any(e.name == "matmul" for e in prof.events())


def test_traced_and_watched_fit(tmp_path):
    """One fit of 4 steps with ``profile_steps`` 2, ``watch_every_n_steps``
    2, TensorBoard and (a stand-in) W&B on: steps 2-3 traced as two
    ``ProfilerStep`` ranges into ``<run_dir>/profile``; what
    ``test_trainer.py::test_gradient_watch`` asserts of the JAX fit's
    metrics.csv, with the labels the leaves' paths; the TensorBoard events
    and the W&B calls of the same steps."""
    cfg = _debug_cfg(tmp_path)
    cfg.log.profile_steps = cfg.log.watch_every_n_steps = 2
    cfg.log.tensorboard_enable = cfg.log.wandb.enable = True
    cfg.trainer.enable_checkpointing = False
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "wandb", fake_wandb(calls))
        trainer = Trainer(cfg, device="cpu")
        state, _ = trainer.fit()
    (run,) = (tmp_path / "runs").iterdir()
    labels = trainer.param_leaf_paths(state)

    (path,) = (run / "profile").iterdir()
    events = _trace_events(path)
    steps = [e["name"] for e in events
             if e.get("name", "").startswith("ProfilerStep")]
    assert steps == ["ProfilerStep#1", "ProfilerStep#2"]  # #0: warm-up
    assert any(e.get("name") == "aten::convolution" for e in events)

    with open(run / "csv" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    watched = [r for r in rows if r.get("watch/grad_global_norm")]
    assert [r["step"] for r in watched] == ["2", "4"]
    assert "watch/grad_leaf_norms/mean" in rows[0].keys()
    leaves = [r["watch/grad_leaf_norms/argmax_leaf"] for r in rows
              if r.get("watch/grad_leaf_norms/argmax_leaf")]
    assert leaves and set(leaves) <= set(labels)
    assert all(float(r["watch/param_global_norm"]) > 0 for r in watched)

    acc = _accumulator(run / "tensorboard")
    assert [e.step for e in acc.Scalars("train/loss")] == [1, 2, 3, 4]
    assert [e.step for e in acc.Scalars("watch/grad_global_norm")] == [2, 4]
    hist = acc.Histograms("watch/param_leaf_norms")
    assert [e.step for e in hist] == [2, 4]
    assert hist[0].histogram_value.num == len(labels)
    assert any("hparams" in t for t in acc.Tags()["tensors"])

    assert calls[0] == ("init", {"project": cfg.log.wandb.project,
                                 "name": cfg.log.wandb.name,
                                 "dir": str(run), "mode": "offline"})
    assert calls[1][0] == "config" and calls[1][1] == cfg.to_dict()
    hists = [c for c in calls if c[0] == "log"
             and "watch/grad_leaf_norms" in c[1]]
    assert [c[2] for c in hists] == [2, 4]
    assert len(hists[0][1]["watch/param_leaf_norms"]) == len(labels)


def test_fit_without_profile_steps_writes_no_trace(tmp_path):
    cfg = _debug_cfg(tmp_path)
    cfg.trainer.max_steps, cfg.trainer.enable_checkpointing = 2, False
    cfg.log.tensorboard_enable = False
    Trainer(cfg, device="cpu").fit()
    (run,) = (tmp_path / "runs").iterdir()
    assert not (run / "profile").exists()


def test_fit_that_ends_in_the_profiler_warmup_writes_no_trace(tmp_path):
    """Step 1 is the profiler's warm-up: a fit of one step with
    ``profile_steps`` on records no step and writes no trace, as the JAX
    trainer, which starts its trace after step 1, writes none."""
    cfg = _debug_cfg(tmp_path)
    cfg.trainer.max_steps, cfg.trainer.enable_checkpointing = 1, False
    cfg.log.tensorboard_enable, cfg.log.profile_steps = False, 2
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no profiler schedule warning
        state, _ = Trainer(cfg, device="cpu").fit()
    assert state.step == 1
    (run,) = (tmp_path / "runs").iterdir()
    assert not list((run / "profile").glob("*.pt.trace.json"))


# ---------------------------------------------------------------- loggers

def _feed(lg, labels=("a/kernel", "b/bias", "c/scale")):
    rng = np.random.default_rng(0)
    lg.log_hyperparams({"lr": 0.1, "model": {"base": "resnet18"}})
    for step in (1, 2):
        lg.log_metrics({"train/loss": 0.5 / step, "lr": 0.1, "name": "x"},
                       step=step)
        lg.log_histograms({"watch/norms": rng.random(3).astype(np.float32),
                           "watch/empty": np.zeros(0, np.float32)},
                          step=step, labels=list(labels))
    if hasattr(lg, "close"):
        lg.close()


def test_csv_logger_matches_jax(tmp_path):
    _feed(loggers.CSVLogger(str(tmp_path / "port")))
    _feed(j_loggers.CSVLogger(str(tmp_path / "jax")))
    for name in ("metrics.csv", "hparams.json"):
        assert (tmp_path / "port" / "csv" / name).read_text() == \
            (tmp_path / "jax" / "csv" / name).read_text()


def _events(directory):
    acc = _accumulator(directory)
    tags = acc.Tags()
    return {"scalars": {t: [(e.step, e.value) for e in acc.Scalars(t)]
                        for t in tags["scalars"]},
            "histograms": {t: [(e.step, e.histogram_value.num,
                                e.histogram_value.sum)
                               for e in acc.Histograms(t)]
                           for t in tags["histograms"]},
            "tensors": sorted(tags["tensors"])}


@pytest.mark.parametrize("writer", ["tensorboardX",
                                    "torch.utils.tensorboard"])
def test_tensorboard_logger_matches_jax(tmp_path, monkeypatch, writer):
    """The port's events equal the JAX logger's, through tensorboardX and,
    where tensorboardX does not import (the card's machine), through
    ``torch.utils.tensorboard`` (tensorboard's TensorFlow stub standing in
    for TensorFlow, as in ``_accumulator``)."""
    jax_lg = j_loggers.TensorBoardLogger(str(tmp_path / "jax"))
    assert jax_lg.writer is not None
    _feed(jax_lg)
    if writer != "tensorboardX":
        monkeypatch.setitem(sys.modules, "tensorboardX", None)
        monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                            types.ModuleType("tensorboard.compat.notf"))
    port = loggers.TensorBoardLogger(str(tmp_path / "port"))
    assert type(port.writer).__module__.startswith(writer)
    _feed(port)
    got = _events(tmp_path / "port" / "tensorboard")
    assert got == _events(tmp_path / "jax" / "tensorboard")
    assert got["scalars"]["train/loss"] == [(1, 0.5), (2, 0.25)]
    assert [h[:2] for h in got["histograms"]["watch/norms"]] == [(1, 3), (2, 3)]


def test_tensorboard_and_wandb_loggers_without_their_packages(tmp_path,
                                                              monkeypatch):
    """Both packages' loggers do nothing where their writers (tensorboardX;
    the port's also torch.utils.tensorboard) or wandb do not import."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setitem(sys.modules, "wandb", None)
    for mod, name in ((loggers, "port"), (j_loggers, "jax")):
        tb = mod.TensorBoardLogger(str(tmp_path / name))
        wb = mod.WandbLogger(str(tmp_path / name), "p", None)
        assert tb.writer is None and wb.run is None
        _feed(tb)
        _feed(wb)
    assert not (tmp_path / "port" / "tensorboard").exists()


def test_wandb_logger_matches_jax(tmp_path, monkeypatch):
    seen = {}
    for mod, name in ((loggers, "port"), (j_loggers, "jax")):
        calls = seen[name] = []
        monkeypatch.setitem(sys.modules, "wandb", fake_wandb(calls))
        _feed(mod.WandbLogger(str(tmp_path), "proj", "run", offline=False))
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == ("init", {"project": "proj", "name": "run",
                                        "dir": str(tmp_path),
                                        "mode": "online"})


def test_build_loggers_matches_jax(tmp_path, monkeypatch):
    from workoutdetector_tpu.config import Config as JConfig
    monkeypatch.setitem(sys.modules, "wandb", fake_wandb([]))
    kinds = {}
    for cls, mod in ((Config, loggers), (JConfig, j_loggers)):
        cfg = cls()
        cfg.log.wandb.enable = True
        coll = mod.build_loggers(cfg, str(tmp_path / mod.__name__))
        kinds[cls] = [type(lg).__name__ for lg in coll.loggers]
        coll.log_histograms({"h": np.ones(2)}, step=1, labels=["x", "y"])
        coll.close()
    assert kinds[Config] == kinds[JConfig] == \
        ["CSVLogger", "TensorBoardLogger", "WandbLogger"]


# ---------------------------------------------------------------- scripts

def test_relabel_matches_jax(tmp_path):
    for args in (("stu2_48.mp4_00_00_09.943.png",),
                 ("x/v.mp4_01_01_01.000.png",)):
        assert relabel.process_screenshot(*args) == \
            j_relabel.process_screenshot(*args)
    for sec in (9.943, 3661.0, 9, 9.9435, 59.9997):
        assert relabel.name_to_png("v.mp4", sec) == \
            j_relabel.name_to_png("v.mp4", sec)
    shots = tmp_path / "shots"
    for split in ("train", "val", "test"):
        (shots / split).mkdir(parents=True)
    for sec in ("01.000", "02.000", "03.000", "04.000", "05.000", "06.000"):
        (shots / "train" / f"v1.mp4_00_00_{sec}.png").touch()
    for sec in ("00.500", "00.600", "01.900"):
        (shots / "val" / f"v2.mp4_00_00_{sec}.png").touch()
    for mod, name in ((relabel, "port"), (j_relabel, "jax")):
        mod.screenshots_to_csv(str(shots), str(tmp_path / f"{name}.csv"))
        mod.relabeled_csv_to_rawframe_list(str(tmp_path / f"{name}.csv"),
                                           str(tmp_path / f"{name}_lists"),
                                           video_fps=30)
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    cmp = filecmp.dircmp(tmp_path / "port_lists", tmp_path / "jax_lists")
    assert cmp.left_list == ["train.txt", "val.txt"] and not cmp.diff_files
    assert len((tmp_path / "port_lists" / "train.txt").read_text()
               .splitlines()) == 4


def _workout_sources(root: Path):
    """``test_utils_scripts.py::test_build_workout``'s inputs."""
    data_root = root / "data"
    for ds, splits in (("RepCount", ("train", "val", "test")),
                       ("Countix", ("train", "val"))):
        d = data_root / ds / "rawframes"
        d.mkdir(parents=True)
        for split in splits:
            (d / f"{split}.txt").write_text("vid1 100 0\nvid2 80 1\n")
            (d / split).mkdir()
    anno_root = root / "datasets"
    (anno_root / "RepCount").mkdir(parents=True)
    (anno_root / "Countix").mkdir(parents=True)
    (anno_root / "RepCount" / "classes.txt").write_text("\n".join(
        ["front_raise", "pull_up", "squat", "bench_pressing", "jumping_jack",
         "situp", "push_up", "battle_rope", "others"]))
    (anno_root / "Countix" / "classes.txt").write_text("\n".join(
        ["arm", "bench", "fr", "sq", "jj", "lu", "mc", "pu", "pushup",
         "situp"]))
    return data_root, anno_root


def _tree(root: Path) -> dict:
    """{relative path: file text, or the symlink's target relative to the
    tree}."""
    out = {}
    for p in sorted(root.rglob("*")):
        rel = str(p.relative_to(root))
        if p.is_symlink():
            out[rel] = ("link", os.path.relpath(os.readlink(p), root))
        elif p.is_file():
            out[rel] = p.read_text()
    return out


def test_build_workout_matches_jax(tmp_path):
    trees = {}
    for mod, name in ((build, "port"), (j_build, "jax")):
        data_root, anno_root = _workout_sources(tmp_path / name)
        mod.build_workout(
            data_root=str(data_root),
            repcount_classes_path=str(anno_root / "RepCount/classes.txt"),
            countix_classes_path=str(anno_root / "Countix/classes.txt"))
        trees[name] = _tree(tmp_path / name)
    assert trees["port"] == trees["jax"]
    train = trees["port"]["data/Workout/rawframes/train.txt"].splitlines()
    assert len(train) == 4 and train[0].startswith("RepCount/train/")


def _write_mp4(path: Path, n: int, fps: float = 30, hw=(48, 64), seed=0):
    rng = np.random.default_rng(seed)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps,
                        hw[::-1])
    for i in range(n):
        f = np.full(hw + (3,), (i * 7) % 256, np.uint8)
        f[8:24, (i * 3) % 40:(i * 3) % 40 + 16] = rng.integers(0, 256, 3)
        w.write(f)
    w.release()


def _frames(path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    out = []
    ok, f = cap.read()
    while ok:
        out.append(f)
        ok, f = cap.read()
    cap.release()
    return np.stack(out)


def test_build_image_and_video_rep_match_jax(tmp_path):
    data_dir = tmp_path / "videos"
    for split, name, n in (("train", "a.mp4", 40), ("val", "b.mp4", 36)):
        (data_dir / split).mkdir(parents=True, exist_ok=True)
        _write_mp4(data_dir / split / name, n, seed=n)
    anno = tmp_path / "annotation.csv"
    anno.write_text(",class_,split,name,vid,start,end,count,reps\n"
                    "0,squat,train,a.mp4,x,0,40,2,2 12 14 30\n"
                    "1,situp,val,b.mp4,y,0,36,1,4 20\n"
                    "2,squat,test,missing.mp4,z,0,9,1,0 4\n"
                    "3,others,train,a.mp4,x,0,40,1,0 9\n")
    for mod, name in ((build, "port"), (j_build, "jax")):
        mod.build_image_rep(str(data_dir), str(anno), str(tmp_path / name / "img"))
        mod.build_video_rep(str(data_dir), str(anno), str(tmp_path / name / "vid"))
    for kind in ("img", "vid"):
        port, jax_ = tmp_path / "port" / kind, tmp_path / "jax" / kind
        files = sorted(str(p.relative_to(port)) for p in port.rglob("*")
                       if p.is_file())
        assert files == sorted(str(p.relative_to(jax_))
                               for p in jax_.rglob("*") if p.is_file())
        for rel in files:
            if rel.endswith(".png"):
                assert np.array_equal(cv2.imread(str(port / rel)),
                                      cv2.imread(str(jax_ / rel))), rel
            elif rel.endswith(".mp4"):
                assert np.array_equal(_frames(port / rel),
                                      _frames(jax_ / rel)), rel
            else:
                assert (port / rel).read_text() == (jax_ / rel).read_text()
    assert len([f for f in (tmp_path / "port" / "img").rglob("*.png")]) == 4
    assert (tmp_path / "port" / "vid" / "train.csv").read_text() == \
        "train/a_0_0.mp4 8\ntrain/a_0_1.mp4 9\ntrain/a_1_0.mp4 8\n" \
        "train/a_1_1.mp4 9\n"


def test_cut_and_extract_frames_match_jax(tmp_path):
    """A 60 fps source cut to [0.5, 1.5) at 30 fps, and every frame of a
    video to JPEG folders, by both packages: the same frames."""
    _write_mp4(tmp_path / "fast.mp4", 120, fps=60)
    outs = {name: mod.cut_video(str(tmp_path), "fast", 0.5, 1.5,
                                str(tmp_path / f"cuts_{name}"))
            for mod, name in ((cut, "port"), (j_cut, "jax"))}
    got = _frames(outs["port"])
    assert np.array_equal(got, _frames(outs["jax"]))
    assert 28 <= len(got) <= 32
    src = tmp_path / "src" / "val"
    src.mkdir(parents=True)
    _write_mp4(src / "v.mp4", 10)
    assert extract.extract_video(str(src / "v.mp4"), str(tmp_path / "p")) == \
        j_extract.extract_video(str(src / "v.mp4"), str(tmp_path / "j")) == 10
    for i in (1, 5, 10):
        name = f"img_{i:05d}.jpg"
        assert np.array_equal(cv2.imread(str(tmp_path / "p" / name)),
                              cv2.imread(str(tmp_path / "j" / name)))
    extract.main(["-i", str(tmp_path / "src"), "-o", str(tmp_path / "tree")])
    j_extract.main(["-i", str(tmp_path / "src"), "-o", str(tmp_path / "jtree")])
    assert sorted(os.listdir(tmp_path / "tree" / "val" / "v")) == \
        sorted(os.listdir(tmp_path / "jtree" / "val" / "v"))


def _rawframe_root(root: Path) -> str:
    """``test_validate_dataset.py``'s ``rawframe_root``."""
    for vi in range(3):
        d = root / "rawframes" / f"v{vi}"
        d.mkdir(parents=True)
        for i in range(1, 9):
            cv2.imwrite(str(d / f"img_{i:05}.jpg"),
                        np.full((24, 32, 3), 17 * vi, np.uint8))
    anno = root / "train.txt"
    anno.write_text("".join(f"v{k} 1 8 {k % 2}\n" for k in range(3)))
    return str(anno)


def _repcount_root(root: Path) -> None:
    """``test_validate_dataset.py``'s ``repcount_root`` with the rows of
    its ``test_repcount_defects``."""
    import pandas as pd
    rows = [{"name": f"vid{i}.mp4", "class_": "squat", "split": "train",
             "count": count, "reps": reps, "vid": f"y{i}", "start": 0,
             "end": 30}
            for i, (count, reps) in enumerate([(2, "3 10 12 20"), (1, "5 9")])]
    rows += [
        {"name": "badcount.mp4", "class_": "squat", "split": "train",
         "count": 3, "reps": "3 10 12 20", "vid": "y", "start": 0, "end": 1},
        {"name": "badorder.mp4", "class_": "squat", "split": "train",
         "count": 1, "reps": "9 5", "vid": "y", "start": 0, "end": 1},
        {"name": "overlap.mp4", "class_": "squat", "split": "train",
         "count": 2, "reps": "3 10 5 20", "vid": "y", "start": 0, "end": 1},
        {"name": "nomedia.mp4", "class_": "squat", "split": "train",
         "count": 1, "reps": "1 2", "vid": "y", "start": 0, "end": 1},
        {"name": "farbound.mp4", "class_": "squat", "split": "val",
         "count": 1, "reps": "1 500", "vid": "y", "start": 0, "end": 1}]
    root.mkdir(parents=True, exist_ok=True)
    pd.DataFrame(rows).to_csv(root / "annotation.csv")
    for split, name in (("train", "vid0"), ("train", "vid1"),
                        ("train", "badcount"), ("train", "badorder"),
                        ("train", "overlap"), ("val", "farbound")):
        d = root / "rawframes" / split / name
        d.mkdir(parents=True)
        for k in range(1, 25):
            cv2.imwrite(str(d / f"img_{k:05}.jpg"),
                        np.zeros((8, 8, 3), np.uint8))


def _break(case: str, root: Path, anno: str) -> None:
    """The defects of ``test_validate_dataset.py``, one per case."""
    if case == "missing_frame":
        os.remove(root / "rawframes" / "v1" / "img_00005.jpg")
    elif case == "missing_dir_and_bad_label":
        with open(anno, "a") as f:
            f.write("ghost 1 8 1\nv0 1 8 9\n")
    elif case == "corrupt_jpeg":
        (root / "rawframes" / "v2" / "img_00008.jpg").write_bytes(
            b"\xff\xd8\xff\xe0" + bytes(range(32)))
    elif case == "nonpositive_total":
        Path(anno).write_text("v0 1 0 0\n")


@pytest.mark.parametrize("case", ["healthy", "missing_frame",
                                  "missing_dir_and_bad_label",
                                  "corrupt_jpeg", "nonpositive_total"])
def test_validate_rawframe_list_matches_jax(tmp_path, case, capsys):
    """The same issues, in order, for each defect of the JAX tests, from
    every probe depth, and the same CLI output and exit code."""
    anno = _rawframe_root(tmp_path)
    _break(case, tmp_path, anno)
    for probe in ("none", "sample", "full"):
        got = [str(i) for i in validate.validate_rawframe_list(
            anno, str(tmp_path), "rawframes", num_class=2, probe=probe)]
        assert got == [str(i) for i in j_validate.validate_rawframe_list(
            anno, str(tmp_path), "rawframes", num_class=2, probe=probe)]
    assert (got == []) == (case == "healthy")
    argv = ["--rawframe-list", anno, "--data-root", str(tmp_path),
            "--data-prefix", "rawframes", "--num-class", "2"]
    rc = validate.main(argv)
    out = capsys.readouterr().out
    assert rc == j_validate.main(argv) == (0 if case == "healthy" else 1)
    assert out == capsys.readouterr().out


def test_validate_repcount_and_videos_match_jax(tmp_path, capsys):
    root = tmp_path / "RepCount"
    _repcount_root(root)
    got = [str(i) for i in validate.validate_repcount(str(root))]
    assert got == [str(i) for i in j_validate.validate_repcount(str(root))]
    assert len(got) == 5 and got[-1].startswith("[warning] farbound.mp4")
    videos = tmp_path / "videos"
    videos.mkdir()
    _write_mp4(videos / "ok.mp4", 12)
    (videos / "broken.mp4").write_bytes(b"not a container")
    got = [str(i) for i in validate.validate_videos(str(videos))]
    assert got == [str(i) for i in j_validate.validate_videos(str(videos))]
    assert len(got) == 1 and "broken.mp4" in got[0]
    argv = ["--repcount-root", str(root), "--videos", str(videos)]
    assert validate.main(argv) == j_validate.main(argv) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[:len(out) // 2] == out[len(out) // 2:]


def test_video_codecs_probe_matches_jax():
    got = codecs.probe()
    assert got == j_codecs.probe()
    assert got["encoders"]["mp4v.mp4"]


def test_download_matches_jax(tmp_path, monkeypatch):
    """parse_onedrive gives the same URL; a present video is not fetched
    again; without yt-dlp a fetch raises a RuntimeError naming it; a
    present archive is only unzipped. No connection is opened."""
    for link in ("https://1drv.ms/u/s!AiohV3HRf-34ipk0i1y2P1txpKYXFw",
                 "https://1drv.ms/u/s!AAAA"):
        assert download.parse_onedrive(link) == j_download.parse_onedrive(link)
    for mod in (download, j_download):
        with pytest.raises(AssertionError):
            mod.parse_onedrive("https://example.com/x")
    monkeypatch.setitem(sys.modules, "yt_dlp", None)
    present = tmp_path / "dQw4w9WgXcQ.mp4"
    present.write_bytes(b"x")
    url = "https://www.youtube.com/watch?v=dQw4w9WgXcQ"
    for mod in (download, j_download):
        assert mod.download_ytb(url, str(tmp_path)) == str(present)
        with pytest.raises(RuntimeError, match="yt-dlp"):
            mod.download_ytb("https://www.youtube.com/watch?v=abcdefghijk",
                             str(tmp_path))
    (tmp_path / "countix.csv").write_text("video_id\ndQw4w9WgXcQ\n")
    download.download_countix(str(tmp_path / "countix.csv"), str(tmp_path))
    archive = tmp_path / "dl" / "data.zip"
    archive.parent.mkdir()
    with zipfile.ZipFile(archive, "w") as z:
        z.writestr("RepCount/annotation.csv", "name\n")
    for mod, name in ((download, "port"), (j_download, "jax")):
        mod.download_and_extract("http://localhost:1/unused", str(archive.parent),
                                 "data.zip", str(tmp_path / name))
    assert (tmp_path / "port" / "RepCount" / "annotation.csv").read_text() == \
        (tmp_path / "jax" / "RepCount" / "annotation.csv").read_text()


def _frame_cfg(root: Path, cls):
    """A FrameDataset val split of 9 noisy 8-frame clips in 3 classes."""
    cfg = cls()
    cfg.model.base_model, cfg.model.num_class = "resnet18", 3
    cfg.model.num_segments, cfg.model.dtype = SEG, "float32"
    d = cfg.data
    d.dataset_type, d.num_segments, d.image_size = "FrameDataset", SEG, SIZE
    d.scale_size, d.batch_size, d.num_workers = 40, 4, 2
    d.data_root, d.val.anno, d.val.data_prefix = str(root), str(root / "val.txt"), ""
    return cfg


def test_evaluate_split_matches_jax(tmp_path):
    """The per-class accuracies of the port's engine and the JAX one on
    the same weights and FrameDataset clips are identical."""
    from workoutdetector_tpu.config import Config as JConfig
    from workoutdetector_tpu.data.datasets import \
        build_dataset as j_build_dataset
    from workoutdetector_tpu.infer.engine import InferenceEngine as JEngine
    from workoutdetector_tpu.models import TSM as JaxTSM
    from workoutdetector_tpu.scripts.eval_classification import \
        evaluate_split as j_evaluate_split
    from workoutdetector_tpu_torch.data.datasets import build_dataset
    from workoutdetector_tpu_torch.infer.engine import InferenceEngine
    from workoutdetector_tpu_torch.models import TSM, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.scripts.eval_classification import \
        evaluate_split

    rng = np.random.default_rng(0)
    lines = []
    for k in range(9):
        d = tmp_path / f"clip{k}"
        d.mkdir()
        for i in range(1, 9):
            cv2.imwrite(str(d / f"img_{i:05}.jpg"),
                        rng.integers(0, 256, (36, 48, 3), dtype=np.uint8))
        lines.append(f"clip{k} 1 8 {k % 3}\n")
    (tmp_path / "val.txt").write_text("".join(lines))
    model = TSM(3, SEG, "resnet18")
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    got = evaluate_split(
        InferenceEngine(model, SEG, window_batch=4, image_size=SIZE,
                        device="cpu"),
        build_dataset(_frame_cfg(tmp_path, Config).data, "val", "cpu"), 4, 2)
    jmodel = JaxTSM(num_class=3, num_segments=SEG, base_model="resnet18",
                    dropout=0.0, dtype=np.float32)
    want = j_evaluate_split(
        JEngine(jmodel, variables, num_segments=SEG, window_batch=4,
                image_size=SIZE),
        j_build_dataset(_frame_cfg(tmp_path, JConfig).data, "val"), 4, 2)
    assert got == want
    assert set(got) == {"class_0", "class_1", "class_2", "overall"}


def test_eval_classification_cli_writes_the_per_class_json(tmp_path):
    from workoutdetector_tpu_torch.scripts import eval_classification as ec
    yaml = Path(__file__).resolve().parents[1] / "workoutdetector_tpu" / \
        "configs" / "repcount_12_tsm.yaml"
    out = tmp_path / "acc.json"
    opts = ["data.dataset_type=DebugDataset", "data.debug_size=8",
            "data.debug_num_class=2", f"data.image_size={SIZE}",
            f"data.num_segments={SEG}", "data.batch_size=4",
            "model.base_model=resnet18", "model.num_class=2",
            f"model.num_segments={SEG}", "model.dtype=float32"]
    results = ec.main(["--cpu", "--cfg", str(yaml), "--splits", "val",
                       "test", "-o", str(out)] + opts)
    assert json.loads(out.read_text()) == results
    assert set(results) == {"val", "test"}
    assert set(results["val"]) == {"class_0", "class_1", "overall"}
    assert all(0.0 <= v <= 1.0 for v in results["val"].values())
