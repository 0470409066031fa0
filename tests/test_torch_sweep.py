"""PyTorch port, decode → score a split → counts and MAE/OBO, against the
JAX package on the same inputs (CPU).

The corpus is the JAX package's ``build_repcount_corpus(root, n_videos=6,
size=48, seed=0)`` (mp4 through cv2; 1 train, 5 val, 1 test video), built
once for the module. Bounds:

- decoded frames: bit-identical on both backends (native and cv2);
- annotations, counting functions, counts, MAE/OBO, merged-shard metrics,
  failure manifests, CLI output: identical;
- score JSONs: the same schema and keys; logits of the brightness
  stand-in within 1e-5 of its exact (float64) value, and of the JAX JSON
  within the JAX stand-in's own fp32 summation error + 1e-5; logits of
  TSM-R50 at 32 px in fp32 (the JAX model through XLA on the
  same numpy-seeded flax weights), 0 argmax mismatches under
  ``compare_dirs``;
- chunked against whole-video scoring in the port: bit-identical (the
  batches hold other windows, and each window's logits do not depend on
  its neighbours on the CPU).
"""

import csv
import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_infer import BrightnessModel as JaxBrightness
from test_torch_tsm import randomized_variables
from workoutdetector_tpu import counting as jcounting
from workoutdetector_tpu.data import repcount as jrepcount
from workoutdetector_tpu.data import video as jvideo
from workoutdetector_tpu.data.synthetic import build_repcount_corpus
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import engine as jengine_mod
from workoutdetector_tpu.infer import inference_count as jic
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.scripts.compare_scores import \
    compare_dirs as jcompare_dirs
from workoutdetector_tpu_torch import counting
from workoutdetector_tpu_torch.data import repcount, video
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.infer import engine as engine_mod
from workoutdetector_tpu_torch.infer import inference_count as ic
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.scripts.compare_scores import compare_dirs
from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager

SIZE = 32
REFERENCE_ANNO = "/root/reference/datasets/RepCount/annotation.csv"
TSM_YAML = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "workoutdetector_tpu", "configs",
    "repcount_12_tsm.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small models: one intra-op thread, so the parallel test workers do
    not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("repcount"))
    build_repcount_corpus(root, n_videos=6, size=48, seed=0)
    return root


class Brightness(torch.nn.Module):
    """The port's counterpart of test_infer's BrightnessModel: class =
    mean brightness > 0 of the normalized window."""
    num_class = 2

    def forward(self, x):
        logit = x.mean(dim=tuple(range(1, x.dim()))) * 10.0
        return torch.stack([-logit, logit], dim=-1)


@pytest.fixture(scope="module")
def bright():
    """(JAX engine, port engine) over the brightness stand-in."""
    model = JaxBrightness()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, 8, SIZE, SIZE, 3)))
    jeng = JaxEngine(model, variables, num_segments=8, window_batch=4,
                     image_size=SIZE)
    teng = InferenceEngine(Brightness(), num_segments=8, window_batch=4,
                           image_size=SIZE, device="cpu")
    return jeng, teng


def _with_bad_video(corpus, dst, name="val3.mp4"):
    """A copy of the corpus in which ``name`` is not a video."""
    shutil.copytree(corpus, dst)
    with open(os.path.join(dst, "videos", "val", name), "wb") as f:
        f.write(b"not a video")
    return str(dst)


@pytest.fixture(scope="module")
def bright_sweeps(corpus, bright, tmp_path_factory):
    """Both stacks' brightness sweeps of the val split of a corpus copy
    with one undecodable video, on_error='skip': score JSONs and counts."""
    tmp = tmp_path_factory.mktemp("bright")
    root = _with_bad_video(corpus, tmp / "corpus")
    out = {}
    for tag, eng, mod in (("jax", bright[0], jic), ("port", bright[1], ic)):
        d = str(tmp / f"scores_{tag}")
        summary = mod.inference_dataset(eng, ["val"], d, "ckpt",
                                        data_root=root, on_error="skip")
        counts = str(tmp / f"counts_{tag}" / "counts.json")
        os.makedirs(os.path.dirname(counts))
        metrics = mod.eval_dataset(eng, ["all"], "val", root,
                                   counts_out=counts, on_error="skip")
        out[tag] = dict(dir=d, summary=summary, counts=counts,
                        metrics=metrics)
    out["root"] = root
    return out


def _load(path):
    with open(path) as f:
        return json.load(f)


# ------------------------------------------------------------- decoder
@pytest.mark.parametrize("prefer_native", [True, False])
def test_decoder_matches_jax(corpus, prefer_native):
    if prefer_native and not jvideo.native_available():
        pytest.skip("native/libwdvideo.so does not load here")
    for split, name in (("val", "val3.mp4"), ("test", "test6.mp4")):
        path = os.path.join(corpus, "videos", split, name)
        with video.VideoReader(path, prefer_native) as r, \
                jvideo.VideoReader(path, prefer_native) as jr:
            assert (r.fps, r.frame_count, r.dims) == \
                (jr.fps, jr.frame_count, jr.dims)
            whole = r.read_prepped(256, SIZE)
            np.testing.assert_array_equal(whole, jr.read_prepped(256, SIZE))
        with video.VideoReader(path, prefer_native) as r, \
                jvideo.VideoReader(path, prefer_native) as jr:
            # a scale below the 48-px source: the downscaling interpolation
            small = r.read_prepped(40, 24, max_frames=20)
            np.testing.assert_array_equal(small,
                                          jr.read_prepped(40, 24, max_frames=20))
        assert small.shape == (20, 24, 24, 3)
        assert whole.shape[1:] == (SIZE, SIZE, 3) and len(whole) > 60
        for chunk in (7, 64):
            with video.VideoReader(path, prefer_native) as r, \
                    jvideo.VideoReader(path, prefer_native) as jr:
                parts = list(r.iter_prepped(256, SIZE, chunk=chunk))
                jparts = list(jr.iter_prepped(256, SIZE, chunk=chunk))
            assert [len(p) for p in parts] == [len(p) for p in jparts]
            for p, jp in zip(parts, jparts):
                np.testing.assert_array_equal(p, jp)
            np.testing.assert_array_equal(np.concatenate(parts), whole)
    with pytest.raises(FileNotFoundError):
        video.VideoReader(os.path.join(corpus, "missing.mp4"), prefer_native)


def test_decoder_without_backends_names_both(corpus, monkeypatch):
    monkeypatch.setattr(video, "_LIB", None)
    monkeypatch.setattr(video, "_LIB_ERROR", "libavformat.so.59: cannot open")
    monkeypatch.setitem(sys.modules, "cv2", None)  # import cv2 → ImportError
    path = os.path.join(corpus, "videos", "val", "val2.mp4")
    with pytest.raises(RuntimeError, match=r"native/libwdvideo.so: "
                       r"libavformat.so.59: cannot open; cv2: not installed"):
        video.VideoReader(path)


# ---------------------------------------------------- annotations, counting
def _edge_annotation(path):
    """A hand-written annotation: float, empty and NaN counts, actions
    outside the six (one named 'all'), empty vid and start cells."""
    rows = [["", "class_", "split", "name", "vid", "start", "end", "count",
             "reps"],
            ["0", "squat", "val", "a.mp4", "x1", "0", "90", "2.0", "0 9 20 30"],
            ["1", "squat", "val", "b.mp4", "", "", "40", "", ""],
            ["2", "situp", "val", "c.mp4", "x3", "5", "70", "NaN", "1 2"],
            ["3", "others", "val", "d.mp4", "x4", "0", "10", "1", "3 7"],
            ["4", "push_up", "test", "e.mp4", "x5", "0", "50", "3.0",
             "0 5 6 9 10 20"],
            ["5", "all", "val", "f.mp4", "x6", "1", "2", "1.0", "4 8"]]
    with open(path, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return str(path)


def _plain(value):
    """numpy scalars as Python values; NaN as a marker that equals NaN."""
    if isinstance(value, np.generic):
        value = value.item()
    if isinstance(value, float) and np.isnan(value):
        return "NaN"
    return value


def _fields(items):
    return {k: {f: _plain(v) for f, v in item.__dict__.items()}
            for k, item in items.items()}


@pytest.mark.parametrize("source", ["corpus", "edge", "reference"])
def test_repcount_helper_matches_jax(corpus, tmp_path, source):
    if source == "corpus":
        anno = os.path.join(corpus, "annotation.csv")
    elif source == "edge":
        anno = _edge_annotation(tmp_path / "annotation.csv")
    else:
        if not os.path.isfile(REFERENCE_ANNO):
            pytest.skip("the RepCount annotation pack is not mounted")
        anno = REFERENCE_ANNO
    root = os.path.dirname(anno)
    helper = repcount.RepcountHelper(root, anno)
    jhelper = jrepcount.RepcountHelper(root, anno)
    queries = [(["val"], ["all"]), (["train", "val", "test"], ["all"]),
               (["val"], None), (["VAL", "test"], ["Squat", "push_up"]),
               (["test"], ["situp"])]
    for split, action in queries:
        got = helper.get_rep_data(split, action)
        want = jhelper.get_rep_data(split, action)
        assert list(got) == list(want), (split, action)
        assert _fields(got) == _fields(want), (split, action)
    items = jhelper.get_rep_data(["val"], ["all"])
    preds = {name: (k % 3) + it.count - 1 for k, (name, it)
             in enumerate(items.items()) if k % 4 != 1}
    mae, obo, res = helper.eval_count(preds, ["val"], ["all"])
    jmae, jobo, jres = jhelper.eval_count(preds, ["val"], ["all"])
    assert (mae, obo) == (jmae, jobo)
    assert _fields(res) == _fields(jres)


def test_counting_functions_match_jax(bright_sweeps, tmp_path):
    rng = np.random.default_rng(0)
    preds, gts = rng.integers(0, 9, 40), rng.integers(0, 9, 40)
    for ratio in (True, False):
        assert counting.obo_mae(preds, gts, ratio) == \
            jcounting.obo_mae(preds, gts, ratio)
    with pytest.raises(ValueError):
        counting.obo_mae([], [])
    scores = {str(s): {str(c): float(v) for c, v in enumerate(row)}
              for s, row in zip(range(0, 160, 8), rng.normal(0, 2, (20, 4)))}
    assert counting.to_softmax(scores["8"]) == jcounting.to_softmax(scores["8"])
    for softmax, threshold in ((False, 0.5), (True, 0.5), (True, 0.4)):
        assert counting.scores_to_preds(scores, threshold, softmax) == \
            jcounting.scores_to_preds(scores, threshold, softmax)
    d = bright_sweeps["port"]["dir"]
    anno = os.path.join(bright_sweeps["root"], "annotation.csv")
    csvs = [str(tmp_path / "port.csv"), str(tmp_path / "jax.csv")]
    got = counting.eval_score_dir(d, anno, csvs[0], softmax=True)
    want = jcounting.eval_score_dir(d, anno, csvs[1], softmax=True)
    assert got[:2] == want[:2]  # (mae, obo)
    assert [{k: _plain(v) for k, v in r.items()} for r in got[2]] == \
        [{k: _plain(v) for k, v in r.items()} for r in want[2]]
    assert any(r["pred_count"] > 0 for r in got[2])
    meta = counting.analyze_count(csvs[0])
    assert meta.equals(jcounting.analyze_count(csvs[1]))
    assert list(meta.action)[-1] == "all"


# ------------------------------------------------------ the sweeps
def _exact_brightness(path, starts):
    """The stand-in's logits in float64: the normalize and the mean over
    each window, exact to float64 rounding."""
    from workoutdetector_tpu_torch.ops.preprocess import (IMAGENET_MEAN,
                                                          IMAGENET_STD)
    with video.VideoReader(path) as r:
        frames = r.read_prepped(256, SIZE)
    out = []
    for s in starts:
        w = np.zeros((8, SIZE, SIZE, 3))
        idx = np.arange(s, s + 16, 2)
        w[:(idx < len(frames)).sum()] = frames[idx[idx < len(frames)]]
        x = (w / 255.0 - np.array(IMAGENET_MEAN)) / np.array(IMAGENET_STD)
        out.append([-10.0 * x.mean(), 10.0 * x.mean()])
    return np.array(out)


def test_brightness_sweep_score_jsons_match_jax(bright_sweeps):
    """Same schema, keys and fields; the logits within 1e-5 of the
    stand-in's exact (float64) value. The JAX stand-in sums its 24,576
    fp32 terms with an error of up to ~2e-4 at |logit| 16, so the port is
    held to the JAX JSON within that error + 1e-5."""
    jdir, tdir = bright_sweeps["jax"]["dir"], bright_sweeps["port"]["dir"]
    names = sorted(f for f in os.listdir(tdir) if f.endswith(".json"))
    assert names == sorted(f for f in os.listdir(jdir) if f.endswith(".json"))
    assert names == [f"val{i}.mp4.score.json" for i in (1, 2, 4, 5)]
    for name in names:
        got, want = _load(os.path.join(tdir, name)), _load(os.path.join(jdir, name))
        assert list(got) == list(want)
        assert {k: v for k, v in got.items() if k != "scores"} == \
            {k: v for k, v in want.items() if k != "scores"}
        assert list(got["scores"]) == list(want["scores"])
        for start, row in want["scores"].items():
            assert list(got["scores"][start]) == list(row)
        g = np.array([list(r.values()) for r in got["scores"].values()])
        w = np.array([list(r.values()) for r in want["scores"].values()])
        exact = _exact_brightness(
            os.path.join(bright_sweeps["root"], "videos", "val", name[:-11]),
            [int(k) for k in got["scores"]])
        np.testing.assert_allclose(g, exact, rtol=0, atol=1e-5)
        assert (np.abs(g - w) <= np.abs(w - exact) + 1e-5).all()
    res = compare_dirs(tdir, jdir)
    assert res["mean_argmax_agreement"] == 1.0 and res["count_agreement"] == 1.0


def test_brightness_counts_metrics_and_manifests_match_jax(bright_sweeps):
    port, jax_ = bright_sweeps["port"], bright_sweeps["jax"]
    assert port["summary"] == jax_["summary"]
    assert sorted(port["summary"]["failed"]) == ["val3.mp4"]
    assert port["summary"]["failed"]["val3.mp4"]["stage"] == "decode"
    for sub in ("scores", "counts"):
        paths = [os.path.join(os.path.dirname(x["counts"]) if sub == "counts"
                              else x["dir"], "failures", "shard_0of1.json")
                 for x in (port, jax_)]
        assert _load(paths[0]) == _load(paths[1])
    counts = _load(port["counts"])
    assert counts == _load(jax_["counts"])
    assert sorted(counts) == ["val1.mp4", "val2.mp4", "val4.mp4", "val5.mp4"]
    assert any(c > 0 for c in counts.values())
    assert port["metrics"] == jax_["metrics"]


@pytest.fixture(scope="module")
def r50(corpus):
    """(JAX engine, port engine) of TSM-R50 at 32 px, fp32, on the same
    numpy-seeded flax weights (the JAX one on its host gather: one XLA
    program for every batch)."""
    jmodel = JaxTSM(num_class=12, num_segments=8, base_model="resnet50",
                    dropout=0.0, dtype=jnp.float32)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, 8, SIZE, SIZE, 3), jnp.float32), seed=3)
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                     num_segments=8, window_batch=4, image_size=SIZE,
                     gather="host")
    tmodel = TSM(12, 8, "resnet50", dtype=torch.float32)
    load_flax_variables(tmodel, variables)
    teng = InferenceEngine(tmodel, num_segments=8, window_batch=4,
                           image_size=SIZE, device="cpu")
    return jeng, teng


def test_tsm_r50_sweep_matches_jax(corpus, r50, tmp_path):
    """TSM-R50 (the port's fused blocks and shift-matmul sites on their
    plain versions) through both stacks' inference_dataset, and the port's
    chunked sweep against its whole-video sweep."""
    jeng, teng = r50
    dirs = {k: str(tmp_path / k) for k in ("jax", "port", "chunked")}
    jic.inference_dataset(jeng, ["val"], dirs["jax"], "ckpt", data_root=corpus)
    ic.inference_dataset(teng, ["val"], dirs["port"], "ckpt", data_root=corpus)
    ic.inference_dataset(teng, ["val"], dirs["chunked"], "ckpt",
                         data_root=corpus, chunk_frames=32)
    names = sorted(os.listdir(dirs["port"]))
    assert names == sorted(os.listdir(dirs["jax"])) and len(names) == 5
    for name in names:
        got = _load(os.path.join(dirs["port"], name))
        want = _load(os.path.join(dirs["jax"], name))
        assert list(got["scores"]) == list(want["scores"])
        g = np.array([list(r.values()) for r in got["scores"].values()])
        w = np.array([list(r.values()) for r in want["scores"].values()])
        assert np.abs(w).max() > 0.1
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        with open(os.path.join(dirs["chunked"], name)) as fc, \
                open(os.path.join(dirs["port"], name)) as fw:
            assert fc.read() == fw.read(), name
    res = compare_dirs(dirs["port"], dirs["jax"])
    assert res["videos"] == 5 and res["mean_argmax_agreement"] == 1.0
    assert res["count_agreement"] == 1.0
    assert res == jcompare_dirs(dirs["port"], dirs["jax"])


# ------------------------------------------------------ sweep options
def test_count_by_video_model_from_path_matches_jax(corpus, bright):
    jeng, teng = bright
    for name in ("val2.mp4", "val5.mp4", "val1.mp4"):
        path = os.path.join(corpus, "videos", "val", name)
        got = ic.count_by_video_model(teng, path)
        assert got == jic.count_by_video_model(jeng, path)
        with video.VideoReader(path) as r:
            frames = r.read_prepped(256, SIZE)
        assert ic.count_by_video_model(teng, frames) == got
    assert ic.count_by_video_model(
        teng, os.path.join(corpus, "videos", "val", "val2.mp4"))[0] > 0


def test_score_video_chunked_matches_whole(corpus, bright, monkeypatch):
    _, teng = bright
    path = os.path.join(corpus, "videos", "val", "val3.mp4")
    with video.VideoReader(path) as r:
        whole = r.read_prepped(256, SIZE)
    ref_starts, ref_logits = teng.score_video(whole, step=8, stride=2)
    for chunk in (16, 33, len(whole) - 1, len(whole), 4096):
        n, starts, logits = engine_mod.score_video_chunked(
            teng, path, chunk_frames=chunk)
        assert n == len(whole)
        np.testing.assert_array_equal(starts, ref_starts)
        np.testing.assert_array_equal(logits, ref_logits)
    # the read_prepped cap: cut exactly where the whole-video decode cuts
    s_w, l_w = teng.score_video(whole[:64], step=8, stride=2)
    n, s_c, l_c = engine_mod.score_video_chunked(teng, path, chunk_frames=24,
                                                 max_frames=64)
    assert n == 64
    np.testing.assert_array_equal(s_c, s_w)
    np.testing.assert_array_equal(l_c, l_w)
    with pytest.raises(ValueError, match="span"):
        engine_mod.score_video_chunked(teng, path, chunk_frames=8)

    class _Empty:
        def __init__(self, path):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

        def iter_prepped(self, *a, **k):
            return iter(())

    monkeypatch.setattr(engine_mod, "VideoReader", _Empty)
    n, starts, logits = engine_mod.score_video_chunked(teng, "none.mp4")
    assert n == 0 and len(starts) == 0 and logits.shape == (0, 2)
    assert teng.score_video(whole[:0])[1].shape == (0, 2)


def test_sweep_shards_skip_existing_and_errors(corpus, bright, tmp_path):
    """As tests/test_infer.py: shards write a disjoint union of the full
    sweep's JSONs; skip_existing skips what parses; bad options raise."""
    _, teng = bright
    items = list(repcount.RepcountHelper(corpus, os.path.join(
        corpus, "annotation.csv")).get_rep_data(["val", "test"], None).values())
    items = [items[k] for k in np.random.default_rng(0).permutation(len(items))]
    for shard in ((0, 1), (0, 2), (1, 2), (2, 3)):
        assert [it.video_name for it in ic._shard_items(items, shard)] == \
            [it.video_name for it in jic._shard_items(items, shard)]
    full, sharded = str(tmp_path / "full"), str(tmp_path / "sharded")
    ic.inference_dataset(teng, ["val"], full, "t", data_root=corpus,
                         decode_workers=1)
    seen = []
    for i in range(2):
        s = ic.inference_dataset(teng, ["val"], sharded, "t", data_root=corpus,
                                 shard=(i, 2))
        assert s["scored"] and not set(s["scored"]) & set(seen)
        seen += s["scored"]
    assert sorted(os.listdir(sharded)) == sorted(os.listdir(full))
    for name in os.listdir(full):
        assert _load(os.path.join(full, name)) == \
            _load(os.path.join(sharded, name))
    os.remove(os.path.join(sharded, "val4.mp4.score.json"))
    with open(os.path.join(sharded, "val2.mp4.score.json"), "w") as f:
        f.write('{"truncated": ')
    s = ic.inference_dataset(teng, ["val"], sharded, "t", data_root=corpus,
                             skip_existing=True)
    assert sorted(s["scored"]) == ["val2.mp4", "val4.mp4"]
    assert sorted(s["skipped"]) == ["val1.mp4", "val3.mp4", "val5.mp4"]
    with pytest.raises(ValueError, match="on_error"):
        ic.inference_dataset(teng, ["val"], full, "t", data_root=corpus,
                             on_error="ignore")
    with pytest.raises(ValueError, match="shard"):
        ic.inference_dataset(teng, ["val"], full, "t", data_root=corpus,
                             shard=(1, 1))
    bad = _with_bad_video(corpus, tmp_path / "bad")
    with pytest.raises(IOError):
        ic.inference_dataset(teng, ["val"], str(tmp_path / "raise"), "t",
                             data_root=bad)


def test_sharded_eval_matches_full_and_jax_merge(corpus, bright, tmp_path):
    jeng, teng = bright
    kw = dict(action=["all"], split="val", data_root=corpus)
    mae_full, obo_full = ic.eval_dataset(teng, **kw, output_dir=str(tmp_path),
                                         save_video=True)
    assert any(f.endswith(".csv") for f in os.listdir(tmp_path))
    # the annotated videos: the JAX package's frames, state and count drawn
    jic.eval_dataset(jeng, **kw, output_dir=str(tmp_path / "jax"),
                     save_video=True)
    for name in ("val2.mp4", "val5.mp4"):
        with video.VideoReader(str(tmp_path / name)) as r, \
                jvideo.VideoReader(str(tmp_path / "jax" / name)) as jr:
            frames = r.read_raw()
            np.testing.assert_array_equal(frames, jr.read_raw())
        assert len(frames) >= 64
    partials, files = [], []
    for i in range(2):
        f = str(tmp_path / f"counts_{i}.json")
        partials.append(ic.eval_dataset(teng, shard=(i, 2), counts_out=f, **kw))
        files.append(f)
    assert sum(p[0] for p in partials) == pytest.approx(mae_full)
    assert sum(p[1] for p in partials) == pytest.approx(obo_full)
    got = ic.eval_count_shards(files, corpus, action=["all"], split=["val"])
    want = jic.eval_count_shards(files, corpus, action=["all"], split=["val"])
    assert (got[0], got[1]) == (want[0], want[1]) == \
        pytest.approx((mae_full, obo_full))
    assert _fields(got[2]) == _fields(want[2]) and len(got[2]) == 5
    with pytest.raises(ValueError, match="overlap"):
        ic.eval_count_shards([files[0], files[0]], corpus, action=["all"],
                             split=["val"])
    # resume: a shard rerun with its counts file recounts nothing
    assert ic.eval_dataset(teng, shard=(0, 2), counts_out=files[0],
                           resume=True, **kw) == partials[0]
    with pytest.raises(NotImplementedError, match="item 6"):
        ic.eval_dataset(teng, model_type="motion", **kw)


# ------------------------------------------------------------- the CLI
def test_cli_matches_jax_cli(corpus, bright, tmp_path, monkeypatch, capsys):
    jeng, teng = bright
    monkeypatch.setattr(jengine_mod, "engine_from_checkpoint",
                        lambda cfg, ckpt, **kw: jeng)
    monkeypatch.setattr(engine_mod, "engine_from_checkpoint",
                        lambda cfg, ckpt, **kw: teng)
    base = ["--data-root", corpus, "--split", "val"]
    printed = {}
    for tag, main in (("jax", jic.main), ("port", ic.main)):
        out = []
        os.makedirs(tmp_path / tag)
        files = [str(tmp_path / tag / f"counts_{i}.json") for i in range(2)]
        for i in range(2):
            main(["--eval", "--shard", f"{i}/2", "--counts-out", files[i]]
                 + base)
            out.append(capsys.readouterr().out.strip())
        main(["--merge-shards"] + files + base)
        out.append(capsys.readouterr().out.strip())
        main(["--score", str(tmp_path / tag / "scores")] + base)
        out.append(capsys.readouterr().out.strip())
        printed[tag] = out
    assert printed["port"] == printed["jax"]
    assert json.loads(printed["port"][2])["n_pred"] == 5
    assert json.loads(printed["port"][3])["scored"] == 5
    with pytest.raises(NotImplementedError, match="item 6"):
        ic.main(["--eval", "--model-type", "motion"] + base)


def test_cli_score_exit_status(corpus, bright, tmp_path, monkeypatch, capsys):
    """The port's --score exits 1 when its shard scored nothing and its
    failure manifest is not empty, and 0 when one video of two scored."""
    _, teng = bright
    monkeypatch.setattr(engine_mod, "engine_from_checkpoint",
                        lambda cfg, ckpt, **kw: teng)
    bad = _with_bad_video(corpus, tmp_path / "bad", name="val2.mp4")
    anno = os.path.join(bad, "annotation.csv")
    with open(anno, newline="") as f:
        rows = list(csv.reader(f))
    for keep, tag in (({"val2.mp4"}, "none"), ({"val2.mp4", "val5.mp4"}, "one")):
        sub = str(tmp_path / f"anno_{tag}.csv")
        with open(sub, "w", newline="") as f:
            csv.writer(f).writerows([rows[0]] + [r for r in rows[1:]
                                                 if r[3] in keep])
        argv = ["--score", str(tmp_path / tag), "--data-root", bad, "--anno",
                sub, "--split", "val"]
        if tag == "none":
            with pytest.raises(SystemExit) as exc:
                ic.main(argv)
            assert exc.value.code == 1
        else:
            ic.main(argv)
        out = json.loads(capsys.readouterr().out.strip())
        assert out["failed"] == ["val2.mp4"]
        assert out["scored"] == (0 if tag == "none" else 1)


def test_cli_engine_from_a_port_checkpoint(corpus, tmp_path, capsys):
    """--cpu --score through load_config and engine_from_checkpoint on a
    port checkpoint (TSM-R18 at 32 px) equals the engine built in-process
    on the same weights; .jaxm and image-rank engines are refused."""
    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.models import build_model
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    opts = ["model.base_model=resnet18", "model.dtype=float32",
            "data.image_size=32"]
    cfg = load_config(TSM_YAML, opts)
    model = build_model(cfg.model)
    load_flax_variables(model, random_flax_variables(model, seed=1))
    ckpt = CheckpointManager(str(tmp_path / "ckpt")).save(
        {"model": model.state_dict()}, name="best")
    ic.main(["--score", str(tmp_path / "cli"), "--cpu", "--cfg", TSM_YAML,
             "-ckpt", ckpt, "--data-root", corpus] + opts)
    assert json.loads(capsys.readouterr().out)["scored"] == 1
    eng = InferenceEngine(model, 8, 16, image_size=32, device="cpu")
    ic.inference_dataset(eng, ["test"], str(tmp_path / "direct"), ckpt,
                         data_root=corpus)
    name = "test6.mp4.score.json"
    assert _load(tmp_path / "cli" / name) == _load(tmp_path / "direct" / name)
    with pytest.raises(ValueError, match="StableHLO"):
        engine_mod.engine_from_checkpoint(cfg, "model.jaxm", device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        engine_mod.engine_from_checkpoint(cfg, None, input_rank=4,
                                          device="cpu")
