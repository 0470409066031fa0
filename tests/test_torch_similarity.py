"""PyTorch port, the image, similarity and motion counters and
``eval_dataset``'s ``image``, ``similarity`` and ``motion`` modes, against
the JAX package on the CPU.

Inputs come from numpy seeds: periodic feature sequences, frames with a
small oscillating patch, written mp4s, and the JAX package's
``build_repcount_corpus(root, n_videos=6, size=48, seed=0)``. The feature
engines of both packages take the same numpy-seeded weights. Bounds: lag
profiles, similarity matrices and strengths 1e-5 (the port sums in
float64, the JAX package in fp32); features and logits 1e-4; periods,
counts, reps, MAE/OBO, count JSONs and CLI output identical; the image
counter's pred JSON the same keys with scores within 1e-5 + 1e-5·|score|
(the brightness stand-in's fp32 mean over a frame, summed in another
order: its logits reach ≈ 14).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_infer import BrightnessModel as JaxBrightness
from test_similarity_count import _localized_motion_frames, _periodic_features
from test_torch_sweep import Brightness
from workoutdetector_tpu.data.synthetic import build_repcount_corpus
from workoutdetector_tpu.data.video import write_video as j_write_video
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import engine as jengine_mod
from workoutdetector_tpu.infer import inference_count as jic
from workoutdetector_tpu.models import resnet as jresnet
from workoutdetector_tpu.utils import similarity as jsim
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.infer import engine as engine_mod
from workoutdetector_tpu_torch.infer import inference_count as ic
from workoutdetector_tpu_torch.models import (ImageClassifier,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models.convert import random_flax_variables
from workoutdetector_tpu_torch.utils import similarity as sim

SIZE = 32
CPU = "cpu"


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


@pytest.fixture(scope="module")
def bright_images():
    """(JAX, port) rank-4 engines over the brightness stand-in: class =
    mean brightness > 0 of the normalized frame."""
    model = JaxBrightness()
    variables = model.init(jax.random.PRNGKey(0),
                           jnp.zeros((1, SIZE, SIZE, 3)))
    jeng = JaxEngine(model, variables, window_batch=16, image_size=SIZE,
                     input_rank=4)
    teng = InferenceEngine(Brightness(), window_batch=16, image_size=SIZE,
                           device=CPU, input_rank=4)
    return jeng, teng


@pytest.fixture(scope="module")
def features():
    """(JAX, port) rank-4 engines over a headless ResNet-18 with the same
    numpy-seeded weights, as the CLI's similarity engine is built."""
    model = ImageClassifier("resnet18", 0, fused_block=False)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    jvars = jax.tree_util.tree_map(
        jnp.asarray, {c: variables[c]["backbone_img"] for c in variables})
    jeng = JaxEngine(jresnet.resnet18(num_classes=0, dtype=jnp.float32),
                     jvars, window_batch=16, image_size=SIZE, input_rank=4)
    teng = InferenceEngine(model, window_batch=16, image_size=SIZE,
                           device=CPU, input_rank=4)
    return jeng, teng


def _write(path, frames):
    j_write_video(str(path), frames, 30.0)
    return str(path)


def _dark_bright_video(path, n_reps=3, period=48, size=64, seed=0):
    """Whole-frame reps: period / 2 dark frames then period / 2 bright
    ones, with pixel noise."""
    rng = np.random.default_rng(seed)
    frames = [np.clip(np.full((size, size, 3), v, np.int16)
                      + rng.integers(-6, 7, (size, size, 3)), 0,
                      255).astype(np.uint8)
              for _ in range(n_reps) for v in (40, 220)
              for _ in range(period // 2)]
    return _write(path, np.stack(frames))


# ------------------------------------------------- the similarity module

def _aperiodic():
    rng = np.random.default_rng(0)
    return np.cumsum(rng.normal(size=(120, 16)), axis=0).astype(np.float32)


@pytest.mark.parametrize("feats", [
    _periodic_features(3, 48), _periodic_features(5, 20),
    _periodic_features(8, 12, dim=40, noise=0.3, seed=2), _aperiodic(),
    np.ones((5, 4), np.float32)], ids=["3x48", "5x20", "8x12-noisy",
                                       "aperiodic", "short"])
def test_feature_periodicity_matches_jax(feats):
    """Lag profile, the similarity matrices (cosine, pose), the period and
    its strength, and the count of per-frame features."""
    np.testing.assert_allclose(sim.lag_profile(feats, device=CPU),
                               jsim.lag_profile(feats), atol=1e-5, rtol=0)
    np.testing.assert_allclose(sim.cosine_self_similarity(feats, CPU),
                               jsim.cosine_self_similarity(feats), atol=1e-5,
                               rtol=0)
    kp = feats[:, :16].reshape(len(feats), -1, 2)
    np.testing.assert_allclose(sim.pose_self_similarity(kp, CPU),
                               jsim.pose_self_similarity(kp), atol=1e-5,
                               rtol=0)
    for kw in ({}, {"min_strength": 0.15}):
        got = sim.count_by_periodicity(feats, device=CPU, **kw)
        want = jsim.count_by_periodicity(feats, **kw)
        assert got[:2] == want[:2]
        assert got[2] == pytest.approx(want[2], abs=1e-5)
    if len(feats) >= 8:
        p, s = sim.estimate_period(feats, device=CPU)
        assert (p, pytest.approx(s, abs=1e-5)) == jsim.estimate_period(feats)


def _static_frames():
    rng = np.random.default_rng(1)
    base = rng.integers(60, 200, (64, 64, 3)).astype(np.float32)
    return np.clip(base[None] + rng.normal(0, 6, (240, 64, 64, 3)), 0,
                   255).astype(np.uint8)


@pytest.mark.parametrize("frames", [
    _localized_motion_frames(5, 60), _localized_motion_frames(3, 40),
    _static_frames()], ids=["5x60", "3x40", "static"])
def test_spatial_periodicity_matches_jax(frames):
    """Per-cell lag profiles within 1e-5, the strongest cell's period and
    the count equal (the localized clips count their reps, the static one
    0)."""
    for grid in (4, 8):
        np.testing.assert_allclose(
            sim.spatial_lag_profiles(frames, grid, device=CPU),
            jsim.spatial_lag_profiles(frames, grid), atol=1e-5, rtol=0)
    p, s = sim.estimate_period_spatial(frames, device=CPU)
    jp, js = jsim.estimate_period_spatial(frames)
    assert p == jp and s == pytest.approx(js, abs=1e-5)
    got = sim.count_by_spatial_periodicity(frames, device=CPU)
    want = jsim.count_by_spatial_periodicity(frames)
    assert got[:2] == want[:2] and got[2] == pytest.approx(want[2], abs=1e-5)


def test_similarity_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.lag_profile(_periodic_features(3, 20))
    with pytest.raises(RuntimeError, match="CUDA"):
        sim.count_by_spatial_periodicity(_localized_motion_frames(3, 20))


# ------------------------------------------------------------ the counters

def test_count_by_motion_periodicity_matches_jax(tmp_path):
    """Decode → per-cell periodicity → count, from a written mp4 with
    localized motion; no engine."""
    path = _write(tmp_path / "arm.mp4", _localized_motion_frames(4, 48))
    got = ic.count_by_motion_periodicity(path, device=CPU)
    want = jic.count_by_motion_periodicity(path)
    assert got[:2] == want[:2] and got[2] == pytest.approx(want[2], abs=1e-5)
    assert got[0] == 4


def test_count_by_similarity_matches_jax(features, tmp_path):
    """Per-frame features of a written periodic mp4 through both headless
    ResNet-18 engines (1e-4), then equal periods and counts."""
    jeng, teng = features
    path = _dark_bright_video(tmp_path / "reps.mp4")
    np.testing.assert_allclose(sim.video_cnn_features(teng, path),
                               jsim.video_cnn_features(jeng, path),
                               atol=1e-4, rtol=0)
    got = ic.count_by_similarity(teng, path)
    want = jic.count_by_similarity(jeng, path)
    assert got[:2] == want[:2] == (3, 48)
    assert got[2] == pytest.approx(want[2], abs=1e-5)


def test_count_by_image_model_matches_jax(corpus, bright_images, features,
                                          tmp_path):
    """Per-frame argmax → 7-deep majority vote → counts and reps equal on
    every corpus video, with and without a background threshold; the pred
    JSON has the JAX schema (frame keys as strings) and its scores. An
    image ResNet-18's logits on a video's frames within 1e-4."""
    jeng, teng = bright_images
    videos = sorted(os.path.join(r, f) for r, _, fs in
                    os.walk(os.path.join(corpus, "videos")) for f in fs)
    assert len(videos) == 7
    counts = []
    for k, path in enumerate(videos):
        for threshold in (0.1, 0.9999):
            got = ic.count_by_image_model(teng, path, threshold=threshold,
                                          pred_out_path=str(tmp_path / f"t{k}"))
            want = jic.count_by_image_model(
                jeng, path, threshold=threshold,
                pred_out_path=str(tmp_path / f"j{k}"))
            assert got == want
        counts.append(got[0])
        with open(tmp_path / f"t{k}.json") as f:
            tp = json.load(f)
        with open(tmp_path / f"j{k}.json") as f:
            jp = json.load(f)
        assert tp.keys() == jp.keys() and tp["step"] == jp["step"] == 1
        assert list(tp["scores"]) == list(jp["scores"])
        np.testing.assert_allclose(np.array(list(tp["scores"].values())),
                                   np.array(list(jp["scores"].values())),
                                   atol=1e-5, rtol=1e-5)
    assert max(counts) > 0
    # the features engine as a 512-class "classifier": ResNet numerics
    got = ic.count_by_image_model(features[1], videos[0], threshold=0.0)
    assert got == jic.count_by_image_model(features[0], videos[0],
                                           threshold=0.0)


@pytest.mark.parametrize("mode", ["image", "similarity", "motion"])
def test_eval_dataset_modes_match_jax(corpus, bright_images, features, mode,
                                      tmp_path):
    """``eval_dataset`` over the corpus's val split: MAE/OBO and the count
    JSON equal in each mode (the image counter's threshold 0 by default,
    motion without an engine); ``repnet`` mode refuses an engine that is
    not a RepNet's."""
    engines = {"image": bright_images, "similarity": features,
               "motion": (None, None)}[mode]
    kw = dict(action=["all"], split="val", data_root=corpus, model_type=mode)
    got = ic.eval_dataset(engines[1], counts_out=str(tmp_path / "t.json"),
                          device=CPU, **kw)
    want = jic.eval_dataset(engines[0], counts_out=str(tmp_path / "j.json"),
                            **kw)
    assert got == want
    with open(tmp_path / "t.json") as f, open(tmp_path / "j.json") as g:
        assert json.load(f) == json.load(g)
    if mode == "motion":
        with pytest.raises(ValueError, match="RepNet"):
            ic.eval_dataset(features[1], **dict(kw, model_type="repnet"))


def test_cli_image_and_similarity(corpus, bright_images, tmp_path,
                                  monkeypatch, capsys):
    """``--eval --model-type image`` prints what the JAX CLI prints on the
    same engine; ``--model-type similarity`` builds its own headless
    ResNet-18 (the port's initializers: its counts may differ from the
    JAX CLI's, ROADMAP §3) and prints the metrics."""
    jeng, teng = bright_images
    seen = {}

    def port_engine(cfg, ckpt, **kw):
        seen.update(model_type=cfg.model.model_type, **kw)
        return teng

    monkeypatch.setattr(jengine_mod, "engine_from_checkpoint",
                        lambda cfg, ckpt, **kw: jeng)
    monkeypatch.setattr(engine_mod, "engine_from_checkpoint", port_engine)
    base = ["--eval", "--data-root", corpus, "--split", "val"]
    jic.main(base + ["--model-type", "image"])
    want = capsys.readouterr().out.strip()
    ic.main(base + ["--model-type", "image", "--cpu"])
    assert capsys.readouterr().out.strip() == want
    assert seen["model_type"] == "image" and seen["device"] == CPU
    ic.main(["--eval", "--data-root", corpus, "--split", "test",
             "--model-type", "similarity", "--cpu", "data.image_size=32"])
    out = json.loads(capsys.readouterr().out)
    assert set(out) == {"mae", "obo_acc", "shard"} and out["shard"] == [0, 1]
    from workoutdetector_tpu_torch.config import load_config
    eng = ic.similarity_engine(load_config(None, [
        "model.base_model=resnet50", "data.image_size=32"]), device=CPU)
    assert (eng.input_rank, eng.num_class, eng.model.base_model) == \
        (4, 2048, "resnet50")
