"""PyTorch port, engine and counting: ``InferenceEngine.score_video`` and
``count_by_video_model`` against the JAX package's, on a synthetic
~70-frame video (TSM-R18, 32 px, window_batch 4 so the padded tail chunk
runs). fp32 on the CPU: logits within 1e-4, argmax sequences, counts and
reps identical. The JAX side decodes the video from an mp4; the port gets
the same decoded frames.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tsm import randomized_variables
from workoutdetector_tpu import counting as jcounting
from workoutdetector_tpu.data.video import VideoReader
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import count_by_video_model as j_count
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu_torch import counting
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             count_by_video_model)
from workoutdetector_tpu_torch.models import TSM, load_flax_variables

SIZE = 32
NUM_CLASS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    jmodel = JaxTSM(num_class=NUM_CLASS, num_segments=8, base_model="resnet18",
                    dropout=0.0, dtype=jnp.float32)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, 8, SIZE, SIZE, 3), jnp.float32), seed=5)
    jengine = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                        num_segments=8, window_batch=4, image_size=SIZE)
    tmodel = TSM(NUM_CLASS, 8, "resnet18", dtype=torch.float32)
    load_flax_variables(tmodel, variables)
    tengine = InferenceEngine(tmodel, num_segments=8, window_batch=4,
                              device="cpu")
    return jengine, tengine


def _write_video(path, pattern, frames_per_state=12, wh=(96, 96)):
    import cv2
    rng = np.random.default_rng(0)
    w = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30, wh)
    for val in pattern:
        for _ in range(frames_per_state):
            frame = np.full((wh[1], wh[0], 3), val, np.uint8)
            frame[20:60, 30:70] = rng.integers(0, 256, 3, dtype=np.uint8)
            w.write(frame)
    w.release()
    return str(path)


def test_score_video_and_count_match_jax(engines, tmp_path):
    jengine, tengine = engines
    path = _write_video(tmp_path / "reps.mp4", [20, 235] * 3)  # 72 frames
    with VideoReader(path) as r:
        video = r.read_prepped(256, SIZE)
    assert 64 < len(video) <= 72
    j_starts, j_logits = jengine.score_video(video, step=8, stride=2)
    t_starts, t_logits = tengine.score_video(video, step=8, stride=2)
    np.testing.assert_array_equal(t_starts, j_starts)
    assert len(t_starts) % 4 != 0  # the zero-padded tail chunk ran
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(t_logits.argmax(1), j_logits.argmax(1))
    assert j_count(jengine, path) == count_by_video_model(tengine, video)


@pytest.mark.parametrize("frames", [0, 5])
def test_short_videos_match_jax(engines, frames):
    jengine, tengine = engines
    video = np.random.default_rng(frames).integers(
        0, 256, (frames, SIZE, SIZE, 3), dtype=np.uint8)
    j_starts, j_logits = jengine.score_video(video, step=8, stride=2)
    t_starts, t_logits = tengine.score_video(video, step=8, stride=2)
    np.testing.assert_array_equal(t_starts, j_starts)
    assert t_logits.shape == j_logits.shape == (len(j_starts), NUM_CLASS)
    np.testing.assert_allclose(t_logits, j_logits, rtol=1e-4, atol=1e-4)
    assert count_by_video_model(tengine, video) == (0, [])


def test_score_windows_and_clip_match_jax(engines):
    jengine, tengine = engines
    windows = np.random.default_rng(9).integers(
        0, 256, (6, 8, SIZE, SIZE, 3), dtype=np.uint8)
    np.testing.assert_allclose(tengine.score_windows(windows),
                               jengine.score_windows(windows),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tengine.score_clip(windows[0]),
                               jengine.score_clip(windows[0]),
                               rtol=1e-4, atol=1e-4)
    starts = np.array([0, 3, 9])
    video = windows.reshape(-1, SIZE, SIZE, 3)[:20]
    np.testing.assert_array_equal(tengine.gather_windows(video, starts),
                                  jengine.gather_windows(video, starts))


def test_counting_matches_jax():
    rng = np.random.default_rng(11)
    for _ in range(50):
        preds = rng.integers(-1, 4, rng.integers(0, 40)).tolist()
        assert counting.pred_to_count(preds, 8) == \
            jcounting.pred_to_count(preds, 8)
        bits = rng.integers(0, 2, 30).tolist()
        assert counting.majority_vote_states(bits) == \
            jcounting.majority_vote_states(bits)
