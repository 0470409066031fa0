"""PyTorch port, pose: ``TopDownPose`` (tiny at 64 and 72 px, ResNet-18
with 3 deconvs), its flax ``ConvTranspose`` translation, the keypoint
targets and decode, one ``train_pose`` step, ``PoseEstimator`` with both
weight files, ``scripts/pose.py`` and ``utils/visualize.py``, against the
JAX package on the CPU in fp32.

Bounds: heatmaps 1e-4; targets, decode and rendered frames identical; a
train step's loss, parameters after Adam and batch statistics 1e-5;
keypoint positions identical (an argmax) and scores within 1e-4.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from workoutdetector_tpu.data import synthetic as jsyn
from workoutdetector_tpu.data.person import Detector as JaxDetector
from workoutdetector_tpu.models import pose as jpose
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.scripts import pose as jscript
from workoutdetector_tpu.utils import visualize as jvis
from workoutdetector_tpu_torch.data import synthetic as tsyn
from workoutdetector_tpu_torch.data.person import Detector
from workoutdetector_tpu_torch.models import detector as tdet
from workoutdetector_tpu_torch.models import pose as tpose
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      init_flax_variables,
                                                      load_flax_variables,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
from workoutdetector_tpu_torch.scripts import pose as tscript
from workoutdetector_tpu_torch.utils import visualize as tvis

SIZE = 64
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _assert_keypoints(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=TOL)


@pytest.mark.parametrize("backbone,size", [("tiny", 64), ("tiny", 72),
                                           ("resnet18", 64)])
def test_top_down_pose_matches_jax(backbone, size):
    port = tpose.TopDownPose(backbone)
    assert port.n_up == (1 if backbone == "tiny" else 3)
    variables = random_flax_variables(port, seed=0)
    load_flax_variables(port, variables)
    x = np.random.default_rng(1).normal(size=(2, size, size, 3)) \
        .astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: jpose.TopDownPose(
        backbone=backbone).apply(v, xx, train=False))(_jax_tree(variables),
                                                      jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    side = 2 * -(-size // 8) if backbone == "tiny" else 8 * (size // 32)
    assert got.shape == want.shape == (2, side, side, tpose.NUM_KEYPOINTS)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


@pytest.mark.parametrize("side", [4, 5, 7, 9])
def test_deconv_is_flax_conv_transpose(side):
    """flax ``ConvTranspose((4, 4), (2, 2), padding='SAME')`` on odd and
    even maps, the port's kernel taken by the generic 4-D weight map."""
    from flax import linen as nn
    rng = np.random.default_rng(side)
    x = rng.normal(size=(2, side, side, 6)).astype(np.float32)
    kernel = rng.normal(size=(4, 4, 6, 5)).astype(np.float32)
    bias = rng.normal(size=(5,)).astype(np.float32)
    want = np.asarray(nn.ConvTranspose(5, (4, 4), (2, 2), padding="SAME")
                      .apply({"params": {"kernel": kernel, "bias": bias}}, x))
    deconv = tpose.Deconv(6, 5)
    load_flax_variables(deconv, {"params": {"kernel": kernel, "bias": bias}})
    with torch.no_grad():
        got = deconv(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 2 * side, 2 * side, 5)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_initializers_targets_and_decode():
    port = tpose.TopDownPose("resnet18")
    tree = init_flax_variables(port, seed=0)
    want = jax.eval_shape(lambda: jpose.TopDownPose(backbone="resnet18").init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3))))
    assert jax.tree_util.tree_map(lambda a: a.shape, dict(want)) == \
        jax.tree_util.tree_map(np.shape, tree)
    assert not tree["params"]["hm"]["bias"].any()
    assert {m.momentum for m in (port.debn1, port.debn2, port.debn3)} == {0.99}
    rng = np.random.default_rng(2)
    kps = rng.uniform(-4, SIZE + 4, (tpose.NUM_KEYPOINTS, 2)).astype(np.float32)
    kps[3] = np.nan
    for size, stride in ((SIZE, 4), (72, 4), (SIZE, 8)):
        assert np.array_equal(tpose.keypoint_targets(kps, size, stride),
                              jpose.keypoint_targets(kps, size, stride))
    hm = rng.normal(size=(3, 16, 18, tpose.NUM_KEYPOINTS)).astype(np.float32)
    for got, want in zip(tpose.decode_keypoints(hm, 4),
                         jpose.decode_keypoints(hm, 4)):
        assert np.array_equal(got, want)


BATCH, SEED, LR = 4, 2, 2e-3


@pytest.fixture(scope="module")
def one_step():
    """One step of the JAX ``train_pose`` (the model in float64, see
    ``test_train_step_matches_jax``) and of the port's, each package's
    initializer returning the same carried weights: the only JAX train
    step of this file. Returns the images, keypoints, start weights, the JAX
    step's variables and the port's estimator."""
    imgs, kps = jsyn.pose_dataset(10, size=SIZE, seed=0)
    variables = random_flax_variables(tpose.TopDownPose(), seed=3)
    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jpose.TopDownPose, "init",
                   lambda self, *a, **k: _jax_tree(variables))
        mp.setattr(jpose, "TopDownPose", functools.partial(
            jpose.TopDownPose, dtype=jnp.float64))
        jax_est = jpose.train_pose(imgs, kps, steps=1, batch=BATCH, lr=LR,
                                   seed=SEED)
        after = jax.tree_util.tree_map(np.asarray, jax_est.variables)
        mp.setattr(tdet, "init_flax_variables",
                   lambda model, seed=0: variables)
        port_est = tpose.train_pose(imgs, kps, steps=1, batch=BATCH, lr=LR,
                                    seed=SEED, device="cpu")
    return imgs, kps, variables, after, port_est


@pytest.fixture(scope="module")
def carried(one_step):
    """The JAX and the port's estimators (fp32, input 64) on the same
    weights, those of the JAX step."""
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  one_step[3])
    model = tpose.TopDownPose()
    load_flax_variables(model, tree)
    return (jpose.PoseEstimator(jpose.TopDownPose(), _jax_tree(tree),
                                input_size=SIZE),
            tpose.PoseEstimator(model, input_size=SIZE, device="cpu"))


def test_train_step_matches_jax(one_step):
    """The port's fp32 ``train_pose`` step against the JAX step with the
    model in float64: at this size JAX's fp32 backward lies up to 2.4e-2
    from its fp64 one in the backbone's gradients (train-mode BNs over 4
    images), where the port's fp32 lies within 2e-6. Batch statistics and
    every parameter element whose float64 gradient is at least 1e-5 within
    1e-5. Adam's first step is lr·g/(|g| + 1e-8), so below that an fp32
    rounding of g moves the step by up to lr: the deconv biases (their
    gradient is zero by construction under a train-mode BN) and the few
    elements with |g| < 1e-5 are held to |step| ≤ lr instead. The loss of
    the start weights on the first batch within 1e-5."""
    imgs, kps, variables, after, port_est = one_step
    want = flax_to_port_state(after)
    start = flax_to_port_state(variables)
    got = port_est.model.state_dict()
    assert set(got) == set(want)
    # the port's float64 gradient of the first batch
    idx = np.random.default_rng(SEED).integers(0, len(imgs), (BATCH,))
    x = torch.from_numpy(imgs[idx])
    tgt = np.stack([tpose.keypoint_targets(k, SIZE) for k in kps])[idx]
    m64 = tpose.TopDownPose(dtype=torch.float64)
    load_flax_variables(m64, variables)
    m64.double().train()
    loss64 = torch.mean((m64(normalize_clip(x)) -
                         torch.from_numpy(tgt).double()) ** 2) * 100.0
    loss64.backward()
    grads = {n: p.grad.numpy() for n, p in m64.named_parameters()}
    small = 0
    for k, v in got.items():
        v = v.numpy()
        if k not in grads:  # running statistics
            np.testing.assert_allclose(v, want[k], rtol=0, atol=1e-5,
                                       err_msg=k)
            continue
        sure = np.abs(grads[k]) >= 1e-5
        assert not np.array_equal(v, start[k]), f"{k} did not move"
        np.testing.assert_allclose(v[sure], want[k][sure], rtol=0, atol=1e-5,
                                   err_msg=k)
        for a in (v, want[k]):
            assert np.abs(a - start[k]).max() <= LR * (1 + 1e-3), k
        small += int((~sure).sum())
    assert small < 200, small  # the 64 deconv biases and a handful more
    with jax.enable_x64(True):
        jmodel = jpose.TopDownPose(dtype=jnp.float64)
        out, _ = jax.jit(lambda v, xx: jmodel.apply(
            v, j_normalize(xx), train=True, mutable=["batch_stats"]))(
                _jax_tree(variables), jnp.asarray(imgs[idx]))
        jloss = float(jnp.mean((out - jnp.asarray(tgt, jnp.float64)) ** 2)
                      * 100.0)
    model = load_flax_variables(tpose.TopDownPose(), variables).train()
    with torch.no_grad():
        loss = torch.mean((model(normalize_clip(x)) -
                           torch.from_numpy(tgt)) ** 2) * 100.0
    assert abs(float(loss) - jloss) <= 1e-5
    assert abs(loss64.item() - jloss) <= 1e-6  # the mask's function


@pytest.mark.parametrize("frames,size", [(20, (48, 80)), (17, (64, 64))])
def test_estimator_matches_jax_on_uneven_clips(carried, frames, size):
    jax_est, port_est = carried
    clip = np.random.default_rng(frames).integers(
        0, 256, (frames,) + size + (3,), np.uint8)
    _assert_keypoints(port_est.estimate_clip(clip),
                      jax_est.estimate_clip(clip))


def test_weight_files_both_ways(carried, tmp_path):
    """The port loads the file the JAX ``save`` wrote and gives JAX's
    keypoints; its own file round-trips exactly."""
    jax_est = carried[0]
    clip = jsyn.pose_scene(np.random.default_rng(9), size=SIZE, t=3)[0]
    jfile = str(tmp_path / "pose.msgpack")
    jax_est.save(jfile)
    from_jax = tpose.PoseEstimator.load(jfile, input_size=SIZE, device="cpu")
    _assert_keypoints(from_jax.estimate_clip(clip), jax_est.estimate_clip(clip))
    own = str(tmp_path / "pose.pt")
    from_jax.save(own)
    again = tpose.PoseEstimator.load(own, device="cpu")
    assert again.input_size == SIZE
    assert np.array_equal(again.estimate_clip(clip), from_jax.estimate_clip(clip))


def test_port_pose_learns_synthetic_keypoints():
    """The JAX test's bar on the port alone: 200 steps at 64² from the
    port's seed-0 initializers, mean joint error < 0.1·size."""
    imgs, kps = tsyn.pose_dataset(48, size=SIZE, seed=0)
    est = tpose.train_pose(imgs, kps, steps=200, lr=2e-3, batch=8,
                           device="cpu")
    rng = np.random.default_rng(42)
    errs = []
    for _ in range(8):
        clip, gt = tsyn.pose_scene(rng, size=SIZE, t=1)
        errs.append(np.abs(est.estimate_clip(clip)[0, :, :2] - gt[0]).mean())
    assert float(np.mean(errs)) < 0.1 * SIZE, errs


# ------------------------------------------------------- scripts, drawing
@pytest.fixture(scope="module")
def pose_video(tmp_path_factory):
    import cv2
    clip, gt = jsyn.pose_scene(np.random.default_rng(5), size=80, t=12)
    clip[:, :, :8] = 0
    clip[::2, :, :8] = 255  # flicker at the left edge: a motion box
    path = str(tmp_path_factory.mktemp("pose") / "pose.mp4")
    w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 30, (80, 80))
    for f in clip:
        w.write(f[..., ::-1])
    w.release()
    return path


def test_pose_script_pickle_matches_jax(carried, pose_video, tmp_path):
    """``inference_one_video`` with the motion detector's crop and
    ``extract_dataset``: the JAX pickle's keys, types and values."""
    jax_est, port_est = carried
    got = tscript.inference_one_video(pose_video, pose_estimator=port_est,
                                      detector=Detector("motion"))
    want = jscript.inference_one_video(pose_video, pose_estimator=jax_est,
                                       detector=JaxDetector("motion"))
    assert list(got) == list(want)
    for k in want:
        if k in ("keypoint", "keypoint_score"):
            assert got[k].dtype == want[k].dtype and \
                got[k].shape == want[k].shape
        elif k != "video_path":
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k
    np.testing.assert_array_equal(got["keypoint"], want["keypoint"])
    np.testing.assert_allclose(got["keypoint_score"], want["keypoint_score"],
                               rtol=0, atol=TOL)
    pkl = str(tmp_path / "pose.pkl")
    items = tscript.extract_dataset([pose_video], pkl, pose_estimator=port_est)
    loaded = tscript.load_pose_pickle(pkl)
    assert len(loaded) == 1 and list(loaded[0]) == list(items[0])
    np.testing.assert_array_equal(loaded[0]["keypoint"], items[0]["keypoint"])
    out = str(tmp_path / "render.mp4")
    tscript.render_pose_video(loaded[0], out, video_path=pose_video, thre=0.0)
    assert os.path.getsize(out) > 0


def test_vis_2d_pose_frames_are_jax_frames():
    rng = np.random.default_rng(0)
    kp = rng.uniform(0, 60, (2, 3, 17, 2)).astype(np.float32)
    sc = rng.uniform(0, 1, (2, 3, 17)).astype(np.float32)
    frames = rng.integers(0, 256, (3, 64, 72, 3), np.uint8)
    for args in ((kp, sc, frames), (kp, sc, None),
                 (np.concatenate([kp, sc[..., None]], -1), None, None)):
        got = tvis.vis_2d_pose(*args, img_shape=(64, 72), thre=0.4)
        want = jvis.vis_2d_pose(*args, img_shape=(64, 72), thre=0.4)
        assert np.array_equal(got, want)
    assert np.array_equal(tvis.vis_2d_pose(kp[0], thre=0.0),
                          jvis.vis_2d_pose(kp[0], thre=0.0))
    assert tvis.COCO_PAIRS == jvis.COCO_PAIRS and tvis.CLASSES == jvis.CLASSES


def test_score_plots_match_jax(tmp_path):
    """``plot_score_json`` counts a score JSON as the JAX function does
    (the port's ``counting``) and writes its figure."""
    import json
    scores = {str(i * 8): {"0": float(np.cos(i / 2) > 0),
                           "1": float(np.cos(i / 2) <= 0)} for i in range(40)}
    path = tmp_path / "v.score.json"
    path.write_text(json.dumps({"video_name": "v.mp4", "action": "squat",
                                "scores": scores,
                                "ground_truth": [0, 40, 48, 90]}))
    got = tvis.plot_score_json(str(path), str(tmp_path / "a.png"))
    want = jvis.plot_score_json(str(path), str(tmp_path / "b.png"))
    assert got == want and (tmp_path / "a.png").stat().st_size > 0
    tvis.plot_pred([1, 30, 40, 70], [0, 40], 90, {"video_name": "v"},
                   out_path=str(tmp_path / "pred.png"))
    tvis.plot_all(str(tmp_path), str(tmp_path / "plots"))
    assert os.listdir(tmp_path / "plots") == ["v.score.png"]


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    imgs, kps = tsyn.pose_dataset(2, size=32, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpose.train_pose(imgs, kps, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpose.PoseEstimator(tpose.TopDownPose())
