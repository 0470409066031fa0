"""PyTorch port, the person detector: the ResNet's ``spatial=True`` map,
``TinyFCN``, ``CenterNetDetector`` (tiny and ResNet-18), its targets,
loss and decode, one ``train_detector`` step, ``LearnedDetectorBackend``,
the flax msgpack reader and both weight files, against the JAX package on
the CPU in fp32.

Inputs come from numpy seeds; the port and the JAX model take the same
numpy-seeded flax variables. Bounds: maps 1e-4 (fp32 through either
stack); the targets and the decode (numpy on both sides) identical; the
loss on identical maps 1e-6; a train step's loss, parameters after Adam
and batch statistics 1e-5; boxes from the two stacks equal in number and
within 1e-4 px, and identical where both read the same weights file.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from workoutdetector_tpu.data import synthetic as jsyn
from workoutdetector_tpu.models import detector as jdet
from workoutdetector_tpu.models import resnet as jresnet
from workoutdetector_tpu_torch.data import synthetic as tsyn
from workoutdetector_tpu_torch.data.person import Detector
from workoutdetector_tpu_torch.models import detector as tdet
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      init_flax_variables,
                                                      load_flax_variables,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.models.resnet import make_resnet
from workoutdetector_tpu_torch.utils.flax_file import (read_flax_msgpack,
                                                       unpack_flax_msgpack)

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


def _jax_apply(model, variables, x, **kw):
    out = jax.jit(lambda v, xx: model.apply(v, xx, **kw))(
        _jax_tree(variables), jnp.asarray(x))
    return jax.tree_util.tree_map(np.asarray, out)


def _images(n, size, seed=1):
    return np.random.default_rng(seed).normal(
        size=(n, size, size, 3)).astype(np.float32)


def _assert_boxes_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


# ------------------------------------------------------------------ models
@pytest.mark.parametrize("arch,size", [("resnet18", 64), ("resnet50", 32)])
def test_resnet_spatial_map_matches_jax(arch, size):
    port = make_resnet(arch, 0).eval()
    variables = random_flax_variables(port, seed=0)
    load_flax_variables(port, variables)
    x = _images(2, size)
    want = _jax_apply(jresnet._make(arch, num_classes=0), variables, x,
                      train=False, spatial=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), spatial=True).numpy()
        pooled = port(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, size // 32, size // 32,
                                       port.num_features)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    np.testing.assert_allclose(pooled, got.mean(axis=(1, 2)), atol=1e-5)


@pytest.mark.parametrize("backbone,size", [("tiny", 64), ("tiny", 72),
                                           ("resnet18", 64)])
def test_centernet_matches_jax(backbone, size):
    port = tdet.CenterNetDetector(backbone)
    variables = random_flax_variables(port, seed=0)
    load_flax_variables(port, variables)
    x = _images(2, size)
    want = _jax_apply(jdet.CenterNetDetector(backbone=backbone), variables,
                      x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    h = -(-size // port.stride) if backbone == "tiny" else size // 32
    for key in ("heatmap", "wh", "offset"):
        assert got[key].dtype == torch.float32
        assert got[key].shape[1:3] == (h, h)
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0,
                                   atol=TOL, err_msg=key)
    if backbone == "tiny":  # TinyFCN alone, on the backbone's variables
        feat = _jax_apply(jdet.TinyFCN(), {k: v["backbone"] for k, v in
                                           variables.items()}, x, train=False)
        with torch.no_grad():
            got = port.backbone(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, feat, rtol=0, atol=TOL)


def test_initializers_and_dtype_rule():
    """``init_flax_variables`` gives the JAX init's tree with ``hm``'s bias
    at −2.19 and every other bias zero; the BNs' momenta are flax's
    (0.99 in the detector's own BNs, 0.9 in the ResNet); a bf16 ResNet
    backbone fuses stages 0 and 1 and runs the kernels, an fp32 one runs
    torch ops only."""
    port = tdet.CenterNetDetector("resnet18")
    tree = init_flax_variables(port, seed=0)
    want = jax.eval_shape(lambda: jdet.CenterNetDetector(
        backbone="resnet18").init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, SIZE, SIZE, 3))))
    assert jax.tree_util.tree_map(lambda a: a.shape, dict(want)) == \
        jax.tree_util.tree_map(np.shape, tree)
    params = tree["params"]
    assert (params["hm"]["bias"] == np.float32(-2.19)).all()
    assert not params["head_conv"]["bias"].any()
    assert not params["wh"]["bias"].any()
    tiny = tdet.CenterNetDetector()
    assert {m.momentum for n, m in tiny.named_modules()
            if isinstance(m, tdet.BatchNorm)} == {0.99}
    assert {m.momentum for n, m in port.named_modules()
            if isinstance(m, tdet.BatchNorm)} == {0.9}
    r50 = {dt: tdet.CenterNetDetector("resnet50", dtype=dt)
           for dt in (torch.bfloat16, torch.float32)}
    fused = {dt: [n for n, m in r.backbone.named_children()
                  if getattr(m, "fuse", False)] for dt, r in r50.items()}
    assert fused[torch.bfloat16] == ["layer1_0", "layer1_1", "layer1_2",
                                     "layer2_1", "layer2_2", "layer2_3"]
    assert fused[torch.float32] == []
    assert r50[torch.bfloat16].backbone.use_kernels
    assert not r50[torch.float32].backbone.use_kernels


# ------------------------------------------------------- targets and loss
def test_targets_loss_and_decode_match_jax():
    rng = np.random.default_rng(0)
    boxes = [np.asarray([[8, 8, 40, 56]], np.float32),
             np.zeros((0, 4), np.float32),
             np.asarray([[3.5, 10, 20, 30], [30, 2, 60, 50]], np.float32),
             np.asarray([[10, 10, 10, 30]], np.float32)]  # empty width
    for b in boxes:
        for stride in (8, 32):
            got = tdet.gaussian_targets(b, (SIZE, 72), stride)
            want = jdet.gaussian_targets(b, (SIZE, 72), stride)
            for k in want:
                assert np.array_equal(got[k], want[k]), k
    tg = [tdet.gaussian_targets(b, (SIZE, SIZE), 8) for b in boxes]
    tgt = {k: np.stack([t[k] for t in tg]) for k in tg[0]}
    out = {"heatmap": rng.normal(0, 2, (4, 8, 8, 1)).astype(np.float32),
           "wh": rng.normal(2, 1, (4, 8, 8, 2)).astype(np.float32),
           "offset": rng.uniform(0, 1, (4, 8, 8, 2)).astype(np.float32)}
    got = tdet.detection_loss({k: torch.from_numpy(v) for k, v in out.items()},
                              {k: torch.from_numpy(v) for k, v in tgt.items()})
    want = jdet.detection_loss(out, tgt)
    assert abs(float(got) - float(want)) <= 1e-6
    for k, thr in ((4, 0.3), (2, 0.5), (9, 0.05)):
        got = tdet.decode_boxes(out, 8, k=k, threshold=thr)
        want = jdet.decode_boxes(out, 8, k=k, threshold=thr)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))


# -------------------------------------------------------- train and files
@pytest.fixture(scope="module")
def one_step():
    """One train step of each side from the same carried weights: each
    package's ``train_detector`` with its initializer returning them. The
    only JAX train step of this file."""
    imgs, boxes = jsyn.person_dataset(12, size=SIZE, seed=0)
    port_init = tdet.CenterNetDetector()
    variables = random_flax_variables(port_init, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jdet.CenterNetDetector, "init",
                   lambda self, *a, **k: _jax_tree(variables))
        jax_backend = jdet.train_detector(imgs, boxes, steps=1, batch=4,
                                          lr=1e-3, seed=5)
        mp.setattr(tdet, "init_flax_variables",
                   lambda model, seed=0: variables)
        port_backend = tdet.train_detector(imgs, boxes, steps=1, batch=4,
                                           lr=1e-3, seed=5, device="cpu")
    return imgs, boxes, variables, jax_backend, port_backend


@pytest.fixture(scope="module")
def carried(one_step):
    """The JAX backend of the step and the port's on its weights."""
    model = tdet.CenterNetDetector()
    load_flax_variables(model, jax.tree_util.tree_map(np.asarray,
                                                      one_step[3].variables))
    return one_step[3], tdet.LearnedDetectorBackend(model, input_size=SIZE,
                                                    device="cpu")


def test_train_step_matches_jax(one_step):
    imgs, boxes, variables, jax_backend, port_backend = one_step
    want = flax_to_port_state(jax.tree_util.tree_map(np.asarray,
                                                     jax_backend.variables))
    got = port_backend.model.state_dict()
    start = flax_to_port_state(variables)
    assert set(got) == set(want)
    for k, v in got.items():
        assert not np.array_equal(v.numpy(), start[k]), f"{k} did not move"
        np.testing.assert_allclose(v.numpy(), want[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    # the loss of the carried weights on the first batch, both stacks
    idx = np.random.default_rng(5).integers(0, len(imgs), (4,))
    tg = [jdet.gaussian_targets(b, (SIZE, SIZE), 8) for b in boxes]
    tgt = {k: np.stack([t[k] for t in tg])[idx] for k in tg[0]}
    from workoutdetector_tpu.ops.preprocess import normalize_clip as jnorm
    jout, _ = jax.jit(lambda v, x: jdet.CenterNetDetector().apply(
        v, jnorm(x), train=True, mutable=["batch_stats"]))(
            _jax_tree(variables), jnp.asarray(imgs[idx]))
    model = load_flax_variables(tdet.CenterNetDetector(), variables).train()
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    tout = model(normalize_clip(torch.from_numpy(imgs[idx])))
    got = tdet.detection_loss(
        tout, {k: torch.from_numpy(v) for k, v in tgt.items()}).item()
    assert abs(got - float(jdet.detection_loss(jout, tgt))) <= 1e-5


@pytest.mark.parametrize("frames,size", [(20, (48, 80)), (33, (64, 64))])
def test_backend_matches_jax_on_uneven_clips(carried, frames, size):
    """Clips whose length is no multiple of the batch of 16 and whose
    frames are not the input size: the same boxes, scaled to the clip."""
    jax_backend, port_backend = carried
    rng = np.random.default_rng(frames)
    clip = rng.integers(0, 256, (frames,) + size + (3,), np.uint8)
    clip[:, 10:30, 20:34] = 230
    for thr in (None, 0.05):
        got = port_backend(clip, threshold=thr)
        want = jax_backend(clip, threshold=thr)
        assert len(got) == frames and any(len(b) for b in got)
        _assert_boxes_close(got, want)


def test_weight_files_both_ways(carried, tmp_path):
    """The port loads the file the JAX ``save`` wrote (flax msgpack) and
    gives JAX's boxes; its own file round-trips exactly; ``Detector``
    reads either; a file of the other model is refused."""
    jax_backend = carried[0]
    clip = tsyn.person_scene(np.random.default_rng(4), size=SIZE, t=5)[0]
    jfile = str(tmp_path / "det.msgpack")
    jax_backend.save(jfile)
    from_jax = tdet.LearnedDetectorBackend.load(jfile, input_size=SIZE,
                                                device="cpu")
    _assert_boxes_close(from_jax(clip, threshold=0.05),
                        jax_backend(clip, threshold=0.05))
    own = str(tmp_path / "det.pt")
    from_jax.save(own)
    again = tdet.LearnedDetectorBackend.load(own, device="cpu")
    assert again.input_size == SIZE and again.model.dtype == torch.float32
    for a, b in zip(again(clip, threshold=0.05),
                    from_jax(clip, threshold=0.05)):
        assert np.array_equal(a, b)
    # through Detector: the JAX file at the JAX load's input size (128, as
    # the JAX Detector reads it), the port's file at its own (64)
    from workoutdetector_tpu.data.person import Detector as JaxDetector
    _assert_boxes_close(
        Detector(backend="learned", checkpoint=jfile,
                 device="cpu").detect(clip, threshold=0.05),
        JaxDetector(backend="learned", checkpoint=jfile).detect(
            clip, threshold=0.05))
    _assert_boxes_close(
        Detector(backend="learned", checkpoint=own,
                 device="cpu").detect(clip, threshold=0.05),
        jax_backend(clip, threshold=0.05))
    from workoutdetector_tpu_torch.models.pose import PoseEstimator
    with pytest.raises(ValueError, match="CenterNetDetector"):
        PoseEstimator.load(own, device="cpu")


def test_flax_msgpack_reader_matches_flax(tmp_path):
    tree = {"params": {"a": {"kernel": np.arange(24, dtype=np.float32)
                             .reshape(2, 3, 4), "bias": jnp.ones((3,))},
                       "b": np.arange(70000, dtype=np.int64),
                       "c": jnp.full((2, 2), 1.5, jnp.bfloat16)},
            "batch_stats": {"s": np.float32(2.5), "i": 7, "n": -3,
                            "big": 2 ** 40, "neg": -2 ** 40, "f": 0.25,
                            "t": True, "z": None, "name": "x" * 40,
                            "many": {str(i): np.ones(i, np.uint8)
                                     for i in range(20)}}}
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.to_bytes(tree))
    got = read_flax_msgpack(str(path))
    want = serialization.msgpack_restore(path.read_bytes())

    def same(a, b, where):
        if isinstance(b, dict):
            assert set(a) == set(b), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
            return
        b = np.asarray(b, np.float32) if getattr(b, "dtype", None) == \
            jnp.bfloat16 else np.asarray(b)
        assert np.asarray(a).dtype == b.dtype, where
        assert np.array_equal(np.asarray(a), b), where

    same(got, want, "")
    with pytest.raises(ValueError, match="ext type 2"):
        unpack_flax_msgpack(serialization.to_bytes({"c": 1 + 2j}))
    chunked = serialization.msgpack_serialize(
        {"w": {"__msgpack_chunked_array__": True, "shape": [2]}})
    with pytest.raises(ValueError, match="chunked"):
        unpack_flax_msgpack(chunked)
    payload = msgpack.packb(((2,), "float99", bytes(16)))
    with pytest.raises(ValueError, match="float99"):
        unpack_flax_msgpack(msgpack.packb({"w": msgpack.ExtType(1, payload)}))


# --------------------------------------------------------------- learning
def test_port_detector_learns_synthetic_person():
    """The JAX test's bar, on the port alone: 150 steps at 64² from the
    port's seed-0 initializers, mean IoU > 0.5 on held-out scenes."""
    imgs, boxes = tsyn.person_dataset(48, size=SIZE, seed=0)
    backend = tdet.train_detector(imgs, boxes, steps=150, lr=2e-3, batch=8,
                                  device="cpu")
    rng = np.random.default_rng(123)
    ious = []
    for _ in range(12):
        clip, gt = tsyn.person_scene(rng, size=SIZE, t=1, drift=0.0)
        det = backend(clip)
        ious.append(tsyn.iou(det[0][0], gt[0]) if len(det[0]) else 0.0)
    assert float(np.mean(ious)) > 0.5, ious


def test_distill_from_videos_runs_on_a_written_video(tmp_path):
    import cv2
    path = str(tmp_path / "move.mp4")
    wtr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                          (96, 64))
    for i in range(24):
        f = np.full((64, 96, 3), 40, np.uint8)
        cy = 32 + int(10 * np.sin(i / 3))
        f[cy - 10:cy + 10, 40:56] = 210
        wtr.write(f)
    wtr.release()
    backend = tdet.distill_from_videos([path], steps=3, size=64,
                                       decode_scale=64, batch=4,
                                       device="cpu")
    assert backend.input_size == 64 and backend.device.type == "cpu"
    assert len(backend(np.zeros((3, 64, 96, 3), np.uint8))) == 3


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    imgs, boxes = tsyn.person_dataset(2, size=32, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.train_detector(imgs, boxes, steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.LearnedDetectorBackend(tdet.CenterNetDetector())
    with pytest.raises(RuntimeError, match="CUDA"):
        tdet.distill_from_videos([])
