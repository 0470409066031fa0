"""PyTorch port, TDN: the temporal difference network, its burst sampler
and dataset, its checkpoint port, its rank-6 engine and export, against
the JAX package on the CPU.

Inputs and variables come from numpy seeds (``randomized_variables``:
random BN statistics and affine and random shift taps). Tolerances: eval
logits 1e-4 in fp32 (the torch↔JAX bar of ``test_torch_tsm.py``); a train
step at the bars of ``test_torch_train.py`` (loss 1e-5, updated
parameters and statistics 1e-4); the sampler, the resize and the
dataset's batches exact. The 80-px case reaches the mSE branch's 2 → 5
and 1 → 3 nearest resizes (layer3 is 5×5, layer4 3×3), which the 32-px
case does not (layer4 is 1×1 there and skips the downscale).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_data import SEG as DATA_SEG
from test_torch_data import _batches, _data_cfg, corpus  # noqa: F401
from test_torch_tpn import check_train_step, jax_train_step
from test_torch_tsm import randomized_variables
from workoutdetector_tpu.config import DataConfig as JDataConfig
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.data import datasets as jdatasets
from workoutdetector_tpu.data import jpeg as jjpeg
from workoutdetector_tpu.data.loader import DataLoader as JDataLoader
from workoutdetector_tpu.data.sampling import \
    tdn_sample_indices as j_tdn_sample_indices
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.models.convert import \
    port_tdn_checkpoint as j_port_tdn_checkpoint
from workoutdetector_tpu.models.tdn import TDN as JaxTDN
from workoutdetector_tpu.models.tdn import TemporalShiftConv as JShift
from workoutdetector_tpu.scripts.torch_tdn import TorchTDN
from workoutdetector_tpu.train.optim import classify_param as j_classify
from workoutdetector_tpu_torch.config import DataConfig, load_config
from workoutdetector_tpu_torch.data import datasets, jpeg
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.data.sampling import tdn_sample_indices
from workoutdetector_tpu_torch.infer import InferenceEngine
from workoutdetector_tpu_torch.infer.engine import (engine_from_checkpoint,
                                                    score_video_chunked)
from workoutdetector_tpu_torch.models import (TDN, build_model,
                                              example_input_shape,
                                              init_flax_variables,
                                              load_flax_variables,
                                              port_tdn_checkpoint)
from workoutdetector_tpu_torch.models.tdn import nearest_resize
from workoutdetector_tpu_torch.scripts import export_model as export_cli
from workoutdetector_tpu_torch.train.optim import flax_path, label_params
from workoutdetector_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TDN_YAML = os.path.join(REPO, "workoutdetector_tpu/configs/tdn.yaml")
SEG, NUM_CLASS = 4, 3
TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


JMODEL = JaxTDN(num_class=NUM_CLASS, num_segments=SEG, dropout=0.0,
                dtype=jnp.float32)
# one jitted eval apply, so the cases at one input shape compile it once
j_eval = jax.jit(lambda v, x: JMODEL.apply(v, x, train=False))


def _jax_tdn(size, seed=1):
    variables = randomized_variables(
        JMODEL, jnp.zeros((1, SEG, 5, size, size, 3), jnp.float32), seed=seed)
    return JMODEL, variables


# ---------------------------------------------------------------- resize

@pytest.mark.parametrize("n_in,n_out", [(2, 4), (3, 7), (2, 5), (1, 3)])
def test_nearest_resize_matches_jax(n_in, n_out):
    """Half-pixel centres, as jax.image.resize's 'nearest' (F.interpolate's
    'nearest' reads 3 → 7 as [0 0 0 1 1 2 2]; this reads [0 0 1 1 1 2 2])."""
    x = np.random.default_rng(n_out).standard_normal(
        (2, n_in, n_in + 1, 3)).astype(np.float32)
    shape = (2, n_out, n_out + 2, 3)
    want = np.asarray(jax.image.resize(x, shape, method="nearest"))
    got = nearest_resize(torch.from_numpy(x), n_out, n_out + 2).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------- model

@pytest.fixture(scope="module", params=[32, 80])
def tdn(request):
    """(size, JAX model, variables, port model, x (2, T, 5, H, W, 3), the
    JAX eval logits of x)."""
    size = request.param
    jmodel, variables = _jax_tdn(size)
    x = np.random.default_rng(0).standard_normal(
        (2, SEG, 5, size, size, 3)).astype(np.float32)
    want = np.asarray(j_eval(variables, x))
    model = TDN(NUM_CLASS, SEG, dropout=0.0)
    load_flax_variables(model, variables)
    return size, jmodel, variables, model, x, want


def test_tdn_eval_logits_match_jax(tdn):
    """Eval logits within 1e-4, from the rank-6 bursts and from the
    dataset's (B, T·5, H, W, C) layout alike."""
    size, _, _, model, x, want = tdn
    with torch.no_grad():
        got6 = model(torch.from_numpy(x)).numpy()
        got5 = model(torch.from_numpy(x.reshape(2, SEG * 5, size, size, 3)))
    assert got6.shape == (2, NUM_CLASS) and got6.dtype == np.float32
    np.testing.assert_allclose(got6, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got5.numpy(), got6)
    assert np.abs(want).max() > 0.1  # the comparison is not of zeros


def test_tdn_refuses_other_bursts():
    model = TDN(NUM_CLASS, SEG)
    with pytest.raises(ValueError, match="bursts"):
        model(torch.zeros(1, SEG, 4, 32, 32, 3))
    with pytest.raises(ValueError, match="5-frame"):
        TDN(NUM_CLASS, SEG, num_frames=8)


def test_tdn_train_step_matches_jax():
    """From identical weights and a (B, T·5, H, W, 3) uint8 batch, one
    step of the port's trainer (tdn.yaml's optimizer: SGD with the TSN
    groups, cosine with warmup, no partial BN, no fc_lr5) against the JAX
    train step, both models in float64: with every BN on the batch
    statistics of 8 frames, TDN's train-mode forward at a test's size is
    ill-conditioned in fp32 (each package's fp32 logits lie 1e-4 to 2e-4
    from its fp64 ones, where the two packages agree to the last bit of
    the fp32 logits), so the slice-2 bar is held in fp64."""
    opts = [f"model.num_class={NUM_CLASS}", f"model.num_segments={SEG}",
            "model.dtype=float32", "model.dropout=0.0", "data.batch_size=2"]
    cfg, jcfg = load_config(TDN_YAML, opts), j_load_config(TDN_YAML, opts)
    rng = np.random.default_rng(3)
    x_u8 = rng.integers(0, 256, (2, SEG * 5, 32, 32, 3), dtype=np.uint8)
    y = np.array([0, 2], np.int32)
    with jax.enable_x64(True):
        jmodel = JaxTDN(num_class=NUM_CLASS, num_segments=SEG, dropout=0.0,
                        dtype=jnp.float64)
        variables = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), _jax_tdn(32, seed=2)[1])
        [(want, want_loss)] = jax_train_step(jmodel, jcfg, variables, x_u8,
                                             y, 10)
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.model, TDN) and not cfg.model.partial_bn
    trainer.model = TDN(NUM_CLASS, SEG, dropout=0.0,
                        dtype=torch.float64).double()
    check_train_step(trainer, variables, x_u8, y, want, want_loss)


def test_tdn_policy_groups_match_jax():
    """The optimizer knows TDN's modules (``resnext_layer1``, ``mse``,
    ``conv1_5``): the port's groups equal the JAX labels, leaf for leaf,
    with and without partial BN."""
    model = TDN(NUM_CLASS, SEG)
    for partial_bn, fc_lr5 in ((False, False), (True, True)):
        got = label_params(model.named_parameters(), partial_bn, fc_lr5)
        want = {n: j_classify(flax_path(n, p), partial_bn, fc_lr5)
                for n, p in model.named_parameters()}
        assert got == want
    assert got["conv1.weight"] == "first_conv_weight"
    assert got["layer2_0.mse.conv1.weight"] == "normal_weight"
    assert got["resnext_layer1_0.bn1.weight"] == got["bn1_5.weight"] == \
        "frozen"
    assert got["bn1.weight"] == "bn"


# ---------------------------------------------------------------- variables

def test_init_variables_match_the_jax_tree():
    """``init_flax_variables`` gives the JAX init tree's keys and shapes,
    the shift taps equal to the JAX init's (the shift pattern), lecun
    convs and a normal(0.01) head."""
    jmodel = JaxTDN(num_class=NUM_CLASS, num_segments=SEG)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, SEG, 5, 32, 32, 3)), train=False))
    model = TDN(NUM_CLASS, SEG)
    variables = init_flax_variables(model, seed=0)
    for coll in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in _flat(dict(shapes[coll]))}
        got = {p: np.shape(a) for p, a in _flat(variables[coll])}
        assert got == want, coll
    params = dict(_flat(variables["params"]))
    taps = {p: a for p, a in params.items() if p[-2] == "shift"}
    assert len(taps) == 13  # the blocks of layers 2-4
    for path, a in taps.items():
        c = a.shape[0]
        jv = JShift(channels=c, n_segment=SEG).init(
            jax.random.PRNGKey(0), jnp.zeros((SEG, 1, 1, c)))
        np.testing.assert_array_equal(a, np.asarray(jv["params"]["kernel"]))
    k = params[("layer3_0", "conv2", "kernel")]
    assert abs(k.std() * np.sqrt(np.prod(k.shape[:-1])) - 1.0) < 0.1
    assert abs(params[("new_fc", "kernel")].std() - 0.01) < 0.002
    assert not params[("layer3_0", "conv2", "bias")].any()
    load_flax_variables(model, variables)  # strict


# ---------------------------------------------------------------- sampler

@pytest.mark.parametrize("total", [3, 8, 10, 11, 12, 40])
@pytest.mark.parametrize("random", [True, False])
@pytest.mark.parametrize("num_frames", [5, 3])
def test_tdn_sample_indices_match_jax(total, random, num_frames):
    """Every branch (segments of average_duration > 0; fewer bursts than
    segments, drawn and sorted; total ≤ segments, zeros) with the
    (total − 5 + 1) quirk, for the same default_rng seeds."""
    for seed in range(3):
        got = tdn_sample_indices(total, 8, num_frames,
                                 np.random.default_rng(seed), random)
        want = j_tdn_sample_indices(total, 8, num_frames,
                                    np.random.default_rng(seed), random)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype and got.shape == (8,)


# ---------------------------------------------------------------- dataset

@pytest.mark.parametrize("split", ["train", "val"])
@pytest.mark.parametrize("backend", ["native", "cv2"])
def test_tdn_dataset_batches_are_bit_identical(corpus, split, backend,  # noqa: F811
                                               monkeypatch):
    """build_dataset's TDNDataset against the JAX one's: (T·5, H, W, 3)
    uint8 bursts clamped in the span, batch for batch over two epochs."""
    if backend == "cv2":
        monkeypatch.setattr(jpeg, "_load", lambda: None)
        monkeypatch.setattr(jjpeg, "_load", lambda: None)
    cfgs = [_data_cfg(cls, corpus, "FrameDataset")  # the rawframe lists
            for cls in (DataConfig, JDataConfig)]
    for cfg in cfgs:
        cfg.dataset_type = "TDNDataset"
    port = datasets.build_dataset(cfgs[0], split)
    ref = jdatasets.build_dataset(cfgs[1], split)
    assert type(port).__name__ == type(ref).__name__ == "TDNDataset"
    got = _batches(DataLoader, port, split == "train")
    want = _batches(JDataLoader, ref, split == "train")
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.shape[1:] == (DATA_SEG * 5, 32, 32, 3)
        assert gx.dtype == np.uint8
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


# ---------------------------------------------------------------- checkpoint

def _reference_tdn(seed=0):
    """The reference TDN's state dict (``layer{i}_bak``, ``resnext_layer1``,
    ``mse.*``, ``shift.conv``, ``conv1_5.{0,1}``) with random BN
    statistics and off-init shift taps."""
    torch.manual_seed(seed)
    tmodel = TorchTDN(num_class=NUM_CLASS, num_segments=SEG, dropout=0.0)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            if isinstance(m, torch.nn.Conv1d):
                m.weight.add_(0.2 * torch.randn(m.weight.shape, generator=g))
    return {f"module.{k}": v for k, v in tmodel.state_dict().items()}


def test_port_tdn_checkpoint_matches_jax(tmp_path, capsys):
    """``port_tdn_checkpoint`` on a reference state dict (DDP prefixes
    included) gives the JAX port's tree, and the port's TDN on it the JAX
    TDN's logits within 1e-4; ``export_model --torch-ckpt`` takes the TDN
    map and exports a rank-6 artifact."""
    sd = _reference_tdn()
    model = TDN(NUM_CLASS, SEG, dropout=0.0)
    target = init_flax_variables(model, seed=0)
    tree = port_tdn_checkpoint(sd, NUM_CLASS, target_params=target["params"])
    jtree = j_port_tdn_checkpoint(sd, NUM_CLASS,
                                  target_params=target["params"])
    for coll in ("params", "batch_stats"):
        got, want = dict(_flat(tree[coll])), dict(_flat(jtree[coll]))
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    load_flax_variables(model, tree)
    x = np.random.default_rng(1).standard_normal(
        (2, SEG, 5, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(j_eval(jax.tree_util.tree_map(jnp.asarray, jtree), x))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # a head of another width is dropped, the target's kept
    other = port_tdn_checkpoint(sd, NUM_CLASS + 1, target["params"])
    np.testing.assert_array_equal(other["params"]["new_fc"]["kernel"],
                                  target["params"]["new_fc"]["kernel"])

    path = str(tmp_path / "tdn.pth")
    torch.save({"state_dict": sd}, path)
    export_cli.main(["--cfg", TDN_YAML, "--torch-ckpt", path, "--batch", "2",
                     "--cpu", "-o", str(tmp_path / "tdn"),
                     f"model.num_class={NUM_CLASS}",
                     f"model.num_segments={SEG}", "model.dtype=float32",
                     "data.image_size=32"])
    assert "exported to" in capsys.readouterr().out
    art = InferenceEngine.from_exported(str(tmp_path / "tdn.pt2"), "cpu")
    assert (art.input_rank, art.num_segments, art.image_size) == (6, SEG, 32)
    x_u8 = np.random.default_rng(2).integers(
        0, 256, (3, SEG, 5, 32, 32, 3), dtype=np.uint8)
    live = InferenceEngine(model, SEG, 2, 32, device="cpu", input_rank=6)
    np.testing.assert_allclose(art.score_windows(x_u8),
                               live.score_windows(x_u8), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="score_windows"):
        art.score_video(np.zeros((40, 32, 32, 3), np.uint8))


# ---------------------------------------------------------------- engine

def test_rank6_engine_scores_as_jax():
    """A rank-6 engine's score_windows and score_clip equal the JAX
    engine's with input_rank=6 (window batch 2, so the padded tail chunk
    runs); its video paths raise, naming score_windows."""
    size = 32
    jmodel, variables = _jax_tdn(size, seed=4)
    model = TDN(NUM_CLASS, SEG, dropout=0.0)
    load_flax_variables(model, variables)
    jeng = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                     num_segments=SEG, window_batch=2, image_size=size,
                     input_rank=6)
    eng = InferenceEngine(model, SEG, 2, size, device="cpu", input_rank=6)
    x = np.random.default_rng(3).integers(0, 256, (3, SEG, 5, size, size, 3),
                                          dtype=np.uint8)
    np.testing.assert_allclose(eng.score_windows(x), jeng.score_windows(x),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(eng.score_clip(x[0]), jeng.score_clip(x[0]),
                               rtol=TOL, atol=TOL)
    assert not eng.supports_device_gather
    video = np.zeros((40, size, size, 3), np.uint8)
    with pytest.raises(ValueError, match="score_windows"):
        eng.score_video(video)
    with pytest.raises(ValueError, match="score_windows"):
        score_video_chunked(eng, "unread.mp4")


def test_build_model_and_engine_from_checkpoint_take_tdn():
    """build_model builds TDN (num_frames at least 5), example_input_shape
    gives its rank-6 shape, engine_from_checkpoint takes input_rank 6 and
    refuses 4, which is the image models' (and taken for an image config)."""
    cfg = load_config(TDN_YAML, [f"model.num_segments={SEG}",
                                 "model.dtype=float32", "model.num_frames=1"])
    model = build_model(cfg.model)
    assert isinstance(model, TDN) and model.num_frames == 5
    assert example_input_shape(cfg.model, batch=2, image_size=32) == \
        (2, SEG, 5, 32, 32, 3)
    eng = engine_from_checkpoint(cfg, None, image_size=32, window_batch=1,
                                 input_rank=6, device="cpu")
    assert eng.input_rank == 6
    x = np.zeros((1, SEG, 5, 32, 32, 3), np.uint8)
    assert eng.score_windows(x).shape == (1, 12)
    # rank 4 is the image models' input, not TDN's; an image config takes it
    with pytest.raises(ValueError, match="rank 4"):
        engine_from_checkpoint(cfg, None, input_rank=4, device="cpu")
    cfg.model.model_type, cfg.model.base_model = "image", "resnet18"
    img = engine_from_checkpoint(cfg, None, image_size=32, window_batch=2,
                                 input_rank=4, device="cpu")
    assert img.score_images(np.zeros((3, 32, 32, 3), np.uint8)).shape == \
        (3, 12)
