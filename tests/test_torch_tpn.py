"""PyTorch port, TPN: the temporal pyramid network on the shift-conv
ResNet against the JAX TPN on the same flax variables, fp32 on the CPU.

Inputs and variables come from numpy seeds (``randomized_variables``:
random BN statistics and affine, so a wrong key, layout or 3-D kernel
transpose shows). Tolerances: eval logits 1e-4 (the torch↔JAX bar of
``test_torch_tsm.py``); a train step at the bars of
``test_torch_train.py`` (loss 1e-5, updated parameters and statistics
1e-4). The JAX backbone takes its ``xla`` shift; the port's takes the
kernels' plain versions (fused blocks and shift-matmul in eval, the 1×1
backward in training). Also here: the 5-D maps of ``models/convert.py``
and ``init_flax_variables`` on TPN, the engine and the ``.pt2`` export.
"""

import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_engine import _write_video
from test_torch_tsm import randomized_variables
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.data.video import VideoReader
from workoutdetector_tpu.infer import InferenceEngine as JaxEngine
from workoutdetector_tpu.infer import count_by_video_model as j_count
from workoutdetector_tpu.models.tpn import TPN as JaxTPN
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.optim import classify_param as j_classify
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import Config, load_config
from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                             count_by_video_model)
from workoutdetector_tpu_torch.models import (TPN, build_model,
                                              init_flax_variables,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      port_state_to_flax)
from workoutdetector_tpu_torch.models.tpn import Conv3d
from workoutdetector_tpu_torch.train.optim import flax_path, label_params
from workoutdetector_tpu_torch.train.trainer import Trainer
from workoutdetector_tpu_torch.utils.export import export_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPN_YAML = os.path.join(REPO, "workoutdetector_tpu/configs/tpn.yaml")
SIZE, SEG, NUM_CLASS = 32, 4, 3
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


def _jax_tpn(base, seg=SEG, seed=1, partial_bn=False):
    jmodel = JaxTPN(num_class=NUM_CLASS, num_segments=seg, base_model=base,
                    dropout=0.0, aux_dropout=0.0, dtype=jnp.float32,
                    partial_bn=partial_bn)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, seg, SIZE, SIZE, 3), jnp.float32), seed=seed)
    return jmodel, variables


def _x(batch, seed=0, seg=SEG):
    return np.random.default_rng(seed).standard_normal(
        (batch, seg, SIZE, SIZE, 3)).astype(np.float32)


@pytest.mark.parametrize("base", ["resnet18", "resnet50"])
def test_tpn_eval_logits_match_jax(base):
    """Eval logits within 1e-4; the train-mode forward hands the aux head's
    logits over, as the JAX model sows them."""
    jmodel, variables = _jax_tpn(base)
    x = _x(2)
    want = np.asarray(jax.jit(
        lambda v, xb: jmodel.apply(v, xb, train=False))(variables, x))
    model = TPN(NUM_CLASS, SEG, base, dropout=0.0)
    model.aux_dropout = 0.0  # as the JAX model above
    load_flax_variables(model, variables)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (2, NUM_CLASS) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert np.abs(want).max() > 0.1  # the comparison is not of zeros

    _, upd = jax.jit(lambda v, xb: jmodel.apply(
        v, xb, train=True, mutable=["batch_stats", "intermediates"],
        rngs={"dropout": jax.random.PRNGKey(0)}))(variables, x)
    model.train()
    logits, aux = model(torch.from_numpy(x))
    np.testing.assert_allclose(aux.detach().numpy(),
                               np.asarray(upd["intermediates"]["aux_logits"][0]),
                               rtol=TOL, atol=TOL)


def test_tpn_backbone_routes_through_the_kernels():
    """TPN-R50's backbone is TSM-R50's: the stride-1 blocks of stages 0-1
    fused (6), every other shifted conv1 a shift-matmul site (10)."""
    model = TPN(NUM_CLASS, SEG, "resnet50")
    blocks = [getattr(model.backbone, name) for _, name, _ in
              model.backbone.blocks]
    assert sum(b.fuse for b in blocks) == 6
    assert sum(b.shift is not None and not b.fuse for b in blocks) == 10
    assert model.backbone.tap_blocks == {"layer3_5", "layer4_2"}


# ---------------------------------------------------------------- train step

def _cfgs(base, aux_weight):
    """tpn.yaml's optimizer (nesterov SGD, wd 5e-4, clip 20, multistep,
    plain SGD groups, partial BN) at a test's size, in both packages."""
    opts = [f"model.base_model={base}", f"model.num_class={NUM_CLASS}",
            f"model.num_segments={SEG}", "model.dtype=float32",
            "model.dropout=0.0", f"model.aux_loss_weight={aux_weight}",
            "data.batch_size=2", f"data.num_segments={SEG}"]
    return load_config(TPN_YAML, opts), j_load_config(TPN_YAML, opts)


def jax_train_step(jmodel, jcfg, variables, x_u8, y, steps_per_epoch,
                   aux_weights=(0.0,)):
    """The body of the JAX trainer's train_step (trainer.py:167-239) from
    the same state once for each of ``aux_weights``, through one jitted
    program over jax arrays (the weight one of its arguments, so it
    compiles once for them all): the CE plus the weight times the CE of
    the sown ``aux_logits`` where the model sows them, clip and update.
    Returns [(updated tree, loss)] in the weights' order."""
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler,
                              variables["params"], steps_per_epoch,
                              jcfg.trainer.max_epochs,
                              partial_bn=jcfg.model.partial_bn,
                              fc_lr5=jcfg.model.fc_lr5)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    @jax.jit
    def step(params, stats, opt_state, xb, yb, aux_w):
        x = j_normalize(xb)

        def loss_fn(p):
            logits, upd = jmodel.apply(
                {"params": p, "batch_stats": stats}, x, train=True,
                mutable=["batch_stats", "intermediates"],
                rngs={"dropout": jax.random.PRNGKey(1)})
            loss = cross_entropy_loss(logits, yb)
            inter = upd.get("intermediates", {})
            if "aux_logits" in inter:
                loss = loss + aux_w * cross_entropy_loss(
                    inter["aux_logits"][0], yb)
            return loss, upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return ({"params": optax.apply_updates(params, updates),
                 "batch_stats": new_stats}, loss)

    out = []
    for aux_w in aux_weights:
        tree, loss = step(params, stats, tx.init(params), jnp.asarray(x_u8),
                          jnp.asarray(y), jnp.float32(aux_w))
        out.append((tree, float(loss)))
    return out


def check_train_step(trainer, variables, x_u8, y, want, want_loss):
    """One port train step from ``variables`` against the JAX step's
    updated tree and loss: loss within 1e-5, every parameter and
    statistic within 1e-4, and most of them moved."""
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == ref.keys()
    before = flax_to_port_state(variables)
    moved = 0
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        moved += not np.array_equal(ref[k], before[k])
    assert moved > len(got) // 2


@pytest.fixture(scope="module")
def r50_step():
    """TPN-R50 variables, a uint8 batch, and the JAX step's results at aux
    weights 0.5 and 0 (one compile, two runs)."""
    jmodel, variables = _jax_tpn("resnet50", seed=2, partial_bn=True)
    rng = np.random.default_rng(3)
    x_u8 = rng.integers(0, 256, (2, SEG, SIZE, SIZE, 3), dtype=np.uint8)
    y = np.array([0, 2], np.int32)
    weights = (0.5, 0.0)
    done = jax_train_step(jmodel, _cfgs("resnet50", 0.5)[1], variables, x_u8,
                          y, 10, aux_weights=weights)
    return variables, x_u8, y, dict(zip(weights, done))


@pytest.mark.parametrize("aux_weight", [0.5, 0.0])
def test_tpn_train_step_matches_jax(r50_step, aux_weight):
    """From identical weights and batch, one step of the port's trainer
    (TPN-R50, tpn.yaml's optimizer, the 1×1 backward through the kernels'
    plain versions) against the JAX train step, with the aux term at
    tpn.yaml's weight 0.5 and at 0; the two losses differ, so the term
    counts."""
    variables, x_u8, y, want = r50_step
    cfg, _ = _cfgs("resnet50", aux_weight)
    assert cfg.model.partial_bn  # as the JAX model above
    trainer = Trainer(cfg, device="cpu")
    assert isinstance(trainer.model, TPN) and trainer.model.aux_dropout == 0.5
    trainer.model.aux_dropout = 0.0  # the JAX step's model has none
    check_train_step(trainer, variables, x_u8, y, *want[aux_weight])
    assert want[0.5][1] - want[0.0][1] > 1e-3


def test_tpn_policy_groups_match_jax():
    """The optimizer groups under partial BN and fc_lr5 (the neck's BNs
    frozen with the body's, the stem's live) equal the JAX labels, leaf
    for leaf."""
    model = TPN(NUM_CLASS, SEG, "resnet18")
    got = label_params(model.named_parameters(), partial_bn=True, fc_lr5=True)
    want = {n: j_classify(flax_path(n, p), partial_bn=True, fc_lr5=True)
            for n, p in model.named_parameters()}
    assert got == want
    assert got["aux_conv.bn.weight"] == got["pyramid_fusion.bn.bias"] == \
        "frozen"
    assert got["backbone.bn1.weight"] == "bn"
    assert got["fc.weight"] == "lr5_weight"


# ---------------------------------------------------------------- variables

def test_init_variables_match_the_jax_tree():
    """``init_flax_variables`` gives the JAX init tree's keys and shapes;
    the 5-D neck kernels are non-zero at lecun std (fan-in in/groups ·
    kd · kh · kw), the heads normal(0.01)."""
    jmodel = JaxTPN(num_class=NUM_CLASS, num_segments=SEG,
                    base_model="resnet18")
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, SEG, SIZE, SIZE, 3)), train=False))
    model = TPN(NUM_CLASS, SEG, "resnet18")
    variables = init_flax_variables(model, seed=0)
    for coll in ("params", "batch_stats"):
        want = {p: tuple(s.shape) for p, s in _flat(dict(shapes[coll]))}
        got = {p: np.shape(a) for p, a in _flat(variables[coll])}
        assert got == want, coll
    params = dict(_flat(variables["params"]))
    kernels5 = {p: a for p, a in params.items() if a.ndim == 5}
    # aux, spatial0_0, two temporal, two fusions of three, pyramid
    assert len(kernels5) == 11
    for path, a in kernels5.items():
        fan_in = np.prod(a.shape[:-1])
        assert abs(a.std() * np.sqrt(fan_in) - 1.0) < 0.1, path
    for head in ("fc", "aux_fc"):
        assert abs(params[(head, "kernel")].std() - 0.01) < 0.002
        assert not params[(head, "bias")].any()
    load_flax_variables(model, variables)  # strict


def test_5d_kernels_round_trip():
    """DHWIO ↔ OIDHW: a flax 3-D conv kernel maps to torch's conv3d
    layout (the same conv on the same input) and back unchanged."""
    rng = np.random.default_rng(0)
    k = rng.standard_normal((3, 1, 1, 8, 16)).astype(np.float32)  # g 2
    tree = {"params": {"temporal0_conv": {"kernel": k},
                       "d": {"kernel": rng.standard_normal((4, 5))}},
            "batch_stats": {}}
    port = flax_to_port_state(tree)
    assert port["temporal0_conv.weight"].shape == (16, 8, 3, 1, 1)
    back = port_state_to_flax(port)
    np.testing.assert_array_equal(back["params"]["temporal0_conv"]["kernel"], k)
    np.testing.assert_array_equal(back["params"]["d"]["kernel"],
                                  tree["params"]["d"]["kernel"])
    x = rng.standard_normal((1, 4, 2, 2, 16)).astype(np.float32)
    want = nn.Conv(16, (3, 1, 1), padding=[(1, 1), (0, 0), (0, 0)],
                   feature_group_count=2, use_bias=False).apply(
        {"params": {"kernel": k}}, x)
    conv = Conv3d(16, 16, (3, 1, 1), groups=2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(port["temporal0_conv.weight"]))
        got = conv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- engine

@pytest.fixture(scope="module")
def engines():
    jmodel, variables = _jax_tpn("resnet18", seg=8, seed=5)
    jengine = JaxEngine(jmodel, jax.tree_util.tree_map(jnp.asarray, variables),
                        num_segments=8, window_batch=4, image_size=SIZE)
    model = TPN(NUM_CLASS, 8, "resnet18")
    load_flax_variables(model, variables)
    return jengine, InferenceEngine(model, num_segments=8, window_batch=4,
                                    device="cpu")


def test_tpn_engine_scores_and_counts_as_jax(engines, tmp_path):
    """A TPN engine (rank 5) takes the video path unchanged: score_video's
    logits within 1e-4 with equal argmax, count_by_video_model's count and
    reps equal to the JAX engine's."""
    jengine, tengine = engines
    path = _write_video(tmp_path / "reps.mp4", [20, 235] * 3)
    with VideoReader(path) as r:
        video = r.read_prepped(256, SIZE)
    j_starts, j_logits = jengine.score_video(video, step=8, stride=2)
    t_starts, t_logits = tengine.score_video(video, step=8, stride=2)
    np.testing.assert_array_equal(t_starts, j_starts)
    np.testing.assert_allclose(t_logits, j_logits, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(t_logits.argmax(1), j_logits.argmax(1))
    assert j_count(jengine, path) == count_by_video_model(tengine, video)


def test_tpn_export_equals_the_live_model(engines, tmp_path):
    """A ``.pt2`` of TPN exported on the CPU scores as the live engine."""
    _, tengine = engines
    path = export_model(tengine.model, str(tmp_path / "tpn"),
                        (2, 8, SIZE, SIZE, 3), device="cpu")
    art = InferenceEngine.from_exported(path, device="cpu")
    x = np.random.default_rng(4).integers(0, 256, (3, 8, SIZE, SIZE, 3),
                                          dtype=np.uint8)
    np.testing.assert_allclose(art.score_windows(x), tengine.score_windows(x),
                               rtol=1e-5, atol=1e-5)


def test_build_model_builds_tpn():
    cfg = Config()
    cfg.model.model_type, cfg.model.base_model = "tpn", "resnet18"
    model = build_model(cfg.model)
    assert isinstance(model, TPN) and not model.training
    assert model.backbone.out_indices == (2, 3)
