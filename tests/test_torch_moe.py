"""PyTorch port, TimeSformer's MoE MLPs: ``MoEMlp`` and a divided-attention
TimeSformer with ``moe_experts > 0`` against the JAX package on the CPU in
fp32, on the same numpy-seeded inputs and variables (the JAX model's own
tree filled from a numpy seed, through ``load_flax_variables``).

Tolerances: ``MoEMlp`` forward, ``moe_loss`` and every gradient (the
router's too) 1e-5; a MoE TimeSformer's logits 1e-4; its train step at the
repo's torch↔JAX bar (loss 1e-5, updated parameters 1e-4); the
initializers' scales within 10% of flax's (leaves of ≥ 1,000 draws).
Sizes: MoEMlp at d 16-64 with 2-4 experts; a TimeSformer of D 64, 2
layers, 2 heads, T 4, 32 px, patch 8. The JAX TimeSformer takes its XLA
attention; the port's spatial attention is the ``Attention`` function,
whose CPU path is the kernel's plain version (held to the Pallas kernel
in interpret mode by ``test_torch_timesformer*.py``).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_repnet import filled_variables
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu.models.moe import MoEMlp as JaxMoE
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import collect_sown, cross_entropy_loss
from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.models import (MoEMlp, TimeSformer,
                                              build_model,
                                              init_flax_variables,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      port_state_to_flax)
from workoutdetector_tpu_torch.models.moe import capacity
from workoutdetector_tpu_torch.train.trainer import Trainer, train_loss
from workoutdetector_tpu_torch.utils.export import export_model
from workoutdetector_tpu_torch.infer import InferenceEngine

B, T, SIZE, PATCH, DIM, LAYERS, HEADS, NCLS, E = 2, 4, 32, 8, 64, 2, 2, 5, 4
YAML = str(Path(__file__).resolve().parents[1]
           / "workoutdetector_tpu/configs/timesformer.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)



# ------------------------------------------------------------------ MoEMlp
MOE_CASES = {
    # (d, hidden, experts, capacity factor, token shape)
    "ample": (16, 32, 2, 8.0, (3, 7)),
    "overflow": (32, 48, 4, 0.5, (2, 5, 3)),
    "default": (64, 96, 3, 1.25, (40,)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_mlp_forward_loss_and_grads_match_jax(case):
    """Forward, the Switch load-balance loss and the gradients of a scalar
    of both (input, router, experts) against the JAX module; the overflow
    case drops tokens (capacity 0.5 · t / E), whose outputs are zero."""
    d, h, e, cf, lead = MOE_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal(lead + (d,)).astype(np.float32)
    ct = rng.standard_normal(lead + (d,)).astype(np.float32)
    jm = JaxMoE(dim=d, hidden=h, num_experts=e, capacity_factor=cf)
    variables = filled_variables(jm, jnp.asarray(x), 1)

    @jax.jit
    def jax_fn(params, xj):
        def f(p, xx):
            y, inter = jm.apply({"params": p}, xx, mutable=["intermediates"])
            loss = collect_sown(inter["intermediates"], "moe_loss")[0]
            return jnp.sum(y * ct) + 3.0 * loss, (y, loss)
        (_, (y, loss)), grads = jax.value_and_grad(f, argnums=(0, 1),
                                                   has_aux=True)(params, xj)
        return y, loss, grads

    jp = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    y_j, loss_j, (gp_j, gx_j) = jax_fn(jp, jnp.asarray(x))

    m = MoEMlp(d, h, e, cf)
    load_flax_variables(m, variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    y, loss = m(xt)
    ((y * torch.from_numpy(ct)).sum() + 3.0 * loss).backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    assert abs(float(loss.detach()) - float(loss_j)) <= 1e-5
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), rtol=1e-5,
                               atol=1e-5)
    want = flax_to_port_state({"params": _np(gp_j)})
    got = {n: p.grad.numpy() for n, p in m.named_parameters()}
    assert got.keys() == want.keys()
    for n in got:
        np.testing.assert_allclose(got[n], want[n], rtol=1e-5, atol=1e-5,
                                   err_msg=n)
    assert np.abs(want["router.weight"]).max() > 0  # the gate's path
    tokens = int(np.prod(lead))
    cap = capacity(tokens, e, cf)
    _, expert, slot, _ = m.route(torch.from_numpy(x).reshape(-1, d))
    dropped = (slot > cap).numpy()
    rows = y.detach().reshape(-1, d).numpy()
    assert (rows[dropped] == 0).all()
    if case == "ample":
        assert not dropped.any()
    if case == "overflow":
        assert dropped.any()


def test_moe_capacity_and_dispatch_are_the_jax_rule():
    """capacity = max(1, int(ceil(t / E) · factor)); slots follow token
    order per expert; ties go to the first expert, as ``jnp.argmax``."""
    assert [capacity(t, 8, 1.25) for t in (1, 8, 9, 25088)] == \
        [1, 1, 2, 3920]
    assert capacity(5, 2, 1e-9) == 1
    m = MoEMlp(4, 6, 3, 1.0)
    with torch.no_grad():
        m.router.weight.zero_()
        m.router.bias.copy_(torch.tensor([1.0, 1.0, 0.0]))
    gates, expert, slot, cap = m.route(torch.randn(7, 4))
    assert expert.tolist() == [0] * 7 and slot.tolist() == list(range(1, 8))
    assert cap == 3


# ------------------------------------------------------- MoE TimeSformer
def _jax_ts(**kw):
    return jts.TimeSformer(num_class=NCLS, num_segments=T, image_size=SIZE,
                           patch_size=PATCH, embed_dims=DIM,
                           num_layers=LAYERS, num_heads=HEADS,
                           moe_experts=E, moe_capacity_factor=1.25,
                           dtype=jnp.float32, **kw)


def _port_ts():
    return TimeSformer(NCLS, T, SIZE, PATCH, DIM, LAYERS, HEADS,
                       moe_experts=E, moe_capacity_factor=1.25)


@pytest.fixture(scope="module")
def moe_variables():
    return filled_variables(_jax_ts(),
                            jnp.zeros((1, T, SIZE, SIZE, 3), jnp.float32), 2)


def test_moe_timesformer_logits_match_jax(moe_variables, tmp_path):
    """Eval logits of the divided MoE TimeSformer within 1e-4 of JAX's; the
    engine (t_fc folded) and a CPU ``.pt2`` of the model equal to the live
    model, and the model's tree the JAX tree's keys and shapes."""
    x = np.random.default_rng(4).integers(0, 256, (B, T, SIZE, SIZE, 3),
                                          dtype=np.uint8)
    want = np.asarray(jax.jit(lambda v, xx: _jax_ts().apply(
        v, j_normalize(xx)))(jax.tree_util.tree_map(jnp.asarray,
                                                    moe_variables),
                             jnp.asarray(x)))
    model = _port_ts()
    load_flax_variables(model, moe_variables)
    engine = InferenceEngine(model, T, window_batch=B, image_size=SIZE,
                             device="cpu")
    assert engine.model.fold_temporal_fc
    got = engine.score_windows(x)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    art = export_model(model, str(tmp_path / "moe"), (B, T, SIZE, SIZE, 3),
                       device="cpu")
    art_engine = InferenceEngine.from_exported(art, device="cpu")
    np.testing.assert_allclose(art_engine.score_windows(x), got, rtol=1e-5,
                               atol=1e-5)
    tree = port_state_to_flax(model.state_dict())["params"]
    flat = flax_to_port_state({"params": tree})
    assert flat.keys() == flax_to_port_state(moe_variables).keys()


def _yaml_cfg(loader):
    """timesformer.yaml's optimizer and schedule, a narrow MoE model in
    fp32 without dropout or stochastic depth, ``moe_aux_weight`` 0.5 (so
    the load-balance term weighs in the loss)."""
    cfg = loader(YAML)
    m = cfg.model
    m.base_model, m.embed_dims, m.num_layers, m.num_heads = "custom", DIM, \
        LAYERS, HEADS
    m.image_size, m.patch_size, m.num_segments = SIZE, PATCH, T
    m.num_class, m.dtype, m.dropout, m.drop_path_rate = NCLS, "float32", \
        0.0, 0.0
    m.moe_experts, m.moe_capacity_factor, m.moe_aux_weight = E, 1.25, 0.5
    cfg.data.batch_size, cfg.data.num_segments = B, T
    return cfg


def test_moe_timesformer_train_step_matches_jax(moe_variables):
    """One step of the port's trainer against the body of the JAX
    trainer's step (CE + moe_aux_weight × the mean of the sown losses, two
    per block) with timesformer.yaml's optimizer; the loss within 1e-5,
    every updated parameter within 1e-4. The port's train-mode forward
    hands back 2·L losses."""
    jcfg = _yaml_cfg(j_load_config)
    model = _jax_ts()
    params = jax.tree_util.tree_map(jnp.asarray, moe_variables["params"])
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler, params, 10,
                              jcfg.trainer.max_epochs)
    rng = np.random.default_rng(5)
    x_u8 = rng.integers(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)
    y = np.array([1, 4], np.int32)

    @jax.jit
    def step(params, opt_state, xb, yb):
        def loss_fn(p):
            out, upd = model.apply({"params": p}, j_normalize(xb), train=True,
                                   mutable=["intermediates"],
                                   rngs={"dropout": jax.random.PRNGKey(1)})
            moe = collect_sown(upd["intermediates"], "moe_loss")
            return cross_entropy_loss(out, yb) + 0.5 * (sum(moe) / len(moe)), \
                len(moe)
        (loss, n), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss, n

    new_params, want_loss, n_sown = step(params, tx.init(params),
                                         jnp.asarray(x_u8), jnp.asarray(y))
    assert int(n_sown) == 2 * LAYERS

    trainer = Trainer(_yaml_cfg(load_config), device="cpu")
    state = trainer.init_state(steps_per_epoch=10, variables=moe_variables)
    state.model.train()
    out = state.model(torch.from_numpy(x_u8).float().div(255))
    assert isinstance(out, tuple) and out[1] is None
    assert out[2].shape == (2 * LAYERS,)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - float(want_loss)) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state({"params": _np(new_params)})
    before = flax_to_port_state(moe_variables)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
    for k in ("block_0.mlp.w1", "block_1.mlp.router.weight"):
        assert not np.array_equal(got[k], before[k]), k


def test_train_loss_adds_the_mean_moe_loss():
    logits = torch.tensor([[1.0, 0.0], [0.0, 2.0]])
    y = torch.tensor([0, 1])
    base, _ = train_loss(logits, y, 0.5)
    moe = torch.tensor([1.5, 2.5, 1.0, 3.0])
    got, out = train_loss((logits, None, moe), y, 0.5, 0.01)
    assert torch.equal(out, logits)
    assert abs(float(got - base) - 0.01 * 2.0) < 1e-7


def test_moe_initializers_are_flax_and_build_model_takes_moe():
    """``init_flax_variables`` draws a 3-D expert kernel with flax's
    ``lecun_normal`` fan-in of every axis but the last (E · d: std
    1/√(8·64) = 0.0442 at (8, 64, 256)), as the JAX init does; biases
    zero; the fp32 router. ``build_model`` gives each divided block a
    ``MoEMlp`` for ``moe_experts > 0`` (timesformer.yaml narrowed)."""
    d, h, e = 64, 256, 8
    ours = init_flax_variables(MoEMlp(d, h, e), seed=0)["params"]
    jv = jax.jit(JaxMoE(dim=d, hidden=h, num_experts=e).init)(
        jax.random.PRNGKey(0), jnp.zeros((4, d)))["params"]
    for leaf, fan_in in (("w1", e * d), ("w2", e * h)):
        want = 1.0 / np.sqrt(fan_in)
        assert abs(ours[leaf].std() / want - 1) < 0.1, leaf
        assert abs(float(jnp.std(jv[leaf])) / want - 1) < 0.1, leaf
        assert ours[leaf].shape == jv[leaf].shape
    assert abs(ours["w1"].std() - 0.0442) < 0.002
    for leaf in ("b1", "b2"):
        assert ours[leaf].shape == jv[leaf].shape and not ours[leaf].any()
    assert ours["router"]["kernel"].shape == jv["router"]["kernel"].shape
    cfg = load_config(YAML, ["model.moe_experts=8", "model.base_model=custom",
                             "model.embed_dims=64", "model.num_layers=2",
                             "model.num_heads=2", "model.image_size=32",
                             "model.patch_size=8"])
    model = build_model(cfg.model)
    mlps = [b.mlp for b in model.blocks()]
    assert all(isinstance(m, MoEMlp) and m.num_experts == 8
               and m.capacity_factor == 1.25 for m in mlps)
    assert tuple(mlps[0].w1.shape) == (8, 64, 256)
