"""PyTorch port, optimizer: TSN policy labels, LR schedules, the clipped
SGD / AdamW updates, gradient accumulation and EMA against the JAX
package's optax transforms, fp32 on the CPU.

Gradients are numpy-seeded and handed to both sides. Tolerance 1e-6 on
the parameters after five updates (the two sides round the learning rate
and the momentum products in different orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn as nn

from workoutdetector_tpu.config import Config as JConfig
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.train import optim as joptim
from workoutdetector_tpu_torch.config import Config
from workoutdetector_tpu_torch.models import TSM
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      port_state_to_flax)
from workoutdetector_tpu_torch.train import optim

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)

# a small tree with every policy group: stem conv and BN, a block's conv
# and (frozen under partial BN) BN, a downsample, the fc head
SHAPES = {
    "backbone.conv1.weight": (8, 3, 3, 3),
    "backbone.bn1.weight": (8,), "backbone.bn1.bias": (8,),
    "backbone.layer1_0.conv1.weight": (8, 8, 1, 1),
    "backbone.layer1_0.bn1.weight": (8,), "backbone.layer1_0.bn1.bias": (8,),
    "backbone.layer1_0.downsample_conv.weight": (16, 8, 1, 1),
    "backbone.layer1_0.downsample_bn.weight": (16,),
    "backbone.layer1_0.downsample_bn.bias": (16,),
    "fc.weight": (5, 16), "fc.bias": (5,),
}


def _module(params):
    root = nn.Module()
    for name, value in params.items():
        node = root
        *mods, leaf = name.split(".")
        for m in mods:
            if not hasattr(node, m):
                node.add_module(m, nn.Module())
            node = getattr(node, m)
        node.register_parameter(leaf, nn.Parameter(torch.from_numpy(value.copy())))
    return root


def _tree(state):
    """port-named arrays → the flax params tree."""
    return jax.tree_util.tree_map(jnp.asarray, port_state_to_flax(state)["params"])


def _run_both(cfg_edit, steps=5, accum=1, grad_scale=10.0, seed=0):
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(s).astype(np.float32) * 0.5
            for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * grad_scale).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(steps)]
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        cfg_edit(c)
    model = _module(init)
    opt = optim.TrainOptimizer(model, cfg.optimizer, cfg.lr_scheduler,
                               steps_per_epoch=3, max_epochs=4,
                               grad_accum_steps=accum)
    for g in grads:
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n].copy())
        opt.step()
    params = _tree(init)
    tx, _ = joptim.build_optimizer(jcfg.optimizer, jcfg.lr_scheduler, params,
                                   steps_per_epoch=3, max_epochs=4)
    if accum > 1:
        tx = optax.MultiSteps(tx, accum)
    state = tx.init(params)

    @jax.jit  # one compile; eager optax dispatches hundreds of small ops
    def update(g, state, params):
        updates, state = tx.update(g, state, params)
        return optax.apply_updates(params, updates), state

    for g in grads:
        params, state = update(_tree(g), state, params)
    want = flax_to_port_state({"params": jax.tree_util.tree_map(np.asarray,
                                                                params)})
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    return got, want, init, grads


def _flat(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, path + (k,))
        else:
            yield path + (k,), v


def test_label_params_match_jax_on_r50():
    jmodel = JaxTSM(num_class=12, num_segments=4, base_model="resnet50",
                    dtype=jnp.float32)
    v = jax.eval_shape(lambda x: jmodel.init({"params": jax.random.PRNGKey(0)},
                                             x, train=False),
                       jnp.zeros((1, 4, 32, 32, 3)))  # the tree, no compute
    want = dict(_flat(dict(joptim.label_params(v["params"]))))
    model = TSM(12, 4, "resnet50")
    port = optim.label_params(model.named_parameters())
    got = {optim.flax_path(n, p): port[n] for n, p in model.named_parameters()}
    assert got == want
    assert set(got.values()) == {"first_conv_weight", "bn", "frozen",
                                 "normal_weight", "lr5_weight", "lr10_bias"}


@pytest.mark.parametrize("policy,warmup", [("steplr", 0.0), ("steplr", 1.5),
                                           ("cosine", 1.0),
                                           ("multistep", 1.0)])
def test_schedules_match_optax(policy, warmup):
    steps, epochs = 10, 12
    cfg, jcfg = Config(), JConfig()
    for c in (cfg, jcfg):
        c.lr_scheduler.policy = policy
        c.lr_scheduler.warmup_epochs = warmup
        c.lr_scheduler.step = 3
        c.lr_scheduler.lr_steps = [4, 8]
    got = optim.build_schedule(cfg.lr_scheduler, 0.01, steps, epochs)
    want = joptim.build_schedule(jcfg.lr_scheduler, 0.01, steps, epochs)
    w = int(warmup * steps)
    points = [0, w // 2, w, w + 1, 29, 30, 31, 45, 69, 70, 71, 79, 80, 119,
              200]
    for n in points:  # optax evaluates in fp32, the port in Python floats
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-5,
                                   err_msg=f"{policy} n={n}")


def _tsn(c):
    c.optimizer.lr = 0.01
    c.optimizer.weight_decay = 5e-4
    c.lr_scheduler.step = 1  # a decay inside the five steps (3 per epoch)


def test_sgd_tsn_policies_with_clip_and_partial_bn_match_optax():
    got, want, init, grads = _run_both(_tsn)
    norm = np.sqrt(sum((g ** 2).sum() for g in grads[0].values()))
    assert norm > 20  # the clip is engaged
    for n in got:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)
    frozen = "backbone.layer1_0.bn1.weight"
    np.testing.assert_array_equal(got[frozen], init[frozen])  # never moves
    assert not np.array_equal(got["backbone.bn1.weight"],
                              init["backbone.bn1.weight"])


def test_unclipped_flat_sgd_and_nesterov_match_optax():
    def edit(c):
        _tsn(c)
        c.optimizer.use_tsn_policies = False
        c.optimizer.nesterov = True
        c.optimizer.grad_clip = 0.0
    got, want, _, _ = _run_both(edit, grad_scale=0.1)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_adamw_matches_optax():
    def edit(c):
        c.optimizer.method = "adamw"
        c.optimizer.lr = 1e-3
        c.optimizer.weight_decay = 0.05
    got, want, _, _ = _run_both(edit)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_delayed_clip_matches_optax():
    def edit(c):
        _tsn(c)
        c.optimizer.grad_clip_delayed = True
    got, want, _, _ = _run_both(edit)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_grad_accumulation_matches_multisteps():
    got, want, _, _ = _run_both(_tsn, steps=6, accum=3)
    for n in got:
        np.testing.assert_allclose(got[n], want[n], err_msg=n, **TOL)


def test_ema_matches_the_jax_update():
    rng = np.random.default_rng(4)
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in SHAPES.items()}
    model = _module(init)
    ema = optim.EMA(model, 0.9)
    want = {k: v.copy() for k, v in init.items()}
    for _ in range(5):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.add_(torch.from_numpy(rng.standard_normal(p.shape).astype(
                    np.float32)))
        ema.update(model)
        new = {n: p.detach().numpy() for n, p in model.named_parameters()}
        want = jax.tree_util.tree_map(
            lambda e, p: np.asarray(jnp.asarray(e) * 0.9
                                    + jnp.asarray(p) * (1.0 - 0.9)), want, new)
    for n in want:
        np.testing.assert_allclose(ema.params[n].numpy(), want[n], err_msg=n,
                                   **TOL)
        assert ema.params[n].data_ptr() != dict(model.named_parameters())[
            n].data_ptr()  # a distinct copy
