"""PyTorch port, model level: the port's TSM against the JAX TSM on the
same flax variables, fp32 on the CPU, logits within 1e-4.

The JAX variables come from ``TSM.init`` and are then randomised from a
numpy seed (BN statistics and affine, a unit-scale head) so that a wrong
key, layout or shift direction shows in the logits. The port loads them
through ``load_flax_variables``. The R50 case holds the port's main path
(fused blocks and shift-matmul sites, plain versions on the CPU) against
the JAX package's Pallas path (``fused_block=True, shift_impl='pallas'``)
in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      port_state_to_flax,
                                                      random_flax_variables)

SIZE = 32
SEG = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set(tree, path, value):
    for k in path[:-1]:
        tree = tree[k]
    tree[path[-1]] = value


_SHAPES = {}  # (the flax module's repr, input shape, dtype) → its tree


def init_shapes(model, x):
    """``jax.eval_shape`` of the JAX model's init on ``x`` (it traces the
    init without running it), once a process per module and input shape:
    the tree's shapes do not depend on the seed."""
    key = (repr(model), tuple(x.shape), str(x.dtype))
    if key not in _SHAPES:
        _SHAPES[key] = jax.eval_shape(
            lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                               train=False))
    return _SHAPES[key]


def randomized_variables(model, x, seed=0):
    """The JAX model's variable tree (``init_shapes``), filled from a numpy
    seed: lecun-normal conv kernels, random BN stats/affine, a unit-scale
    head."""
    shapes = init_shapes(model, x)
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), {
        "params": dict(shapes["params"]),
        "batch_stats": dict(shapes["batch_stats"])})
    rng = np.random.default_rng(seed)
    for coll in ("params", "batch_stats"):
        for path, a in list(_flatten(v[coll])):
            leaf, owner = path[-1], path[-2]
            if leaf == "kernel" and owner != "fc":
                new = rng.normal(0.0, 1.0 / np.sqrt(np.prod(a.shape[:-1])),
                                 a.shape)
            elif leaf == "mean":
                new = rng.normal(0.0, 0.2, a.shape)
            elif leaf == "var":
                new = rng.uniform(0.5, 1.5, a.shape)
            elif leaf == "scale":
                new = rng.uniform(0.5, 1.5, a.shape)
            elif leaf == "bias" and owner != "fc":
                new = rng.normal(0.0, 0.1, a.shape)
            elif owner == "fc" and leaf == "kernel":
                new = rng.normal(0.0, 1.0 / np.sqrt(a.shape[0]), a.shape)
            else:
                continue
            _set(v[coll], path, new.astype(np.float32))
    return v


def _pair(base, shift_place="blockres", temporal_pool=False, jax_kw=None,
          num_class=5):
    kw = dict(num_class=num_class, num_segments=SEG, base_model=base,
              shift_place=shift_place, temporal_pool=temporal_pool,
              dropout=0.0, dtype=jnp.float32)
    # the Pallas paths share the XLA path's param tree; init through XLA
    x0 = jnp.zeros((1, SEG, SIZE, SIZE, 3), jnp.float32)
    variables = randomized_variables(JaxTSM(**kw), x0)
    jmodel = JaxTSM(**kw, **(jax_kw or {}))
    tmodel = TSM(num_class, SEG, base, shift_place=shift_place,
                 temporal_pool=temporal_pool, dtype=torch.float32).eval()
    load_flax_variables(tmodel, variables)
    return jmodel, tmodel, variables


def _logits(jmodel, tmodel, variables, x, interpret=False):
    jv = jax.tree_util.tree_map(jnp.asarray, variables)
    apply = jax.jit(lambda v, xv: jmodel.apply(v, xv, train=False))
    if interpret:
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(apply(jv, jnp.asarray(x)))
    else:
        want = np.asarray(apply(jv, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    return got, want


@pytest.mark.parametrize("shift_place,temporal_pool", [
    ("blockres", False), ("block", False), ("blockres", True)])
def test_tsm_r18_logits_match_jax(shift_place, temporal_pool):
    jmodel, tmodel, variables = _pair("resnet18", shift_place, temporal_pool)
    x = np.random.default_rng(1).standard_normal(
        (2, SEG, SIZE, SIZE, 3)).astype(np.float32)
    got, want = _logits(jmodel, tmodel, variables, x)
    assert got.shape == want.shape == (2, 5)
    assert np.abs(want).max() > 0.1  # a unit-scale head, not ~0 logits
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tsm_r50_main_path_matches_jax_pallas():
    """Port main path (6 fused blocks, 10 shift-matmul sites) vs the JAX
    Pallas fused-block + shift-matmul path, B = 2 clips."""
    jmodel, tmodel, variables = _pair(
        "resnet50", jax_kw=dict(fused_block=True, shift_impl="pallas"))
    x = np.random.default_rng(2).standard_normal(
        (2, SEG, SIZE, SIZE, 3)).astype(np.float32)
    got, want = _logits(jmodel, tmodel, variables, x, interpret=True)
    assert got.shape == want.shape == (2, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_tsm_identity_consensus_and_fused_off():
    jmodel = JaxTSM(num_class=3, num_segments=SEG, base_model="resnet50",
                    consensus_type="identity", dropout=0.0, dtype=jnp.float32)
    variables = randomized_variables(
        jmodel, jnp.zeros((1, SEG, SIZE, SIZE, 3), jnp.float32), seed=3)
    tmodel = TSM(3, SEG, "resnet50", consensus_type="identity",
                 fused_block=False)
    load_flax_variables(tmodel, variables)
    x = np.random.default_rng(3).standard_normal(
        (1, SEG, SIZE, SIZE, 3)).astype(np.float32)
    got, want = _logits(jmodel, tmodel, variables, x)
    assert got.shape == want.shape == (1, SEG, 3)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_load_flax_variables_is_strict():
    model = TSM(4, SEG, "resnet18")
    v = random_flax_variables(model, seed=0)
    load_flax_variables(model, v)
    sd = model.state_dict()
    assert all(np.array_equal(sd[k].numpy(), a)
               for k, a in flax_to_port_state(v).items())
    missing = port_state_to_flax(
        {k: a for k, a in flax_to_port_state(v).items()
         if k != "backbone.layer1_0.bn1.running_var"})
    with pytest.raises(KeyError):
        load_flax_variables(model, missing)
    extra = port_state_to_flax(dict(flax_to_port_state(v),
                                    **{"backbone.extra.weight": np.ones(3)}))
    with pytest.raises(KeyError):
        load_flax_variables(model, extra)
    bad = port_state_to_flax(dict(flax_to_port_state(v),
                                  **{"fc.bias": np.ones(5, np.float32)}))
    with pytest.raises(ValueError):
        load_flax_variables(model, bad)


def test_port_state_round_trip():
    model = TSM(4, SEG, "resnet50")
    state = flax_to_port_state(random_flax_variables(model, seed=1))
    back = flax_to_port_state(port_state_to_flax(state))
    assert state.keys() == back.keys()
    assert all(np.array_equal(state[k], back[k]) for k in state)
