"""PyTorch port, TimeSformer training: the flax initializers, the attention
backward, stochastic depth, one train step and the trainer, against the
JAX package on the CPU in fp32, on the same numpy-seeded inputs and flax
variables.

Tolerances: the attention backward 1e-5 (fp32, sums in another order);
the loss of a train step 1e-5 and every updated parameter 1e-4 (a whole
forward, backward, clip and SGD update through either stack, the repo's
torch↔JAX bar); initializer scales within 10% (leaves of ≥ 1,000 draws).
Sizes as ``tests/test_torch_timesformer.py`` (B 2, T 4, 32 px, patch 8, D
64, 2 layers, 2 heads). Where the JAX function reaches the library Pallas
TPU flash attention (``_flash_mha``) it runs in interpret mode.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import load_config
from workoutdetector_tpu_torch.models import (TSM, TimeSformer,
                                              fold_for_inference,
                                              init_flax_variables,
                                              load_flax_variables)
from workoutdetector_tpu_torch.models import timesformer as tts
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.train.optim import TrainOptimizer
from workoutdetector_tpu_torch.train.trainer import Trainer

B, T, SIZE, PATCH, DIM, LAYERS, HEADS, NCLS = 2, 4, 32, 8, 64, 2, 2, 5
P = (SIZE // PATCH) ** 2
TYPES = ["divided_space_time", "joint_space_time", "space_only"]
YAML = str(Path(__file__).resolve().parents[1]
           / "workoutdetector_tpu/configs/timesformer.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _port(attention_type="divided_space_time", **kw):
    return TimeSformer(NCLS, T, SIZE, PATCH, DIM, LAYERS, HEADS,
                       attention_type=attention_type, **kw)


def _loaded(seed=0, **kw):
    model = _port(**kw)
    load_flax_variables(model, random_flax_variables(model, seed=seed))
    return model


def _clips(seed=0, n=B):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, T, SIZE, SIZE, 3)).astype(np.float32))


def _gen(seed):
    return torch.Generator().manual_seed(seed)


# ---------------------------------------------------------------- init
def _jax_init(case):
    key = jax.random.PRNGKey(0)
    if case == "tsm":
        model = JaxTSM(num_class=3, num_segments=T, base_model="resnet18",
                       dtype=jnp.float32)
        x = jnp.zeros((1, T, SIZE, SIZE, 3), jnp.float32)
        return jax.jit(lambda k: model.init(k, x))(key)
    model = jts.TimeSformer(num_class=NCLS, num_segments=T, image_size=SIZE,
                            patch_size=PATCH, embed_dims=DIM,
                            num_layers=LAYERS, num_heads=HEADS,
                            dtype=jnp.float32)
    x = jnp.zeros((1, T, SIZE, SIZE, 3), jnp.float32)
    return jax.jit(lambda k: model.init(k, x))(key)


@pytest.mark.parametrize("case", ["timesformer", "tsm"])
def test_init_matches_the_jax_init_tree(case):
    """``init_flax_variables`` against the JAX model's own ``init``, leaf
    by leaf: the same leaves, the same zero / constant / random pattern
    (TimeSformer: t_fc zero, the embeddings random), and each random
    leaf's std within 10% where it has ≥ 1,000 entries. TSM's tree is the
    one it always was (N(0.001) head, lecun convs, BN 1 and 0)."""
    port = _port() if case == "timesformer" else TSM(3, T, "resnet18")
    got = flax_to_port_state(init_flax_variables(port, seed=0))
    want = flax_to_port_state(jax.tree_util.tree_map(np.asarray,
                                                     _jax_init(case)))
    assert got.keys() == want.keys()
    for k in got:
        a, b = got[k].astype(np.float64), want[k].astype(np.float64)
        assert a.shape == b.shape, k
        assert (a == 0).all() == (b == 0).all(), k
        if (b == b.flat[0]).all():  # a constant leaf: scale 1, zeros
            np.testing.assert_array_equal(a, b, err_msg=k)
        elif b.size >= 1000:
            assert abs(a.std() / b.std() - 1) <= 0.1, (k, a.std(), b.std())
    if case == "timesformer":
        assert not got["block_0.t_fc.weight"].any()
        assert got["pos_embed"].std() > 0.01 and got["cls_token"].any()


# ---------------------------------------------------------------- attention
def _bwd_inputs(l, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(2, 2, l, 32)).astype(np.float32)
            for _ in range(4)]


@pytest.mark.parametrize("l", [8, 17, 70])
def test_attention_bwd_plain_matches_the_tpu_flash_backward(l):
    """attention_bwd_plain from the plain forward's residuals against
    jax.grad through ``_flash_mha`` (the library Pallas TPU flash kernels,
    forward and backward, in interpret mode) and against torch autograd of
    ``attention_plain``."""
    q, k, v, do = _bwd_inputs(l, l)
    scale = 32 ** -0.5

    def f(q, k, v, do):
        return jnp.sum(jts._flash_mha(q, k, v, scale) * do)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
            *(jnp.asarray(a) for a in (q, k, v, do)))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = kernels.attention_lse_plain(tq, tk, tv, scale)
    got = kernels.attention_bwd_plain(tq, tk, tv, o, lse, tdo, scale)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    (kernels.attention_plain(*leaves, scale) * tdo).sum().backward()
    for g, w, a in zip(got, want, leaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.numpy(), a.grad.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_attention_function_gradient_is_packed_and_plain_on_cpu():
    """``Attention`` on a packed qkv (CPU: the plain forward and backward,
    no launch counted) against autograd of the plain attention, and the
    ``attention`` wrapper under autograd on the CPU: the plain version's
    autograd, with the same gradients."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(3, 17, 3 * 64)).astype(
        np.float32)).requires_grad_(True)
    do = torch.from_numpy(rng.normal(size=(3, 17, 64)).astype(np.float32))
    before = kernels.launch_counts()
    (kernels.Attention.apply(qkv, 2, 0.25) * do).sum().backward()
    assert kernels.launch_counts() == before
    ref = qkv.detach().clone().requires_grad_(True)
    q, k, v = kernels.split_heads(ref, 2)
    out = kernels.attention_plain(q, k, v, 0.25).transpose(1, 2)
    (out.reshape(3, 17, 64) * do).sum().backward()
    np.testing.assert_allclose(qkv.grad.numpy(), ref.grad.numpy(),
                               rtol=1e-5, atol=1e-5)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = kernels.attention(*leaves, 0.25)
    out.transpose(1, 2).reshape(3, 17, 64).mul(do).sum().backward()
    for a, b in zip(leaves, kernels.split_heads(ref.grad, 2)):
        np.testing.assert_allclose(a.grad.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------- train step
def _yaml_cfg(loader, attention_type="divided_space_time", flash="auto"):
    """timesformer.yaml's optimizer and schedule, a narrow model in fp32
    without dropout or stochastic depth."""
    cfg = loader(YAML)
    m = cfg.model
    m.base_model, m.embed_dims, m.num_layers, m.num_heads = "custom", DIM, \
        LAYERS, HEADS
    m.image_size, m.patch_size, m.num_segments = SIZE, PATCH, T
    m.num_class, m.attention_type, m.dtype = NCLS, attention_type, "float32"
    m.dropout, m.drop_path_rate, m.flash_attention = 0.0, 0.0, flash
    cfg.data.batch_size, cfg.data.num_segments = B, T
    return cfg


def _jax_train_step(case, variables, x_u8, y, steps_per_epoch):
    """The body of the JAX trainer's train_step (trainer.py:167-218) with
    the yaml's optimizer, jitted over jax arrays."""
    attention_type, _, flash = case.partition("+")
    jcfg = _yaml_cfg(j_load_config, attention_type)
    model = jts.TimeSformer(num_class=NCLS, num_segments=T, image_size=SIZE,
                            patch_size=PATCH, embed_dims=DIM,
                            num_layers=LAYERS, num_heads=HEADS,
                            attention_type=attention_type, dtype=jnp.float32,
                            flash_attention=bool(flash))
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler, params,
                              steps_per_epoch, jcfg.trainer.max_epochs)

    @jax.jit
    def step(params, opt_state, xb, yb):
        x = j_normalize(xb)

        def loss_fn(p):
            out = model.apply({"params": p}, x, train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)})
            return cross_entropy_loss(out, yb)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), loss

    with pltpu.force_tpu_interpret_mode():
        new_params, loss = step(params, tx.init(params), jnp.asarray(x_u8),
                                jnp.asarray(y))
    return {"params": new_params}, float(loss)


@pytest.mark.parametrize("case", ["divided_space_time",
                                  "divided_space_time+flash",
                                  "joint_space_time", "space_only"])
def test_one_train_step_matches_jax(case):
    """From identical weights and batch, one step of the port's trainer
    (its main path: the spatial attention through ``Attention``) against
    the JAX train step with timesformer.yaml's optimizer (SGD Nesterov,
    wd 1e-4 with the embeddings exempt, clip 40), the JAX model through its
    XLA attention or the Pallas flash kernels (interpret mode)."""
    attention_type = case.partition("+")[0]
    port = _port(attention_type)
    variables = random_flax_variables(port, seed=2)
    rng = np.random.default_rng(3)
    x_u8 = rng.integers(0, 256, (B, T, SIZE, SIZE, 3), dtype=np.uint8)
    y = np.array([1, 4], np.int32)
    want, want_loss = _jax_train_step(case, variables, x_u8, y, 10)

    trainer = Trainer(_yaml_cfg(load_config, attention_type), device="cpu")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(np.asarray, want))
    before = flax_to_port_state(variables)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        if got[k].ndim >= 2:  # every kernel and embedding moved
            assert not np.array_equal(ref[k], before[k]), k


def test_embeddings_are_exempt_from_weight_decay():
    """The yaml's flat SGD: cls/pos/time embeddings in a group without
    weight decay, every other parameter in one with wd 1e-4, Nesterov."""
    cfg = _yaml_cfg(load_config)
    model = _port()
    opt = TrainOptimizer(model, cfg.optimizer, cfg.lr_scheduler, 10, 15,
                         partial_bn=cfg.model.partial_bn,
                         fc_lr5=cfg.model.fc_lr5)
    names = {id(p): n for n, p in model.named_parameters()}
    groups = {g["weight_decay"]: {names[id(p)] for p in g["params"]}
              for g in opt.opt.param_groups}
    assert groups[0.0] == {"cls_token", "pos_embed", "time_embed"}
    assert len(groups[1e-4]) == len(names) - 3
    assert all(g["nesterov"] and g["momentum"] == 0.9
               for g in opt.opt.param_groups)


# ---------------------------------------------------------------- drop path
def test_drop_path_keeps_or_zeroes_whole_rows():
    x = torch.randn(64, 5, 3)
    y = tts.drop_path(x, 0.25, _gen(0))
    kept = (y != 0).flatten(1).any(1)
    assert 0 < int(kept.sum()) < 64
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert not y[~kept].any()


def _bare_block(rate, seed=0, zero=()):
    """A divided block in train mode with stochastic depth at ``rate``;
    the named sub-layers' weights and biases zeroed, so their branches add
    exactly their bias (or nothing)."""
    blk = tts.DividedBlock(DIM, HEADS, flash=True, drop_path=rate)
    load_flax_variables(blk, random_flax_variables(blk, seed=seed))
    with torch.no_grad():
        for name in zero:
            layer = blk.get_submodule(name)
            layer.weight.zero_()
            layer.bias.zero_()
    return blk.train()


def _tokens(seed=1, b=8):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.normal(size=(b, 1, DIM)).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(b, P, T, DIM)).astype(
                np.float32)))


def test_mlp_mask_is_one_per_sample_shared_by_cls_and_patches():
    """Attention branches off (t_fc and s_attn.proj zero): what a block
    adds is the MLP's output, dropped or kept per sample for the cls token
    and the patches alike."""
    blk = _bare_block(0.5, zero=("t_fc", "s_attn.proj"))
    cls, pat = _tokens()
    with torch.no_grad():
        out_cls, out_pat = blk(cls, pat, _gen(3))
    kept_cls = (out_cls != cls).flatten(1).any(1)
    kept_pat = (out_pat != pat).flatten(1).any(1)
    assert torch.equal(kept_cls, kept_pat)
    assert 0 < int(kept_cls.sum()) < len(kept_cls)
    with torch.no_grad():
        full = blk.eval().mlp(blk.mlp_norm(cls))
    torch.testing.assert_close(out_cls[kept_cls] - cls[kept_cls],
                               full[kept_cls] / 0.5, rtol=1e-6, atol=1e-6)


def test_temporal_mask_comes_before_t_fc():
    """Spatial and MLP branches off: a dropped (b, p) row of the temporal
    branch adds t_fc's bias (t_fc of zero), not nothing."""
    blk = _bare_block(0.5, zero=("s_attn.proj", "mlp.fc2"))
    cls, pat = _tokens()
    with torch.no_grad():
        _, out = blk(cls, pat, _gen(4))
        bias = blk.t_fc.bias
    delta = (out - pat).reshape(-1, T, DIM)
    dropped = (delta - bias).abs().amax((1, 2)) < 1e-6
    assert 0 < int(dropped.sum()) < len(dropped)


def test_spatial_mask_covers_the_cls_row_and_the_frame():
    """Temporal and MLP branches off: per (b, t) row the spatial branch is
    kept or dropped for the frame's patches and its cls output alike; the
    cls token gets the mean over frames of the kept rows' outputs."""
    blk = _bare_block(0.5, zero=("t_fc", "mlp.fc2"))
    cls, pat = _tokens()
    b = cls.shape[0]
    with torch.no_grad():
        out_cls, out_pat = blk(cls, pat, _gen(5))
        sp = blk.s_norm(torch.cat(
            [cls[:, None].expand(b, T, 1, DIM).reshape(b * T, 1, DIM),
             pat.transpose(1, 2).reshape(b * T, P, DIM)], dim=1))
        sp = blk.s_attn(sp)  # the branch undropped (no dropout inside)
    delta = (out_pat - pat).transpose(1, 2).reshape(b * T, P, DIM)
    kept = delta.abs().amax((1, 2)) > 0
    assert 0 < int(kept.sum()) < b * T
    assert not delta[~kept].any()
    want = torch.where(kept[:, None], sp[:, 0] / 0.5, 0.0)
    torch.testing.assert_close(out_cls - cls,
                               want.reshape(b, T, DIM).mean(1, keepdim=True),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attention_type", TYPES)
def test_drop_path_rates_are_linspace_from_zero(attention_type):
    model = TimeSformer(NCLS, T, SIZE, PATCH, DIM, 4, HEADS,
                        attention_type=attention_type, drop_path_rate=0.3)
    np.testing.assert_allclose([b.drop_path for b in model.blocks()],
                               [0.0, 0.1, 0.2, 0.3], atol=1e-12)


def test_layer0_is_deterministic_in_train_mode():
    """Layer 0's rate is 0: the first block is the same in train and eval
    mode whatever the generator draws."""
    model = _loaded(drop_path_rate=0.5)
    blk = model.block_0
    cls, pat = _tokens(b=2)
    with torch.no_grad():
        want = blk.eval()(cls, pat)
        got = blk.train()(cls, pat, _gen(6))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_masks_follow_the_generator():
    """The same seed gives identical train-mode logits, another seed (the
    next step) other masks, and eval mode ignores them all."""
    model = _loaded(drop_path_rate=0.5, dropout=0.3).train()
    x = _clips()
    with torch.no_grad():
        a = model(x, dropout_generator=_gen(10))
        b = model(x, dropout_generator=_gen(10))
        c = model(x, dropout_generator=_gen(11))
        model.eval()
        e1 = model(x, dropout_generator=_gen(10))
        e2 = model(x)
    assert torch.equal(a, b) and not torch.equal(a, c)
    plain = _loaded()  # the same weights, no dropout or stochastic depth
    with torch.no_grad():
        ref = plain(x)
    assert torch.equal(e1, e2)
    torch.testing.assert_close(e1, ref, rtol=0, atol=0)


def test_folded_model_is_inference_only():
    model = fold_for_inference(_loaded(drop_path_rate=0.1)).train()
    with pytest.raises(ValueError, match="inference-only"):
        model(_clips(), dropout_generator=_gen(0))


@pytest.mark.parametrize("attention_type", TYPES)
def test_every_parameter_gets_a_gradient(attention_type):
    """Random weights (t_fc non-zero), stochastic depth and dropout on:
    after one backward every parameter has a finite, nonzero gradient."""
    model = _loaded(attention_type=attention_type, drop_path_rate=0.2,
                    dropout=0.1).train()
    logits = model(_clips(), dropout_generator=_gen(0))
    torch.nn.functional.cross_entropy(logits, torch.tensor([0, 3])).backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or not p.grad.abs().max() > 0]
    assert not missing, missing


# ---------------------------------------------------------------- trainer
def _fit_cfg(root, **over):
    cfg = load_config(YAML)
    m = cfg.model
    m.base_model, m.embed_dims, m.num_layers, m.num_heads = "custom", 32, 2, 2
    m.image_size, m.patch_size, m.num_segments = SIZE, 16, T
    m.num_class, m.dtype, m.drop_path_rate = 2, "float32", 0.2
    d = cfg.data
    d.dataset_type, d.image_size, d.num_segments = "DebugDataset", SIZE, T
    d.debug_size, d.debug_num_class, d.batch_size, d.num_workers = 10, 2, 4, 2
    cfg.trainer.default_root_dir = str(root / "runs")
    cfg.trainer.max_epochs = 2
    cfg.trainer.log_every_n_steps = 1
    cfg.log.tensorboard_enable = False
    cfg.callbacks.modelcheckpoint.dirpath = str(root / "ckpt")
    for k, v in over.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    return cfg


def test_fit_checkpoints_and_resumes_bit_identically(tmp_path):
    """A narrow TimeSformer config through ``Trainer.fit`` from the port's
    initializers: 'best' and 'last' checkpoints and the CSV metrics; then a
    run cut after one step and resumed ('auto') ends with the same weights
    as the uninterrupted one, bit for bit (the drop-path masks are a
    function of the seed and the step)."""
    full, history = Trainer(_fit_cfg(tmp_path / "a"), device="cpu").fit()
    assert full.step == 4  # 10 clips at batch 4, tail dropped: 2 x 2 epochs
    ckpt = tmp_path / "a" / "ckpt"
    assert (ckpt / "best").exists() and (ckpt / "last").exists()
    runs = list((tmp_path / "a" / "runs").iterdir())
    text = (runs[0] / "csv" / "metrics.csv").read_text()
    assert "train/loss" in text and "val/acc" in text
    assert 0.0 <= history["best_val_acc"] <= 1.0
    Trainer(_fit_cfg(tmp_path / "b", **{"trainer.max_steps": 1}),
            device="cpu").fit()
    resumed, _ = Trainer(
        _fit_cfg(tmp_path / "b", **{"trainer.resume_from_checkpoint": "auto"}),
        device="cpu").fit()
    assert resumed.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
