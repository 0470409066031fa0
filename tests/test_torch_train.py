"""PyTorch port, training path: BatchNorm, gradients, one train step and
the trainer, against the JAX package on the CPU in fp32.

Inputs come from numpy seeds. Tolerances: BN outputs and statistics 1e-6
(one fp32 normalisation, summed in another order); the loss of a train
step 1e-5 and the updated parameters and statistics 1e-4 (a whole
forward, backward and SGD update through either stack, fp32 sums in
different orders).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from test_torch_tsm import randomized_variables
from workoutdetector_tpu.config import Config as JConfig
from workoutdetector_tpu.config import load_config as j_load_config
from workoutdetector_tpu.data.datasets import build_dataset as j_build_dataset
from workoutdetector_tpu.models import TSM as JaxTSM
from workoutdetector_tpu.models.resnet import FrozenAwareBatchNorm
from workoutdetector_tpu.ops.preprocess import normalize_clip as j_normalize
from workoutdetector_tpu.train.optim import build_optimizer as j_build_optimizer
from workoutdetector_tpu.train.trainer import cross_entropy_loss
from workoutdetector_tpu_torch.config import Config, load_config
from workoutdetector_tpu_torch.data.datasets import DebugDataset, build_dataset
from workoutdetector_tpu_torch.data.loader import DataLoader
from workoutdetector_tpu_torch.models import TSM, load_flax_variables
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.models.resnet import BatchNorm
from workoutdetector_tpu_torch.train.trainer import Trainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, SEG, BATCH = 32, 4, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------- BatchNorm

def _bn_pair(frozen: bool, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 5, 4, 8)) * 2 + 0.5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bias = rng.normal(0, 0.1, 8).astype(np.float32)
    mean = rng.normal(0, 0.2, 8).astype(np.float32)
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    bn = BatchNorm(8, frozen=frozen).train()
    with torch.no_grad():
        for t, a in ((bn.weight, scale), (bn.bias, bias),
                     (bn.running_mean, mean), (bn.running_var, var)):
            t.copy_(torch.from_numpy(a))
    jbn = FrozenAwareBatchNorm(momentum=0.9, epsilon=1e-5, frozen=frozen)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": mean, "var": var}}
    want, upd = jbn.apply(variables, jnp.asarray(x), use_running_average=False,
                          mutable=["batch_stats"])
    got = bn(torch.from_numpy(x).requires_grad_(True))
    return got, np.asarray(want), bn, upd.get("batch_stats", {}), mean, var


def test_batchnorm_train_mode_matches_flax():
    """Batch statistics, flax's momentum-0.9 update with the BIASED batch
    variance."""
    got, want, bn, stats, mean0, _ = _bn_pair(frozen=False, seed=0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), rtol=1e-6, atol=1e-6)
    assert not np.allclose(bn.running_mean.numpy(), mean0)  # it did update


def test_frozen_batchnorm_matches_flax_frozen():
    """partial BN: running statistics in train mode, never updated, and a
    gradient still reaches scale and bias."""
    got, want, bn, stats, mean0, var0 = _bn_pair(frozen=True, seed=1)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    for k, a in stats.items():  # flax leaves them as they were
        np.testing.assert_array_equal(np.asarray(a), {"mean": mean0,
                                                      "var": var0}[k])
    np.testing.assert_array_equal(bn.running_mean.numpy(), mean0)
    np.testing.assert_array_equal(bn.running_var.numpy(), var0)
    got.sum().backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None


# ---------------------------------------------------------------- gradients

@pytest.mark.parametrize("base,mode", [("resnet18", "train"),
                                       ("resnet50", "train"),
                                       ("resnet50", "eval")])
def test_every_parameter_gets_a_gradient(base, mode):
    """After one backward every parameter has a finite, nonzero gradient:
    the frozen BN affines too (zeroed only by the optimizer, as in JAX),
    the conv weights behind folded or cached layouts, and everything
    upstream of a shifted conv1 (the shift-matmul site in eval mode)."""
    model = TSM(3, SEG, base, dropout=0.5)
    load_flax_variables(model, random_flax_variables(model, seed=0))
    getattr(model, mode)()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, SEG, SIZE, SIZE, 3)).astype(np.float32))
    logits = model(x, dropout_generator=torch.Generator().manual_seed(0))
    torch.nn.functional.cross_entropy(logits, torch.tensor([0, 2])).backward()
    missing = [n for n, p in model.named_parameters()
               if p.grad is None or not torch.isfinite(p.grad).all()
               or not p.grad.abs().max() > 0]
    assert not missing, missing


# ---------------------------------------------------------------- train step

def _cfg(base: str, cls=Config):
    cfg = cls()
    cfg.model.base_model = base
    cfg.model.num_class = 3
    cfg.model.num_segments = SEG
    cfg.model.dtype = "float32"
    cfg.model.dropout = 0.0
    cfg.model.pallas_conv_bwd = True
    cfg.data.batch_size = BATCH
    return cfg


def _jax_train_step(base, variables, x_u8, y, steps_per_epoch):
    """The body of the JAX trainer's train_step (trainer.py:167-239) over
    TSM(pallas_conv_bwd=True), jitted over jax arrays."""
    jcfg = _cfg(base, JConfig)
    model = JaxTSM(num_class=3, num_segments=SEG, base_model=base,
                   dropout=0.0, dtype=jnp.float32, pallas_conv_bwd=True)
    tx, _ = j_build_optimizer(jcfg.optimizer, jcfg.lr_scheduler,
                              variables["params"], steps_per_epoch,
                              jcfg.trainer.max_epochs, partial_bn=True,
                              fc_lr5=True)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, variables["batch_stats"])

    @jax.jit
    def step(params, stats, opt_state, xb, yb):
        x = j_normalize(xb)

        def loss_fn(p):
            out, upd = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(1)})
            return cross_entropy_loss(out, yb), upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, _ = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss

    with pltpu.force_tpu_interpret_mode():
        new_params, new_stats, loss = step(params, stats, tx.init(params),
                                           jnp.asarray(x_u8), jnp.asarray(y))
    return {"params": new_params, "batch_stats": new_stats}, float(loss)


@pytest.mark.parametrize("base", ["resnet18", "resnet50"])
def test_one_train_step_matches_jax(base):
    """From identical weights and batch, one step of the port's trainer
    against the JAX train step (partial BN, fc_lr5, TSN policies, clip 20,
    SGD momentum; the R50 backward through the 1×1 kernels on both sides,
    Pallas in interpret mode)."""
    kw = dict(num_class=3, num_segments=SEG, base_model=base, dropout=0.0,
              dtype=jnp.float32)
    variables = randomized_variables(
        JaxTSM(**kw), jnp.zeros((1, SEG, SIZE, SIZE, 3), jnp.float32), seed=2)
    rng = np.random.default_rng(3)
    x_u8 = rng.integers(0, 256, (BATCH, SEG, SIZE, SIZE, 3), dtype=np.uint8)
    y = np.array([0, 1, 2, 1], np.int32)
    want, want_loss = _jax_train_step(base, variables, x_u8, y, 10)

    trainer = Trainer(_cfg(base), device="cpu")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    metrics = trainer.train_step(state, x_u8, y)
    assert abs(float(metrics["loss"]) - want_loss) <= 1e-5
    got = {k: v.numpy() for k, v in state.model.state_dict().items()}
    ref = flax_to_port_state(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == ref.keys()
    before = flax_to_port_state(variables)
    for k in got:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)
        if got[k].ndim >= 2 or k.startswith("backbone.bn1."):  # moved
            assert not np.array_equal(ref[k], before[k]), k


# ---------------------------------------------------------------- trainer

def _debug_cfg(root, **over):
    cfg = Config()
    cfg.model.base_model = "resnet18"
    cfg.model.num_class = 2
    cfg.model.num_segments = SEG
    cfg.model.dtype = "float32"
    cfg.data.dataset_type = "DebugDataset"
    cfg.data.image_size = SIZE
    cfg.data.num_segments = SEG
    cfg.data.debug_size = 10
    cfg.data.debug_num_class = 2
    cfg.data.batch_size = 4
    cfg.data.num_workers = 2
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


def test_fit_writes_checkpoints_and_metrics(tmp_path):
    trainer = Trainer(_debug_cfg(tmp_path), device="cpu")
    state, history = trainer.fit()
    assert state.step == 4  # 10 clips at batch 4, tail dropped: 2 x 2 epochs
    ckpt = tmp_path / "ckpt"
    assert (ckpt / "best").exists() and (ckpt / "last").exists()
    assert (ckpt / "best.meta.json").exists()
    runs = list((tmp_path / "runs").iterdir())
    text = (runs[0] / "csv" / "metrics.csv").read_text()
    assert "train/loss" in text and "val/acc" in text and "steps_per_sec" in text
    assert 0.0 <= history["best_val_acc"] <= 1.0


def test_mid_epoch_resume_is_bit_identical(tmp_path):
    """max_steps 1, then resume_from_checkpoint='auto': the final weights
    equal an uninterrupted run's bit for bit."""
    full, _ = Trainer(_debug_cfg(tmp_path / "a"), device="cpu").fit()
    first = _debug_cfg(tmp_path / "b", **{"trainer.max_steps": 1})
    Trainer(first, device="cpu").fit()
    second = _debug_cfg(tmp_path / "b",
                        **{"trainer.resume_from_checkpoint": "auto"})
    resumed, _ = Trainer(second, device="cpu").fit()
    assert resumed.step == full.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_eval_counts_only_real_rows_of_a_padded_tail(tmp_path):
    """10 val clips at batch 4: the tail batch holds 2 real clips and 2 pad
    rows labelled -1, which count in no metric."""
    trainer = Trainer(_debug_cfg(tmp_path), device="cpu")
    state = trainer.init_state(steps_per_epoch=1)
    loader = trainer._loader("val", shuffle=False)
    batches = list(loader)
    assert len(batches) == 3 and (batches[-1][1] == -1).sum() == 2
    val = trainer.evaluate(state, loader)
    assert val["n"] == 10
    m = trainer.eval_step(state, *batches[-1])
    assert int(m["total"]) == 2
    real = trainer.eval_step(state, batches[-1][0][:2], batches[-1][1][:2])
    assert abs(float(m["loss"]) - float(real["loss"])) < 1e-6


def test_repo_yamls_load_and_file_datasets_build(tmp_path):
    """Every YAML of the repo loads into the same config as the JAX
    package's load_config gives. The flagship's FrameDataset is built as
    the JAX build_dataset builds it: a missing list raises the same
    AssertionError, for TDNDataset too; SyntheticPeriodic builds the
    JAX dataset's items; a test split's person crop builds the JAX
    dataset's crop (the motion backend, the yaml's default) and items."""
    configs = os.path.join(REPO, "workoutdetector_tpu", "configs")
    for name in sorted(os.listdir(configs)):
        if name.endswith(".yaml"):
            path = os.path.join(configs, name)
            assert load_config(path).to_dict() == \
                j_load_config(path).to_dict(), name
    cfg = load_config(os.path.join(configs, "repcount_12_tsm.yaml"),
                      ["data.batch_size=8", "optimizer.lr=1e-3"])
    assert (cfg.model.base_model, cfg.data.batch_size, cfg.optimizer.lr) == \
        ("resnet50", 8, 1e-3)
    jcfg = j_load_config(os.path.join(configs, "repcount_12_tsm.yaml"))
    missing = "/nonexistent/Binary/all-train.txt"
    cfg.data.train.anno = jcfg.data.train.anno = missing
    with pytest.raises(AssertionError) as got:
        build_dataset(cfg.data, "train")
    with pytest.raises(AssertionError) as want:
        j_build_dataset(jcfg.data, "train")
    assert str(got.value) == str(want.value) == f"{missing} is not a file"
    tdn = load_config(os.path.join(configs, "tdn.yaml"))
    jtdn = j_load_config(os.path.join(configs, "tdn.yaml"))
    tdn.data.train.anno = jtdn.data.train.anno = missing
    with pytest.raises(AssertionError) as got:
        build_dataset(tdn.data, "train")
    with pytest.raises(AssertionError) as want:
        j_build_dataset(jtdn.data, "train")
    assert str(got.value) == str(want.value) == f"{missing} is not a file"
    synth_opts = ["data.dataset_type=SyntheticPeriodic", "data.image_size=32"]
    synth = load_config(os.path.join(configs, "repcount_12_tsm.yaml"),
                        synth_opts)
    jsynth = j_load_config(os.path.join(configs, "repcount_12_tsm.yaml"),
                           synth_opts)
    got, want = build_dataset(synth.data, "val")[3], \
        j_build_dataset(jsynth.data, "val")[3]
    assert got[1] == want[1] and np.array_equal(got[0], want[0])
    import cv2
    folder = tmp_path / "clip"
    folder.mkdir()
    frames = np.full((6, 48, 64, 3), 30, np.uint8)
    for i in range(6):
        frames[i, 10:40, 8 + 6 * i:20 + 6 * i] = 220
        cv2.imwrite(str(folder / f"img_{i + 1:05}.jpg"), frames[i])
    (tmp_path / "test.txt").write_text("clip 1 6 3\n")
    crop_opts = ["data.test.person_crop=true", f"data.data_root={tmp_path}",
                 f"data.test.anno={tmp_path / 'test.txt'}",
                 "data.test.data_prefix=", "data.image_size=32"]
    crop = load_config(os.path.join(configs, "repcount_12_tsm.yaml"),
                       crop_opts)
    jcrop = j_load_config(os.path.join(configs, "repcount_12_tsm.yaml"),
                          crop_opts)
    got_ds, want_ds = build_dataset(crop.data, "test"), \
        j_build_dataset(jcrop.data, "test")
    assert crop.data.person_backend == "motion"
    assert type(got_ds.transform.person_crop).__name__ == \
        type(want_ds.transform.person_crop).__name__ == "PersonCrop"
    got, want = got_ds[0], want_ds[0]
    assert got[1] == want[1] == 3 and got[0].shape == (8, 32, 32, 3)
    assert np.array_equal(got[0], want[0])


def test_loader_skips_batches_without_changing_them():
    ds = DebugDataset(num_class=3, num_segments=SEG, size=12, image_size=8)
    full = DataLoader(ds, 4, shuffle=True, seed=3, num_workers=2)
    full.set_epoch(1)
    part = DataLoader(ds, 4, shuffle=True, seed=3, num_workers=2)
    part.set_epoch(1, start_batch=1)
    a, b = list(full), list(part)
    assert len(a) == 3 and len(b) == 2
    for (xa, ya), (xb, yb) in zip(a[1:], b):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)


def test_train_tests_the_best_checkpoint(tmp_path):
    from workoutdetector_tpu_torch.train.trainer import train
    history = train(_debug_cfg(tmp_path), device="cpu")
    assert history["test/n"] == 10  # DebugDataset's test split, no pad rows
    assert history["test/acc"] == history["best_val_acc"]  # same data


def test_fast_dev_run_and_accumulation_count_updates(tmp_path):
    fast = Trainer(_debug_cfg(tmp_path / "f", **{"trainer.fast_dev_run": True}),
                   device="cpu")
    state, _ = fast.fit()
    assert state.step == 1
    accum = Trainer(_debug_cfg(tmp_path / "a",
                               **{"trainer.grad_accum_steps": 2}), device="cpu")
    state, _ = accum.fit()
    assert state.step == 4 and state.optimizer.count == 2


def test_early_stopping_on_a_flat_monitor(tmp_path):
    """lr 0 keeps the weights, so val/acc never improves after epoch 0:
    patience 1 stops the run after epoch 1 of 5."""
    cfg = _debug_cfg(tmp_path, **{"trainer.max_epochs": 5,
                                  "optimizer.lr": 0.0,
                                  "callbacks.early_stopping.enable": True,
                                  "callbacks.early_stopping.monitor": "val/acc",
                                  "callbacks.early_stopping.mode": "max",
                                  "callbacks.early_stopping.patience": 1})
    state, _ = Trainer(cfg, device="cpu").fit()
    assert state.step == 4  # 2 epochs of 2 steps
