"""The parallel tests' shared computations, each once per test run
(``once_per_run``: the pytest-xdist workers that run a file share its
result): for ``test_torch_parallel.py`` a world of 4 gloo ranks on the CPU
(``torch_parallel_ranks.parallel_world``) and, meanwhile in this process,
the JAX mesh step and the port's one-process steps; for
``test_torch_pipeline.py`` a world of 2 (``pipeline_world``) and the JAX
pipelines. Weights are carried to both sides through files the ranks load
(``load_flax_variables``).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tsm import randomized_variables
from torch_parallel_ranks import (DIMS, SEG, SIZE, batch, close_ratio,
                                  dense_inputs, dense_stack, digest,
                                  het_stack, once_per_run, parallel_world,
                                  pipeline_world, save_tree, tiny_cfg,
                                  tsm_batch)
from workoutdetector_tpu.config import Config as JConfig
from workoutdetector_tpu.infer.engine import InferenceEngine as JEngine
from workoutdetector_tpu.models.tdn import TDN as JaxTDN
from workoutdetector_tpu.models.tsm import TSM as JaxTSM
from workoutdetector_tpu.parallel.mesh import create_mesh as j_create_mesh
from workoutdetector_tpu.parallel.mesh import shard_batch as j_shard_batch
from workoutdetector_tpu.parallel.pipeline import (pipeline_apply,
                                                   pipeline_apply_het,
                                                   stack_stage_params)
from workoutdetector_tpu.train.trainer import Trainer as JTrainer
from workoutdetector_tpu_torch.models import TDN
from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                      random_flax_variables)
from workoutdetector_tpu_torch.parallel import dryrun
from workoutdetector_tpu_torch.parallel.distributed import spawn
from workoutdetector_tpu_torch.train.trainer import Trainer


def _jax_run(variables):
    """JAX ``Trainer(cfg, mesh=create_mesh(model=1))`` from the carried
    weights: a step on batch 0, a step on batch 1, an eval of batch 0."""
    mesh = j_create_mesh(model=1)
    tr = JTrainer(tiny_cfg(cls=JConfig), mesh=mesh)
    carried = jax.tree_util.tree_map(jnp.asarray, variables)
    with pytest.MonkeyPatch.context() as mp:  # the flax init, carried
        mp.setattr(JaxTSM, "init", lambda self, *a, **k: carried)
        st = tr.init_state(steps_per_epoch=2, image_size=SIZE)
    step = tr.train_step_fn()
    losses = []
    for seed in (0, 1):
        st, m = step(st, *j_shard_batch(batch(seed), mesh))
        losses.append(float(m["loss"]))
    ev = tr.eval_step_fn()(st, *j_shard_batch(batch(0), mesh))
    tree = jax.tree_util.tree_map(np.asarray, {"params": st.params,
                                               "batch_stats": st.batch_stats})
    return {"losses": losses, "eval": {k: float(v) for k, v in ev.items()},
            "state": flax_to_port_state(tree)}


def _port_one_process(variables, path):
    """The port's one-process references: a dropout-0.5 step on batch 0,
    and the dry run's hybrid-mesh train step."""
    tr = Trainer(tiny_cfg(dropout=0.5), device="cpu")
    st = tr.init_state(steps_per_epoch=2, variables=variables)
    loss = float(tr.train_step(st, *batch(0))["loss"])
    out = {"dropout": {"loss": loss, "state": {
        k: v.numpy().copy() for k, v in st.model.state_dict().items()}}}
    spec = dryrun.DryrunSpec(image_size=SIZE, num_segments=SEG,
                             weights=path, dropout=0.5, device="cpu")
    tr = Trainer(dryrun.train_config(spec, "float32"), device="cpu")
    st = tr.init_state(steps_per_epoch=10, variables=variables)
    x, y = dryrun.train_batch(spec)
    out["dryrun"] = float(tr.train_step(st, x, y)["loss"])
    return out


def _mesh(data, model):
    return j_create_mesh(devices=jax.devices()[:data * model], data=data,
                         model=model)


def _dense(p, a):
    return jnp.tanh(a @ p["kernel"] + p["bias"])


def _jax_refs(tsm_vars, tdn_vars):
    out = {}
    line = _mesh(1, 2)
    stacked = stack_stage_params(
        jax.tree_util.tree_map(jnp.asarray, dense_stack(2, 16, 0)),
        ["block_0", "block_1"])
    x = jnp.asarray(dense_inputs(1, 8, 16))
    # each output comes with its gradients from one compiled program
    for name, m in (("dense_m2", 2), ("dense_m4", 4)):
        def loss(st, m=m):
            y = pipeline_apply(_dense, st, x, line, m)
            return jnp.sum(y ** 2), y

        (_, y), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(stacked)
        out[name] = {"y": np.asarray(y),
                     "grads": jax.tree_util.tree_map(np.asarray, g)}

    params = jax.tree_util.tree_map(jnp.asarray, het_stack(0))
    fns = [lambda p, a, i=i: _dense(p[f"s{i}"], a)
           for i in range(len(DIMS) - 1)]
    x = jnp.asarray(dense_inputs(0, 8, DIMS[0]))

    def het_loss(p, v):
        y = pipeline_apply_het(fns, p, v, line, 2)
        return jnp.sum(y ** 2), y

    (_, y), (g, gx) = jax.jit(jax.value_and_grad(
        het_loss, argnums=(0, 1), has_aux=True))(params, x)
    out["het_dense"] = {"y": np.asarray(y),
                        "grads": jax.tree_util.tree_map(np.asarray, g),
                        "x_grad": np.asarray(gx)}

    model = JaxTSM(num_class=3, num_segments=SEG, base_model="resnet18",
                   dropout=0.0, dtype=jnp.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tsm_vars["params"])
    stats = jax.tree_util.tree_map(jnp.asarray, tsm_vars["batch_stats"])

    def seg(lo, hi):
        return lambda p, a: model.apply({"params": p, "batch_stats": stats},
                                        a, train=False, seg_lo=lo, seg_hi=hi)

    fns = [seg(0, 3), seg(3, 6)]
    x = jnp.asarray(tsm_batch(1))
    onehot = jax.nn.one_hot(jnp.arange(8) % 3, 3)

    def tsm_loss(p):
        logits = pipeline_apply_het(fns, p, x, line, 2)
        return -jnp.mean(jnp.sum(jax.nn.log_softmax(logits) * onehot, -1)), \
            logits

    g, logits = jax.jit(jax.grad(tsm_loss, has_aux=True))(params)
    out["tsm"] = {"logits": np.asarray(logits), "grads": flax_to_port_state(
        {"params": jax.tree_util.tree_map(np.asarray, g)})}

    tdn = JaxTDN(num_class=3, num_segments=SEG, base_model="resnet50",
                 dropout=0.0, dtype=jnp.float32)
    bursts = jnp.asarray(np.random.default_rng(5).normal(
        size=(4, SEG, 5, SIZE, SIZE, 3)).astype(np.float32))
    out["tdn"] = np.asarray(jax.jit(lambda v, a: tdn.apply(v, a, train=False))(
        jax.tree_util.tree_map(jnp.asarray, tdn_vars), bursts))

    errors = {}
    mesh = j_create_mesh(devices=jax.devices()[:8], data=4, model=2)
    kw = dict(num_segments=4, window_batch=8, image_size=32)
    for name, ekw in (("mesh", dict(pp_cuts=[0, 3, 6])),
                      ("stages", dict(mesh=mesh, pp_cuts=[0, 2, 4, 6])),
                      ("microbatches", dict(mesh=mesh, pp_cuts=[0, 3, 6],
                                            pp_microbatches=3)),
                      ("data", dict(mesh=mesh, pp_cuts=[0, 3, 6],
                                    window_batch=4, pp_microbatches=2))):
        with pytest.raises(AssertionError) as exc:
            JEngine(model, tsm_vars, **dict(kw, **ekw))
        errors[name] = str(exc.value)
    out["errors"] = errors
    return out


def _shapes(tree):
    """The shape of every leaf of a nested dict of arrays."""
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


def parallel_results(tmp_path_factory):
    """``test_torch_parallel.py``'s rank results and references."""
    parallel, pipeline = _computations(tmp_path_factory)
    return once_per_run(tmp_path_factory, *parallel, meanwhile=[pipeline])


def pipeline_results(tmp_path_factory):
    """``test_torch_pipeline.py``'s rank results and references."""
    parallel, pipeline = _computations(tmp_path_factory)
    return once_per_run(tmp_path_factory, *pipeline, meanwhile=[parallel])


def _computations(tmp_path_factory):
    """The two files' (name, compute): a worker that waits for one
    computes the other meanwhile (``once_per_run``)."""
    parallel = ("torch_parallel", lambda: _compute_parallel(tmp_path_factory))
    pipeline = ("torch_pipeline", lambda: _compute_pipeline(tmp_path_factory))
    return parallel, pipeline


def _beside(world, size, args, refs):
    """(the ranks' results of ``spawn(world, size, args)``, ``refs()``),
    the two computed at once: the world in a thread, ``refs`` here."""
    spawned = {}

    def run():
        try:
            spawned["ranks"] = spawn(world, size, args, device="cpu",
                                     timeout_s=600)
        except RuntimeError as exc:
            spawned["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        out = refs()
    finally:
        thread.join()
    if "error" in spawned:
        raise spawned["error"]
    return spawned["ranks"], out


def _tsm_variables(num_class, seed):
    return randomized_variables(
        JaxTSM(num_class=num_class, num_segments=SEG, base_model="resnet18",
               dropout=0.0, dtype=jnp.float32),
        jnp.zeros((1, SEG, SIZE, SIZE, 3), jnp.float32), seed=seed)


def _compute_parallel(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    variables = _tsm_variables(2, 4)
    path = str(tmp / "variables.pt")
    save_tree(variables, path)
    np.save(tmp / "video.npy", np.random.default_rng(6).integers(
        0, 256, (48, SIZE, SIZE, 3), dtype=np.uint8))

    def refs():
        # the port's one-process steps (torch, one thread) in a thread,
        # the JAX mesh step (XLA's threads) here
        out = {}

        def port():
            try:
                out["one"] = _port_one_process(variables, path)
            except Exception as exc:  # raised below
                out["error"] = exc

        thread = threading.Thread(target=port)
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        thread.start()
        try:
            out["jax"] = _jax_run(variables)
        finally:
            thread.join()
            torch.set_num_threads(n_threads)
        if "error" in out:
            raise out.pop("error")
        return out

    ranks, refs = _beside(parallel_world, 4, (path, str(tmp)), refs)
    # the whole-model arrays are held to their references here, and their
    # ratios (``close_ratio``) and hashes kept: the shared result stays small
    dp, dropout = ranks[0]["dp"], ranks[0]["dropout"]
    checks = {
        "dp_vs_jax": close_ratio(dp["state"], refs["jax"].pop("state"),
                                 1e-4, 1e-4),
        "dropout_vs_one": close_ratio(
            dropout["state"], refs["one"]["dropout"].pop("state"), 1e-6,
            1e-6)}
    for arrays in (dp, dropout):
        arrays["state"] = digest(arrays["state"])
    return dict(refs, ranks=ranks, shapes=_shapes(variables), checks=checks)


def _compute_pipeline(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    tsm_vars = _tsm_variables(3, 5)
    tdn_vars = random_flax_variables(TDN(3, SEG), seed=11)
    paths = (str(tmp / "tsm.pt"), str(tmp / "tdn.pt"))
    for tree, p in ((tsm_vars, paths[0]), (tdn_vars, paths[1])):
        save_tree(tree, p)
    ranks, refs = _beside(pipeline_world, 2, paths,
                          lambda: _jax_refs(tsm_vars, tdn_vars))
    checks = {"tsm_grads_vs_jax": close_ratio(
        ranks[0]["tsm"]["grads"], refs["tsm"].pop("grads"), 1e-4, 1e-5)}
    ranks[0]["tsm"]["grads"] = digest(ranks[0]["tsm"]["grads"])
    return {"jax": refs, "ranks": ranks, "checks": checks}
