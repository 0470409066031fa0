"""Rank functions of the port's parallel tests (``test_torch_parallel.py``,
``test_torch_pipeline.py``).

``parallel_world`` runs on every rank of a world of 4 gloo processes on
the CPU and ``pipeline_world`` on every rank of a world of 2, each started
by ``parallel.distributed.spawn`` once per test run (``once_per_run``);
they return numpy arrays and numbers for the test process to hold against
the JAX package (``torch_parallel_refs``). This module imports no jax, so
that a spawned rank starts with torch alone.
"""

from __future__ import annotations

import faulthandler
import fcntl
import hashlib
import os
import signal
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

SIZE, SEG, BATCH = 16, 2, 8
# the dry run's phases on the CPU: DP and FSDP run above
DRYRUN_PHASES = ("serve", "pp", "het-pp", "pp-serve", "model-serve",
                 "slice", "sp", "ep", "composed")
# TimeSformer DP with dropout and stochastic depth (held to one process)
TS_DROPOUT = dict(dropout=0.3, drop_path_rate=0.2)
MOE_EXPERTS = 4  # the MoE TimeSformer's experts, as the dry run's (2, 2) ep


# about three times the slowest shared computation (the 4-rank world and
# its references, ≈ 58 s in one worker): a worker that waits longer for
# another's fails, and does not hold the run's clock
WAIT_S = 180.0


def once_per_run(tmp_path_factory, name, compute, meanwhile=()):
    """``compute()`` once per test run, its result shared by every fixture
    and pytest-xdist worker that needs it (a module-scoped fixture runs
    once per worker that runs one of the module's tests): the first
    computes under a file lock in the run's temporary directory and saves
    the result, the others load it. One that finds the lock taken first
    computes each (name, compute) of ``meanwhile`` that no worker has
    computed or is computing, then waits, for ``WAIT_S`` seconds at most
    (then RuntimeError)."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent if run else base  # xdist: the workers' common dir

    def attempt(name, compute, block):
        path = root / f"{name}-{run}.pt"
        with open(root / f"{name}-{run}.lock", "w") as lock:
            deadline = time.monotonic() + WAIT_S
            while True:
                try:
                    fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
                    break
                except BlockingIOError:
                    if not block:
                        return None
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"{name}: the worker computing it did not finish "
                            f"in {WAIT_S:.0f} s (its own failure, if any, "
                            "is in its tests' report)")
                    time.sleep(0.2)
            if path.exists():
                return torch.load(path, weights_only=False)
            result = compute()
            torch.save(result, path)
            return result

    result = attempt(name, compute, block=False)
    if result is None:
        for other in meanwhile:
            try:
                attempt(*other, block=False)
            except Exception:  # left unsaved: its own tests redo and report it
                pass
        result = attempt(name, compute, block=True)
    return result


def logged(rank, log_dir, fn, *args):
    """``fn(rank, *args)`` with this rank's stdout and stderr (file
    descriptors too) in ``<log_dir>/rank<rank>.log``, and its threads'
    Python stacks written there when it is stopped by SIGTERM (as
    ``spawn`` stops the ranks of a world past its time), so that a hung
    world fails with what each rank was doing (``rank_logs``)."""
    log = open(os.path.join(log_dir, f"rank{rank}.log"), "w")
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    faulthandler.register(signal.SIGTERM, file=log, all_threads=True,
                          chain=True)
    return fn(rank, *args)


def rank_logs(log_dir, size: int, tail: int = 4000) -> str:
    """The end of each rank's ``logged`` output."""
    out = []
    for r in range(size):
        path = os.path.join(log_dir, f"rank{r}.log")
        text = open(path).read()[-tail:] if os.path.exists(path) else \
            "(no log)"
        out.append(f"--- rank {r} ---\n{text}")
    return "\n".join(out)


def save_tree(tree, path):
    """``torch.save`` of a nested dict of numpy arrays with the arrays as
    tensors, which load many times faster; ``load_flax_variables`` takes
    either."""
    def tensors(t):
        return {k: tensors(v) if isinstance(v, dict) else
                torch.from_numpy(np.ascontiguousarray(v))
                for k, v in t.items()}
    torch.save(tensors(tree), path)


def load_arrays(path):
    """A {name: array} dict that ``save_tree`` wrote."""
    return {k: v.numpy() for k, v in torch.load(path).items()}


def tiny_cfg(fsdp=False, dropout=0.0, model_axis=1, cls=None, remat=False):
    """TSM-R18 at 16², 2 segments, 2 classes, fp32: the JAX
    ``tests/test_fsdp.py`` configuration (``cls``: the config class, the
    port's by default)."""
    if cls is None:
        from workoutdetector_tpu_torch.config import Config as cls

    cfg = cls()
    cfg.model.model_type = "tsm"
    cfg.model.base_model = "resnet18"
    cfg.model.num_class = 2
    cfg.model.num_segments = SEG
    cfg.model.dropout = dropout
    cfg.model.dtype = "float32"
    cfg.data.image_size = SIZE
    cfg.data.num_segments = SEG
    cfg.data.batch_size = BATCH
    cfg.parallel.fsdp = fsdp
    cfg.parallel.model_axis = model_axis
    if remat:
        cfg.model.remat = True
    return cfg


def remat_runs(variables):
    """One train-mode forward and backward of TSM-R18 with every BN live,
    without and with ``remat``, on one process: the largest gap of the
    logits, of every gradient and of every buffer (the running
    statistics) between the two, and whether the statistics moved."""
    from workoutdetector_tpu_torch.models import TSM, load_flax_variables

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, SEG, SIZE, SIZE, 3)).astype(np.float32))
    runs = []
    for remat in (False, True):
        model = TSM(2, SEG, "resnet18", dropout=0.0, partial_bn=False,
                    remat=remat)
        load_flax_variables(model, variables)
        model.train()
        logits = model(x)
        logits.square().sum().backward()
        runs.append({"logits": {"": logits.detach().numpy()},
                     "grads": {n: p.grad.numpy()
                               for n, p in model.named_parameters()},
                     "buffers": {n: b.numpy().copy()
                                 for n, b in model.named_buffers()}})
    base, rem = runs
    gaps = {kind: max(float(np.abs(rem[kind][n] - base[kind][n]).max())
                      for n in base[kind]) for kind in base}
    gaps["moved"] = any(base["buffers"][n].any() for n in base["buffers"]
                        if n.endswith("running_mean"))
    return gaps


def ts_spec(tmp, **kw):
    """The dry run's TimeSformer phases on the CPU, their weights (dense
    and MoE flax trees) and final states in ``tmp``."""
    from workoutdetector_tpu_torch.parallel import dryrun
    return dryrun.DryrunSpec(device="cpu", out_dir=tmp,
                             ts_weights=os.path.join(tmp, "ts_dense.pt"),
                             moe_weights=os.path.join(tmp, "ts_moe.pt"), **kw)


def ts_dp_config(spec, moe):
    """The dry run's TimeSformer on a (2, 1) data pair: the MoE one with
    ``MOE_EXPERTS`` experts, or the dense one with ``TS_DROPOUT``."""
    from workoutdetector_tpu_torch.parallel import dryrun
    if moe:
        return dryrun.ts_config(spec, "ep", "float32", 1, MOE_EXPERTS)
    cfg = dryrun.ts_config(spec, "dp", "float32", 1)
    for k, v in TS_DROPOUT.items():
        setattr(cfg.model, k, v)
    return cfg


def batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (BATCH, SEG, SIZE, SIZE, 3), dtype=np.uint8)
    y = rng.integers(0, 2, (BATCH,)).astype(np.int32)
    return x, y


def _state(state):
    return {k: v.numpy().copy() for k, v in state.model_state().items()}


def digest(arrays) -> str:
    """A hash of a {name: array} dict's bytes, to tell exact copies."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def close_ratio(got, want, rtol, atol):
    """(max |got − want| / (atol + rtol·|want|) over every array, the array
    where it is): a ratio ≤ 1 is ``np.testing.assert_allclose``'s pass."""
    assert got.keys() == want.keys()
    return max((float(np.max(np.abs(got[k] - want[k])
                             / (atol + rtol * np.abs(want[k])))), k)
               for k in want)


def _one_copy(rank, first, arrays):
    """The arrays on ``first`` (the test holds them to their reference),
    their hash on the other ranks (held equal to ``first``'s)."""
    return arrays if rank == first else digest(arrays)


def _watch_step(trainer, state, b):
    """One more step, a watch step, on ``b``: its labels and norms, and the
    float64 norms of the whole parameters after it (the gathered state) in
    its order."""
    metrics = trainer.train_step(state, *b, watch=True)
    whole = _state(state)
    return {"labels": trainer.param_leaf_paths(state),
            "grad": metrics["watch_grad_leaf_norms"].numpy(),
            "param": metrics["watch_param_leaf_norms"].numpy(),
            "whole": np.array([np.linalg.norm(whole[k].astype(np.float64))
                               for _, k in trainer._watch_leaves(state)])}


def _eval(trainer, state, b):
    return {k: float(v) for k, v in trainer.eval_step(state, *b).items()}


# (flax-layout shape, whether the port holds it as a transposed kernel)
SPEC_SHAPES = [((3, 3, 64, 128), True), ((7, 7, 3, 64), True),
               ((1, 1, 256, 64), True), ((512, 64), True), ((512, 12), True),
               ((2048, 12), True), ((64,), True), ((8,), True),
               ((1024,), True), ((4, 16, 32), False), ((8, 64, 256), False),
               ((4, 256), False), ((1, 197, 768), False)]
SPEC_MESHES = [dict(data=4, model=1), dict(data=2, model=2),
               dict(data=1, model=4), dict(slices=2, data=1, model=2)]


def port_shape(shape, kernel):
    from workoutdetector_tpu_torch.parallel.mesh import _FLAX_ORDER
    order = _FLAX_ORDER.get(len(shape)) if kernel else None
    if not order:
        return tuple(shape)
    port = [0] * len(shape)
    for i, d in enumerate(order):
        port[d] = shape[i]
    return tuple(port)


def parallel_world(rank, weights_path, tmp):
    """``test_torch_parallel.py``'s world of 4 ranks: the DP, FSDP, elastic
    and dropout runs, the spec table, the batch shards, global-batch
    BatchNorm and the dry run. Returns this rank's results."""
    from workoutdetector_tpu_torch.models import TSM, load_flax_variables
    from workoutdetector_tpu_torch.models.resnet import BatchNorm
    from workoutdetector_tpu_torch.parallel import dryrun
    from workoutdetector_tpu_torch.parallel.mesh import (create_mesh,
                                                         host_batch_shard,
                                                         param_spec,
                                                         state_sharding)
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager
    from workoutdetector_tpu_torch.train.trainer import Trainer

    torch.set_num_threads(1)
    variables = torch.load(weights_path, weights_only=False)
    b1, b2 = batch(0), batch(1)
    # every rank makes every mesh's groups, in one order
    pair_a = create_mesh(model=1, device="cpu", ranks=[0, 1])
    pair_b = create_mesh(model=1, device="cpu", ranks=[2, 3])
    model_pair = create_mesh(data=1, model=2, device="cpu", ranks=[2, 3])
    grid = create_mesh(model=2, device="cpu")
    spec_meshes = [create_mesh(device="cpu", **kw) for kw in SPEC_MESHES]
    out = {"rank": rank}

    # the spec table and the batch shards, on every rank
    out["specs"] = [[[param_spec(port_shape(s, k), m, fsdp_axis=f,
                                 kernel=k) for s, k in SPEC_SHAPES]
                     for f in (None, "data")] for m in spec_meshes]
    out["host_shards"] = [host_batch_shard(m) for m in spec_meshes]
    out["model_specs"] = state_sharding(
        TSM(2, SEG, "resnet18"), spec_meshes[1], fsdp=True)

    # global-batch BatchNorm over ranks 0 and 1: rows 3r..3r+3 of 6
    if rank < 2:
        rng = np.random.default_rng(7)
        x = torch.from_numpy((rng.standard_normal((6, 5, 8)) * 2 + 0.5)
                             .astype(np.float32))[3 * rank:3 * rank + 3]
        x.requires_grad_(True)
        w = torch.from_numpy(rng.standard_normal((3, 5, 8)).astype(np.float32))
        bn = BatchNorm(8).train()
        bn.sync = pair_a.batch_sum
        y = bn(x)
        (y * w).sum().backward()
        out["bn"] = {"y": y.detach().numpy(), "x_grad": x.grad.numpy(),
                     "w_grad": bn.weight.grad.numpy(),
                     "b_grad": bn.bias.grad.numpy(),
                     "mean": bn.running_mean.numpy(),
                     "var": bn.running_var.numpy()}

    # DP on ranks 0-1 (step, save, step, eval), FSDP on ranks 2-3
    ckpt_dir = os.path.join(tmp, "ckpt")
    if rank < 2:
        tr = Trainer(tiny_cfg(), pair_a, device="cpu")
        st = tr.init_state(steps_per_epoch=2, variables=variables)
        first = float(tr.train_step(st, *b1)["loss"])
        CheckpointManager(ckpt_dir, pair_a).save(st, "elastic",
                                                 meta={"step": 1})
        second = float(tr.train_step(st, *b2)["loss"])
        dp_state = _state(st)
        if rank == 0:  # the others hold their runs to it
            save_tree(dp_state, os.path.join(tmp, "dp_state.pt"))
        out["dp"] = {"losses": [first, second], "eval": _eval(tr, st, b1),
                     "state": _one_copy(rank, 0, dp_state)}
        out["dp"]["watch"] = _watch_step(tr, st, b1)
    else:
        tr = Trainer(tiny_cfg(fsdp=True), pair_b, device="cpu")
        st = tr.init_state(steps_per_epoch=2, variables=variables)
        warm = tr.eval_step(st, *b1)  # fills the folded-weight caches
        losses = [float(tr.train_step(st, *b)["loss"]) for b in (b1, b2)]
        # the engine over the trained model against a fresh copy
        from workoutdetector_tpu_torch.infer import InferenceEngine
        fresh = TSM(2, SEG, "resnet18")
        fresh.load_state_dict(st.model_state())
        st.layout.materialize()
        engine = InferenceEngine(tr.model, SEG, 4, SIZE, device="cpu")
        logits = engine.score_windows(b1[0])
        st.layout.release()
        ref = InferenceEngine(fresh, SEG, 4, SIZE, device="cpu")
        fsdp_state = _state(st)
        out["fsdp"] = {"losses": losses, "eval": _eval(tr, st, b1),
                       "warm_eval": float(warm["loss"]),
                       "held": st.layout.held_fraction(),
                       "engine": logits,
                       "engine_ref": ref.score_windows(b1[0])}
        out["fsdp"]["watch"] = _watch_step(tr, st, b1)
    dist.barrier()
    dp_state = load_arrays(os.path.join(tmp, "dp_state.pt"))
    if rank >= 2:
        out["fsdp"]["state_vs_dp"] = close_ratio(fsdp_state, dp_state,
                                                 1e-6, 1e-6)

    # dropout 0.5 DP on ranks 0-1; elastic resume at (1, 2) + FSDP on 2-3
    if rank < 2:
        tr = Trainer(tiny_cfg(dropout=0.5), pair_a, device="cpu")
        st = tr.init_state(steps_per_epoch=2, variables=variables)
        out["dropout"] = {"loss": float(tr.train_step(st, *b1)["loss"]),
                          "state": _one_copy(rank, 0, _state(st))}
    else:
        tr = Trainer(tiny_cfg(fsdp=True, model_axis=2), model_pair,
                     device="cpu")
        st = tr.init_state(steps_per_epoch=2, variables=variables)
        st, meta = CheckpointManager(ckpt_dir, model_pair).restore(
            "elastic", st)
        out["elastic"] = {"meta": meta, "held": st.layout.held_fraction(),
                          "loss": float(tr.train_step(st, *b2)["loss"])}
        out["elastic"]["state_vs_dp"] = close_ratio(_state(st), dp_state,
                                                    1e-4, 1e-4)
    dist.barrier()

    # FSDP over the whole (2, 2) world
    tr = Trainer(tiny_cfg(fsdp=True, model_axis=2), grid, device="cpu")
    st = tr.init_state(steps_per_epoch=2, variables=variables)
    held = st.layout.held_fraction()
    losses = [float(tr.train_step(st, *b)["loss"]) for b in (b1, b2)]
    out["grid"] = {"losses": losses, "eval": _eval(tr, st, b1), "held": held,
                   "specs": st.layout.specs,
                   "state_vs_dp": close_ratio(_state(st), dp_state, 1e-6,
                                              1e-6)}

    # a MoE TimeSformer over the data pair (ranks 0-1), its routing group
    # the global batch; TimeSformer DP with dropout and stochastic depth
    # (ranks 2-3); the TSM with every BN live, without remat (0-1) and
    # with it (2-3)
    from workoutdetector_tpu_torch.models.moe import pop_drops
    tspec = ts_spec(tmp)
    tb = dryrun.ts_batch(tspec)
    live = tiny_cfg(remat=rank >= 2)
    live.model.partial_bn = False
    if rank < 2:
        tr = Trainer(ts_dp_config(tspec, True), pair_a, device="cpu")
        st = tr.init_state(steps_per_epoch=10,
                           variables=torch.load(tspec.moe_weights))
        pop_drops(tr.model)
        loss = float(tr.train_step(st, *tb)["loss"])
        out["moe_dp"] = {"loss": loss, "dropped": pop_drops(tr.model),
                         "state": _one_copy(rank, 0, _state(st))}
    else:
        tr = Trainer(ts_dp_config(tspec, False), pair_b, device="cpu")
        st = tr.init_state(steps_per_epoch=10,
                           variables=torch.load(tspec.ts_weights))
        out["ts_dropout"] = {"loss": float(tr.train_step(st, *tb)["loss"]),
                             "state": _one_copy(rank, 2, _state(st))}
    tr = Trainer(live, pair_a if rank < 2 else pair_b, device="cpu")
    st = tr.init_state(steps_per_epoch=2, variables=variables)
    live_losses = [float(tr.train_step(st, *b)["loss"]) for b in (b1, b2)]
    if rank == 0:
        save_tree(_state(st), os.path.join(tmp, "live_state.pt"))
    dist.barrier()
    if rank >= 2:
        out["remat"] = {"losses": live_losses, "state_vs_live": close_ratio(
            _state(st), load_arrays(os.path.join(tmp, "live_state.pt")),
            1e-6, 1e-6)}
    else:
        out["live_losses"] = live_losses
    if rank == 3:
        out["remat_unit"] = remat_runs(variables)

    # the dry run over the same world
    spec = ts_spec(tmp, image_size=SIZE, num_segments=SEG,
                   weights=weights_path, dropout=0.5,
                   video=os.path.join(tmp, "video.npy"),
                   phases=DRYRUN_PHASES)
    out["dryrun"] = dryrun.run(rank, spec)
    return out


# ---------------------------------------------------------------- pipeline

DIMS = [16, 24, 6]  # the ragged widths of the heterogeneous stack


def dense_stack(n_stages, dim, seed):
    """Per-stage tanh(x W + b) parameters (numpy), W (dim, dim)."""
    rng = np.random.default_rng(seed)
    return {f"block_{i}": {
        "kernel": rng.normal(0, dim ** -0.5, (dim, dim)).astype(np.float32),
        "bias": rng.normal(0, 0.1, (dim,)).astype(np.float32)}
        for i in range(n_stages)}


def het_stack(seed):
    rng = np.random.default_rng(seed)
    return {f"s{i}": {
        "kernel": rng.normal(0, DIMS[i] ** -0.5,
                             (DIMS[i], DIMS[i + 1])).astype(np.float32),
        "bias": rng.normal(0, 0.1, (DIMS[i + 1],)).astype(np.float32)}
        for i in range(len(DIMS) - 1)}


def dense_inputs(seed, b, dim):
    return np.random.default_rng(seed).normal(size=(b, dim)).astype(
        np.float32)


def _tensors(tree, grad=False):
    return {k: _tensors(v, grad) if isinstance(v, dict) else
            torch.from_numpy(v).requires_grad_(grad) for k, v in tree.items()}


def _grads(tree):
    return {k: _grads(v) if isinstance(v, dict) else v.grad.numpy()
            for k, v in tree.items()}


def _dense(p, a):
    return torch.tanh(a @ p["kernel"] + p["bias"])


def tsm_batch(seed):
    return np.random.default_rng(seed).normal(
        size=(8, SEG, SIZE, SIZE, 3)).astype(np.float32)


def pipeline_world(rank, tsm_path, tdn_path):
    """``test_torch_pipeline.py``'s world of 2 ranks, one stage each of
    ``line`` (data 1, model 2; ``column`` the same ranks as data 2):
    ``pipeline_apply`` and ``pipeline_apply_het`` with gradients, TSM-R18
    and TDN stages, the pp-staged and data-sharded engines and the
    validation errors. (The dry run in ``parallel_world`` composes
    pipelines with the data axis on 4 ranks.)"""
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (TDN, TSM,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.parallel.mesh import create_mesh
    from workoutdetector_tpu_torch.parallel.pipeline import (
        pipeline_apply, pipeline_apply_het, stack_stage_params)

    torch.set_num_threads(1)
    line = create_mesh(data=1, model=2, device="cpu")
    column = create_mesh(model=1, device="cpu")
    out = {"rank": rank}

    # homogeneous dense stages, 2 and 4 microbatches
    for name, m in (("dense_m2", 2), ("dense_m4", 4)):
        stacked = stack_stage_params(_tensors(dense_stack(2, 16, 0)),
                                     ["block_0", "block_1"])
        stacked = {k: v.requires_grad_(True) for k, v in stacked.items()}
        x = torch.from_numpy(dense_inputs(1, 8, 16))
        y = pipeline_apply(_dense, stacked, x, line, m)
        y.square().sum().backward()
        out[name] = {"y": y.detach().numpy(),
                     "grads": {k: v.grad.numpy() for k, v in stacked.items()}}

    # ragged widths 16→24→6, its input's gradient too
    params = _tensors(het_stack(0), grad=True)
    n = len(DIMS) - 1
    fns = [lambda p, a, i=i: _dense(p[f"s{i}"], a) for i in range(n)]
    x = torch.from_numpy(dense_inputs(0, 8, DIMS[0])).requires_grad_(True)
    y4 = pipeline_apply_het(fns, params, x, line, 4)
    y2 = pipeline_apply_het(fns, params, x, line, 2)
    y2.square().sum().backward()
    out["het_dense"] = {"y4": y4.detach().numpy(), "y2": y2.detach().numpy(),
                        "grads": _grads(params), "x_grad": x.grad.numpy()}

    # TSM-R18 cut at layer2|layer3, gradients of a CE
    model = TSM(3, SEG, "resnet18", dropout=0.0)
    load_flax_variables(model, torch.load(tsm_path, weights_only=False))
    model.eval()
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in model.named_parameters()}

    def seg(lo, hi):
        return lambda p, a: torch.func.functional_call(
            model, p, (a,), {"seg_lo": lo, "seg_hi": hi})

    x = torch.from_numpy(tsm_batch(1))
    logits = pipeline_apply_het([seg(0, 3), seg(3, 6)], params, x, line, 2)
    onehot = torch.nn.functional.one_hot(torch.arange(8) % 3, 3).float()
    loss = -(torch.log_softmax(logits, -1) * onehot).sum(-1).mean()
    loss.backward()
    out["tsm"] = {"logits": logits.detach().numpy(),
                  "grads": _one_copy(rank, 0, {k: v.grad.numpy()
                                               for k, v in params.items()})}

    # TDN: stems + layer1 | layer2-4 + head
    tdn = TDN(3, SEG)
    load_flax_variables(tdn, torch.load(tdn_path, weights_only=False))
    tdn.eval()
    bursts = torch.from_numpy(np.random.default_rng(5).normal(
        size=(4, SEG, 5, SIZE, SIZE, 3)).astype(np.float32))
    with torch.no_grad():
        staged = pipeline_apply_het(
            [lambda _, a: tdn(a, seg_lo=0, seg_hi=2),
             lambda _, a: tdn(a, seg_lo=2, seg_hi=5)], None, bursts, line, 2)
    out["tdn"] = staged.numpy()

    # engines: pp-staged over 2 stages, data-sharded over 2 ranks
    windows = np.random.default_rng(9).integers(
        0, 256, (11, SEG, SIZE, SIZE, 3), dtype=np.uint8)
    kw = dict(num_segments=SEG, window_batch=8, image_size=SIZE)
    eng = {"one_shot": InferenceEngine(model, device="cpu", **kw),
           "pp": InferenceEngine(model, mesh=line, pp_cuts=[0, 3, 6], **kw),
           "pp_m4": InferenceEngine(model, mesh=line, pp_cuts=[0, 2, 6],
                                    pp_microbatches=4, **kw),
           "sharded": InferenceEngine(model, mesh=column, **kw)}
    out["engines"] = {k: e.score_windows(windows) for k, e in eng.items()}
    out["gather"] = {k: e.supports_device_gather for k, e in eng.items()}
    errors = {}
    for name, ekw in (("mesh", dict(pp_cuts=[0, 3, 6])),
                      ("stages", dict(mesh=line, pp_cuts=[0, 2, 4, 6])),
                      ("microbatches", dict(mesh=line, pp_cuts=[0, 3, 6],
                                            pp_microbatches=3)),
                      ("data", dict(mesh=column, pp_cuts=[0, 6],
                                    window_batch=4, pp_microbatches=4))):
        try:
            InferenceEngine(model, **dict(kw, device="cpu", **ekw))
        except ValueError as exc:
            errors[name] = str(exc)
    for name, call in (
            ("batch", lambda: pipeline_apply_het(
                fns, params, torch.zeros(5, 16), line, 2)),
            ("count", lambda: pipeline_apply_het(
                fns[:1], params, torch.zeros(4, 16), line, 2))):
        try:
            call()
        except ValueError as exc:
            errors[name] = str(exc)
    out["errors"] = errors
    return out
