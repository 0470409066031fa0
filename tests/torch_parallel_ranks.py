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

import fcntl
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

SIZE, SEG, BATCH = 16, 2, 8
# the dry run's phases on the CPU: DP and FSDP run above
DRYRUN_PHASES = ("serve", "pp", "het-pp", "pp-serve", "slice")


def once_per_run(tmp_path_factory, name, compute, meanwhile=()):
    """``compute()`` once per test run, its result shared by every fixture
    and pytest-xdist worker that needs it (a module-scoped fixture runs
    once per worker that runs one of the module's tests): the first
    computes under a file lock in the run's temporary directory and saves
    the result, the others load it. One that finds the lock taken first
    computes each (name, compute) of ``meanwhile`` that no worker has
    computed or is computing, then waits."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent if run else base  # xdist: the workers' common dir

    def attempt(name, compute, block):
        path = root / f"{name}-{run}.pt"
        with open(root / f"{name}-{run}.lock", "w") as lock:
            try:
                fcntl.flock(lock, fcntl.LOCK_EX | (0 if block else
                                                   fcntl.LOCK_NB))
            except BlockingIOError:
                return None
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


def tiny_cfg(fsdp=False, dropout=0.0, model_axis=1, cls=None):
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

    # the dry run over the same world
    spec = dryrun.DryrunSpec(image_size=SIZE, num_segments=SEG,
                             weights=weights_path, dropout=0.5,
                             video=os.path.join(tmp, "video.npy"),
                             phases=DRYRUN_PHASES, device="cpu")
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
