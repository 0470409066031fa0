"""A dry run of the parallel paths over whatever world it is given.

The port's counterpart of ``__graft_entry__.dryrun_multichip``'s phases
dp, serve, fsdp, pp, het-pp, pp-serve, slice, sp, ep and composed:
``run(rank, spec)`` runs
on every rank of an initialized process group (``distributed.spawn``
makes one) and returns what each phase gave, for the caller to hold
against its one-process references (``chip_smoke.py`` phase 17 on the
card, ``tests/test_torch_parallel.py`` on the CPU with gloo ranks).

* dp: a data-parallel ``Trainer`` over a (world, 1) mesh: ``steps`` train
  steps and an eval step on one global batch, per dtype of
  ``train_dtypes``;
* fsdp: the same over the same mesh with ``parallel.fsdp`` (each rank
  holds 1/data of every eligible leaf at rest), in the last train dtype;
* serve: an ``InferenceEngine`` over the (world, 1) mesh, per dtype of
  ``serve_dtypes``;
* pp: ``pipeline_apply`` over TimeSformer ``DividedBlock`` stages on a
  (world/2, 2) mesh, with gradients, against the sequential blocks;
* het-pp: ``pipeline_apply_het`` over the TSM's segment ranges at
  ``pp_cuts`` against its one-shot forward;
* pp-serve: the pp-staged engine against the one-shot engine, in the last
  serve dtype;
* model-serve: an engine over the (world/2, 2) mesh, its weights at rest
  over ``model``, per dtype of ``serve_dtypes``;
* slice: a train step over a (2, world/2, 1) hybrid mesh, no leaf sharded
  over ``slice``;
* sp: a TimeSformer (``spec.ts_model``) with ``model.seq_parallel`` over
  the (world/2, 2) mesh: ``ts_steps`` train steps and an eval step per
  dtype of ``ts_dtypes``;
* ep: the same TimeSformer with ``moe_experts = 2·model``, its expert
  stacks sharded over ``model`` at rest and in compute (asserted);
* composed: fsdp + sp + ep at once over the same mesh (needs data > 1),
  with a leaf sharded over both ``data`` and ``model`` (asserted).

The train phases' final states go to ``out_dir`` (``<phase>-<dtype>.pt``,
written by the mesh's first rank, whole); everything else comes back in
the result dict. Launch counts are each phase's own (``kernels``'
counters reset just before the phase's work), reference forwards left
out.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.parallel.distributed import TIMEOUT_S

# how long a rank waits for ``start_file``: a caller may run several
# worlds in turn on the card, each waiting for the one before
START_TIMEOUT_S = 3 * TIMEOUT_S
PHASES = ("dp", "serve", "fsdp", "pp", "het-pp", "pp-serve", "model-serve",
          "slice", "sp", "ep", "composed")
TS_PHASES = ("sp", "ep", "composed")
# the JAX dry run's TimeSformer (``__graft_entry__.py:172-203``)
TS_TINY = dict(model_type="timesformer", base_model="tiny", num_class=2,
               num_segments=4, image_size=32, patch_size=8, embed_dims=32,
               num_layers=1, num_heads=2, dropout=0.0, partial_bn=False)


@dataclass
class DryrunSpec:
    """What every rank of a dry run drives (the same on each)."""
    base_model: str = "resnet18"
    num_class: int = 2
    num_segments: int = 4
    image_size: int = 32
    train_dtypes: Tuple[str, ...] = ("float32",)
    serve_dtypes: Tuple[str, ...] = ("float32",)
    dropout: float = 0.0
    batch: int = 8  # the global train batch
    steps: int = 2
    window_batch: int = 8
    pp_cuts: Tuple[int, ...] = (0, 3, 6)
    pp_microbatches: int = 2
    device: str = "cuda"  # raises without a card; "cpu" by request only
    seed: int = 0
    # flax-layout variable trees (torch.save) every rank loads: the
    # engines' (``weights``) and the trainers' (``train_weights``, default
    # ``weights``); the port's initializers from ``seed`` without one
    weights: Optional[str] = None
    train_weights: Optional[str] = None
    out_dir: Optional[str] = None
    # a (T, H, W, 3) uint8 video (.npy) each serving phase also counts
    video: Optional[str] = None
    phases: Tuple[str, ...] = PHASES
    timed: bool = False  # collectives' own time (device synchronised)
    threads: int = 0  # torch intra-op threads of each rank (0: leave)
    tf32: Optional[bool] = None  # set TF32 for fp32 on the card (None: leave)
    # a file each rank waits for before its first phase (None: start at
    # once), so that a caller sharing the card finishes its own work first
    start_file: Optional[str] = None
    # the TimeSformer phases: a YAML configuration to start from (None:
    # the defaults), cfg.model overrides, global batch, steps, dtypes, and
    # flax-layout trees (torch.save) for the dense model (sp) and the MoE
    # one (ep, composed); the port's initializers from ``seed`` without
    # them
    ts_config_file: Optional[str] = None
    ts_model: Dict[str, Any] = field(default_factory=lambda: dict(TS_TINY))
    ts_batch: int = 8
    ts_steps: int = 1
    ts_dtypes: Tuple[str, ...] = ("float32",)
    ts_weights: Optional[str] = None
    moe_weights: Optional[str] = None
    # per TimeSformer phase, DryrunSpec fields that phase runs with (e.g.
    # {"ep": {"ts_batch": 16}})
    ts_overrides: Dict[str, Dict[str, Any]] = field(default_factory=dict)

    def __post_init__(self):
        self.device = str(resolve_device(self.device))


def train_config(spec: DryrunSpec, dtype: str, fsdp: bool = False):
    """The dry run's training configuration: the TSM of ``spec`` with the
    flagship's optimizer (repcount_12_tsm.yaml: SGD 0.005, momentum 0.9,
    weight decay 5e-4, TSN policies, partial BN, fc_lr5, clip 20) on
    in-memory batches."""
    from workoutdetector_tpu_torch.config import Config

    cfg = Config()
    m, o = cfg.model, cfg.optimizer
    m.model_type, m.base_model, m.num_class = "tsm", spec.base_model, \
        spec.num_class
    m.num_segments, m.dtype, m.dropout = spec.num_segments, dtype, spec.dropout
    m.partial_bn = m.fc_lr5 = True
    o.method, o.lr, o.momentum, o.weight_decay = "sgd", 0.005, 0.9, 5e-4
    o.grad_clip, o.use_tsn_policies = 20.0, True
    cfg.data.image_size = spec.image_size
    cfg.data.num_segments = spec.num_segments
    cfg.data.batch_size = spec.batch
    cfg.parallel.fsdp = fsdp
    cfg.seed = spec.seed
    return cfg


def train_batch(spec: DryrunSpec) -> Tuple[np.ndarray, np.ndarray]:
    """The global train batch, from ``spec.seed``."""
    rng = np.random.default_rng(spec.seed + 100)
    x = rng.integers(0, 256, (spec.batch, spec.num_segments, spec.image_size,
                              spec.image_size, 3), dtype=np.uint8)
    y = rng.integers(0, spec.num_class, (spec.batch,)).astype(np.int32)
    return x, y


def serve_windows(spec: DryrunSpec, n: int) -> np.ndarray:
    """n windows to score (one padded tail chunk where n is not a multiple
    of the window batch), from ``spec.seed``."""
    rng = np.random.default_rng(spec.seed + 200)
    return rng.integers(0, 256, (n, spec.num_segments, spec.image_size,
                                 spec.image_size, 3), dtype=np.uint8)


class Weights:
    """The run's weights, each file read once: the engines' (``serve``)
    and the trainers' (``train``), flax-layout trees; the port's
    initializers from ``spec.seed`` where the spec names no file."""

    def __init__(self, spec: DryrunSpec):
        self.spec = spec
        self._trees: Dict[bool, Any] = {}

    def get(self, model: torch.nn.Module, train: bool = False):
        from workoutdetector_tpu_torch.models.convert import \
            init_flax_variables
        spec = self.spec
        if train not in self._trees:
            path = spec.train_weights if train and spec.train_weights \
                else spec.weights
            self._trees[train] = torch.load(path, weights_only=False) \
                if path is not None else init_flax_variables(model, spec.seed)
        return self._trees[train]


def eval_model(spec: DryrunSpec, dtype: str, weights: Weights):
    """The TSM of ``spec`` in eval mode with the engines' weights."""
    from workoutdetector_tpu_torch.models import load_flax_variables
    from workoutdetector_tpu_torch.models.factory import (build_model,
                                                          kernels_for)

    cfg = train_config(spec, dtype)
    model = build_model(cfg.model, kernels_for(spec.device, dtype))
    load_flax_variables(model, weights.get(model))
    return model.to(spec.device).eval()


def _sync(spec: DryrunSpec) -> None:
    if spec.device == "cuda":
        torch.cuda.synchronize()


def _reset(spec: DryrunSpec, mesh) -> None:
    from workoutdetector_tpu_torch.ops import kernels
    _sync(spec)
    kernels.reset_launches()
    mesh.comm.reset()
    mesh.comm.timed = spec.timed


def _counts(spec: DryrunSpec, mesh, seconds: float) -> Dict[str, Any]:
    from workoutdetector_tpu_torch.ops import kernels
    return {"launches": kernels.launch_counts(), "seconds": seconds,
            "collective_seconds": mesh.comm.seconds,
            "collective_calls": dict(mesh.comm.calls),
            "transports": mesh.comm.transports()}


def train_phase(spec: DryrunSpec, mesh, dtype: str, fsdp: bool,
                name: str, weights: Weights) -> Dict[str, Any]:
    """``steps`` train steps and an eval step of the global batch."""
    from workoutdetector_tpu_torch.train.trainer import Trainer

    t_init = time.perf_counter()
    trainer = Trainer(train_config(spec, dtype, fsdp), mesh,
                      device=spec.device)
    state = trainer.init_state(steps_per_epoch=10,
                               variables=weights.get(trainer.model, True))
    x, y = train_batch(spec)
    _reset(spec, mesh)
    t0 = time.perf_counter()
    init_s = t0 - t_init
    losses = [float(trainer.train_step(state, x, y)["loss"])
              for _ in range(spec.steps)]
    _sync(spec)
    out = _counts(spec, mesh, time.perf_counter() - t0)
    ev = trainer.eval_step(state, x, y)
    full = state.state_dict()
    if spec.out_dir is not None and mesh.is_main:
        torch.save(full, os.path.join(spec.out_dir, f"{name}-{dtype}.pt"))
    layout = state.layout
    out.update(losses=losses, eval={k: float(v) for k, v in ev.items()},
               held={n: f for n, f in layout.held_fraction().items()},
               specs={n: s for n, s in layout.specs.items()},
               steps_per_s=spec.steps / out["seconds"], init_seconds=init_s)
    return out


def serve_phase(spec: DryrunSpec, mesh, pp: bool, dtype: str,
                weights: Weights) -> Dict[str, Any]:
    """Logits of ``window_batch`` + 3 windows (a padded tail chunk) from an
    engine over ``mesh`` (pp-staged at ``pp_cuts`` with ``pp``), beside
    the one-shot engine's on this rank; with ``video``, its count by
    ``count_by_video_model`` beside the one-shot engine's, the launches of
    that count, and both engines' state sequences (``state_runs``)."""
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_video_model)

    model = eval_model(spec, dtype, weights)
    kw = dict(num_segments=spec.num_segments, window_batch=spec.window_batch,
              image_size=spec.image_size)
    one = InferenceEngine(model, device=spec.device, **kw)
    eng = InferenceEngine(model, mesh=mesh, **kw,
                          pp_cuts=spec.pp_cuts if pp else None,
                          pp_microbatches=spec.pp_microbatches)
    windows = serve_windows(spec, spec.window_batch + 3)
    ref = one.score_windows(windows)
    eng.score_windows(windows[:spec.window_batch])  # warm-up
    _reset(spec, mesh)
    t0 = time.perf_counter()
    logits = eng.score_windows(windows)
    _sync(spec)
    out = _counts(spec, mesh, time.perf_counter() - t0)
    out.update(logits=logits, ref=ref,
               max_abs_err=float(np.abs(logits - ref).max()),
               held=eng.layout.held_fraction() if eng.layout else {})
    if spec.video is not None:
        video = np.load(spec.video)
        out["ref_count"] = count_by_video_model(one, video)
        _reset(spec, mesh)
        out["count"] = count_by_video_model(eng, video)
        out["video_launches"] = _counts(spec, mesh, 0.0)["launches"]
        out["states"], out["ref_states"] = state_runs(model, eng, one, video)
    return out


COUNT_BLOCK = 4  # windows a head bias holds for (``state_runs``)


def state_runs(model, eng, one, video: np.ndarray):
    """The argmax sequences of ``eng`` and ``one`` over the video's
    consecutive 8-frame windows (``count_by_video_model``'s) with the head
    made to walk through the states: random weights give every window one
    argmax, so the windows go in blocks of ``COUNT_BLOCK`` and block k's
    head bias takes the one-shot engine's mean logit off every class and
    adds twice its largest deviation + 1 to class k mod C. The margin
    outweighs any rounding, so two engines computing the same function
    give the same sequence, and a count of several reps."""
    n = len(video) // 8
    windows = one.gather_windows(video, np.arange(0, n * 8, 8), stride=1)
    base = one.score_windows(windows)
    center = base.mean(0)
    boost = 2 * float(np.abs(base - center).max()) + 1.0
    # the heads the engines score with (a model-sharded engine's is its
    # own copy's; the bias is never sharded over model)
    heads = {id(e.model.fc): e.model.fc for e in (eng, one)}
    orig = model.fc.bias.detach().clone()
    seqs = ([], [])
    try:
        for k in range(0, n, COUNT_BLOCK):
            shift = -center.copy()
            shift[(k // COUNT_BLOCK) % len(shift)] += boost
            for fc in heads.values():
                fc.bias.data = orig + torch.from_numpy(shift).to(orig)
            for seq, e in zip(seqs, (eng, one)):
                seq.append(e.score_windows(windows[k:k + COUNT_BLOCK])
                           .argmax(-1))
    finally:
        for fc in heads.values():
            fc.bias.data = orig.clone()
    return tuple(np.concatenate(s) for s in seqs)


def pp_phase(spec: DryrunSpec, mesh) -> Dict[str, Any]:
    """``pipeline_apply`` over one TimeSformer ``DividedBlock`` per stage
    (tuple activations), forward and gradients, against the sequential
    blocks on this rank: the largest forward gap, and the largest
    gradient gap over the largest gradient."""
    from workoutdetector_tpu_torch.models import load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.models.timesformer import DividedBlock
    from workoutdetector_tpu_torch.parallel.pipeline import (
        pipeline_apply, stack_stage_params)

    d, heads, p, t = 16, 2, 8, spec.num_segments
    n = mesh.size("model")
    block = DividedBlock(d, heads).to(spec.device)
    params = {}
    for i in range(n):
        load_flax_variables(block, random_flax_variables(block, seed=20 + i))
        params[f"block_{i}"] = {k: v.detach().clone()
                                for k, v in block.state_dict().items()}
    rng = np.random.default_rng(spec.seed + 300)
    b = 2 * mesh.size("data") * spec.pp_microbatches
    cls_tok = torch.from_numpy(rng.standard_normal((b, 1, d)).astype(
        np.float32)).to(spec.device)
    patches = torch.from_numpy(rng.standard_normal((b, p, t, d)).astype(
        np.float32)).to(spec.device)

    def stage(pr, act):
        return torch.func.functional_call(block, pr, act)

    names = [f"block_{i}" for i in range(n)]
    stacked = {k: v.requires_grad_(True) for k, v in
               stack_stage_params(params, names).items()}
    out_c, out_p = pipeline_apply(stage, stacked, (cls_tok, patches), mesh,
                                  spec.pp_microbatches)
    (out_c.square().sum() + out_p.square().sum()).backward()  # every rank
    seq = {k: v.detach().clone().requires_grad_(True)
           for k, v in stacked.items()}
    c, q = cls_tok, patches
    for i in range(n):
        c, q = stage({k: v[i] for k, v in seq.items()}, (c, q))
    (c.square().sum() + q.square().sum()).backward()
    scale = max(float(v.grad.abs().max()) for v in seq.values())
    return {"forward_err": max(float((out_c - c).detach().abs().max()),
                               float((out_p - q).detach().abs().max())),
            "grad_err": max(float((stacked[k].grad - seq[k].grad).abs().max())
                            for k in seq) / scale}


def het_pp_phase(spec: DryrunSpec, mesh, weights: Weights) -> Dict[str, Any]:
    """``pipeline_apply_het`` over the TSM's segment ranges at ``pp_cuts``
    against its one-shot forward on this rank."""
    from workoutdetector_tpu_torch.parallel.pipeline import pipeline_apply_het

    model = eval_model(spec, spec.serve_dtypes[-1], weights)
    cuts = spec.pp_cuts
    fns = [lambda _, a, lo=lo, hi=hi: model(a, seg_lo=lo, seg_hi=hi)
           for lo, hi in zip(cuts[:-1], cuts[1:])]
    rng = np.random.default_rng(spec.seed + 400)
    b = 2 * mesh.size("data") * spec.pp_microbatches
    x = torch.from_numpy(rng.standard_normal(
        (b, spec.num_segments, spec.image_size, spec.image_size, 3)).astype(
            np.float32)).to(spec.device)
    with torch.no_grad():
        ref = model(x)
        out = pipeline_apply_het(fns, None, x, mesh, spec.pp_microbatches)
    return {"max_abs_err": float((out - ref).abs().max()),
            "shape": tuple(out.shape)}


def slice_phase(spec: DryrunSpec, mesh, weights: Weights) -> Dict[str, Any]:
    """One train step over the hybrid mesh."""
    from workoutdetector_tpu_torch.train.trainer import Trainer

    dtype = spec.train_dtypes[-1]
    trainer = Trainer(train_config(spec, dtype), mesh, device=spec.device)
    state = trainer.init_state(steps_per_epoch=10,
                               variables=weights.get(trainer.model, True))
    on_slice = [n for n, s in state.layout.specs.items() if "slice" in s]
    if on_slice:
        raise AssertionError(f"leaves sharded over slice: {on_slice}")
    x, y = train_batch(spec)
    loss = float(trainer.train_step(state, x, y)["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite hybrid-mesh loss {loss}")
    return {"loss": loss, "mesh": dict(mesh.shape)}


def ts_config(spec: DryrunSpec, phase: str, dtype: str, model_axis: int,
              experts: Optional[int] = None):
    """The TimeSformer phases' configuration (the JAX dry run's: the
    config's defaults, or ``ts_config_file``, and ``spec.ts_model``):
    ``seq_parallel`` for sp and composed, ``moe_experts`` (``experts``,
    else ``ts_model``'s, else ``2·model``) for ep and composed, FSDP for
    composed."""
    from workoutdetector_tpu_torch.config import Config, load_config

    cfg = load_config(spec.ts_config_file) if spec.ts_config_file \
        else Config()
    for k, v in spec.ts_model.items():
        setattr(cfg.model, k, v)
    cfg.model.dtype = dtype
    cfg.model.seq_parallel = phase in ("sp", "composed")
    if phase in ("ep", "composed"):
        cfg.model.moe_experts = experts or \
            spec.ts_model.get("moe_experts") or 2 * model_axis
    else:
        cfg.model.moe_experts = 0
    cfg.data.image_size = cfg.model.image_size
    cfg.data.num_segments = cfg.model.num_segments
    cfg.data.batch_size = spec.ts_batch
    cfg.parallel.model_axis = model_axis
    cfg.parallel.fsdp = phase == "composed"
    cfg.seed = spec.seed
    return cfg


def ts_batch(spec: DryrunSpec) -> Tuple[np.ndarray, np.ndarray]:
    """The TimeSformer phases' global batch, from ``spec.seed``."""
    m = ts_config(spec, "dp", "float32", 1).model
    rng = np.random.default_rng(spec.seed + 500)
    n, t, size = spec.ts_batch, m.num_segments, m.image_size
    x = rng.integers(0, 256, (n, t, size, size, 3), dtype=np.uint8)
    y = rng.integers(0, m.num_class, (n,)).astype(np.int32)
    return x, y


def _peak_reset(spec: DryrunSpec) -> None:
    if spec.device == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(spec: DryrunSpec) -> Optional[int]:
    return torch.cuda.max_memory_allocated() if spec.device == "cuda" \
        else None


def ts_phase(spec: DryrunSpec, mesh, phase: str, dtype: str
             ) -> Dict[str, Any]:
    """``ts_steps`` train steps and an eval step of the global batch of
    the phase's TimeSformer over ``mesh``: the losses,
    launches, collectives (each operation's calls, bytes and seconds),
    peak memory, the MoE tokens each step dropped, the experts each rank
    holds and the rows of the spatial attention's launches (b·T/m frames
    under sp); the final state whole to ``out_dir``
    (``<phase>-<dtype>.pt``)."""
    from workoutdetector_tpu_torch.models.convert import \
        init_flax_variables
    from workoutdetector_tpu_torch.models.moe import pop_drops
    from workoutdetector_tpu_torch.train.trainer import Trainer

    m = mesh.size("model")
    t_init = time.perf_counter()
    cfg = ts_config(spec, phase, dtype, m)
    trainer = Trainer(cfg, mesh, device=spec.device)
    model = trainer.model
    path = spec.moe_weights if cfg.model.moe_experts else spec.ts_weights
    variables = torch.load(path, weights_only=False) if path is not None \
        else init_flax_variables(model, spec.seed)
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    layout = state.layout
    out: Dict[str, Any] = {"sp_applied": model.sp_applied}
    if cfg.model.seq_parallel and not model.sp_applied:
        raise AssertionError(f"{phase}: sequence parallelism not applied "
                             f"on {mesh}")
    if cfg.model.moe_experts:
        e = cfg.model.moe_experts
        rest = layout.shards["block_0.mlp.w1"].shape[0]
        layout.materialize()  # the weights as the forward sees them
        compute = model.block_0.mlp.w1.shape[0]
        layout.release()
        if rest * m != e or compute * m != e:
            raise AssertionError(f"{phase}: a rank holds {rest} experts at "
                                 f"rest and {compute} in compute, not "
                                 f"{e // m} of {e}")
        out["experts_held"] = {"rest": rest, "compute": compute}
    if phase == "composed" and not any(
            "data" in sp and "model" in sp for sp in layout.specs.values()):
        raise AssertionError("composed: no leaf sharded over data and model")
    x, y = ts_batch(spec)
    rows = []
    hook = model.block_0.s_attn.register_forward_hook(
        lambda mod, args, res: rows.append(args[0].shape[0]))
    pop_drops(model)
    _reset(spec, mesh)
    _peak_reset(spec)
    t0 = time.perf_counter()
    init_s = t0 - t_init
    losses, dropped = [], []
    for _ in range(spec.ts_steps):
        losses.append(float(trainer.train_step(state, x, y)["loss"]))
        dropped.append(pop_drops(model))
    _sync(spec)
    hook.remove()
    out.update(_counts(spec, mesh, time.perf_counter() - t0))
    out.update(losses=losses, init_seconds=init_s,
               steps_per_s=spec.ts_steps / out["seconds"],
               collective_bytes=dict(mesh.comm.bytes),
               collective_op_seconds=dict(mesh.comm.op_seconds),
               peak_bytes=_peak(spec), dropped=dropped,
               attention_rows=rows[0], model_split=trainer.model_split,
               held=layout.held_fraction())
    out["eval"] = {k: float(v) for k, v in
                   trainer.eval_step(state, x, y).items()}
    full = state.model_state()
    if spec.out_dir is not None and mesh.is_main:
        torch.save(full, os.path.join(spec.out_dir, f"{phase}-{dtype}.pt"))
    return out


def wait_for(path: str, timeout_s: float = TIMEOUT_S) -> None:
    """Return once ``path`` exists; TimeoutError after ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout_s:.0f} s")
        time.sleep(0.05)


def run(rank: int, spec: DryrunSpec) -> Dict[str, Any]:
    """Every phase of ``spec.phases`` the world's size allows, on this
    rank; {phase: result}. Every rank of the world calls it."""
    from workoutdetector_tpu_torch.parallel.mesh import create_mesh

    resolve_device(spec.device)
    if spec.start_file is not None:
        wait_for(spec.start_file, START_TIMEOUT_S)
    if spec.threads:
        torch.set_num_threads(spec.threads)
    if spec.tf32 is not None:
        torch.backends.cuda.matmul.allow_tf32 = spec.tf32
        torch.backends.cudnn.allow_tf32 = spec.tf32
    world = dist.get_world_size()
    out: Dict[str, Any] = {"rank": rank, "world": world}
    dp_mesh = create_mesh(model=1, device=spec.device)
    pp_mesh = create_mesh(model=2, device=spec.device) \
        if world % 2 == 0 else None
    weights = Weights(spec)
    for phase in spec.phases:
        t0 = time.perf_counter()
        if phase == "dp":
            for dtype in spec.train_dtypes:
                out[f"dp-{dtype}"] = train_phase(spec, dp_mesh, dtype, False,
                                                 phase, weights)
        elif phase == "fsdp":
            if world == 1:
                continue
            dtype = spec.train_dtypes[-1]
            out[f"fsdp-{dtype}"] = train_phase(spec, dp_mesh, dtype, True,
                                               phase, weights)
        elif phase == "serve":
            for dtype in spec.serve_dtypes:
                out[f"serve-{dtype}"] = serve_phase(spec, dp_mesh, False,
                                                    dtype, weights)
        elif pp_mesh is None:
            continue
        elif phase == "pp":
            out[phase] = pp_phase(spec, pp_mesh)
        elif phase == "het-pp":
            out[phase] = het_pp_phase(spec, pp_mesh, weights)
        elif phase == "pp-serve":
            dtype = spec.serve_dtypes[-1]
            out[f"pp-serve-{dtype}"] = serve_phase(spec, pp_mesh, True, dtype,
                                                   weights)
        elif phase == "model-serve":
            for dtype in spec.serve_dtypes:
                out[f"model-serve-{dtype}"] = serve_phase(
                    spec, pp_mesh, False, dtype, weights)
        elif phase == "slice":
            out[phase] = slice_phase(spec, create_mesh(
                slices=2, model=1, device=spec.device), weights)
        elif phase in TS_PHASES:
            if phase == "composed" and pp_mesh.size("data") == 1:
                continue
            ps = replace(spec, **spec.ts_overrides.get(phase, {}))
            for dtype in ps.ts_dtypes:
                out[f"{phase}-{dtype}"] = ts_phase(ps, pp_mesh, phase, dtype)
        else:
            raise ValueError(f"unknown dry-run phase {phase!r}")
        out.setdefault("phase_seconds", {})[phase] = time.perf_counter() - t0
    return out
