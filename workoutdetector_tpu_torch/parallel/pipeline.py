"""Pipeline parallelism (pp): GPipe over the mesh's ``model`` axis, point
to point.

Port of ``workoutdetector_tpu/parallel/pipeline.py``. The JAX package
runs the S stages as one SPMD program: a ``lax.scan`` over M + S - 1 ticks
moves microbatches around a ``ppermute`` ring, and heterogeneous stages
ride that ring flattened and zero-padded to one width, dispatched by
``lax.switch``, because one program has one static carry. The port runs
one process per stage rank, so neither is needed: stage s runs only its
own function, receives each microbatch's boundary activation from stage
s - 1 at its own shape and dtype (``Collectives.send``/``recv``: a header,
then the tensors) and sends its output on to stage s + 1. The forward
schedule is GPipe's: every microbatch forward, then (under autograd)
every microbatch backward in reverse order; the (S - 1)/(M + S - 1)
bubble is the same.

Every rank of the mesh calls an entry point with the same GLOBAL input
and gets the same global output: the ``data`` axis splits each
microbatch's rows (dp composes with pp), the last stage's outputs are
gathered over ``data`` and broadcast over ``model``. Under autograd (an
input or a parameter that requires grad) the pipeline is one
``torch.autograd.Function``: every rank then takes the backward of a loss
of the output, the last stage seeds each microbatch's backward with its
rows of the output's gradient, gradients flow back stage by stage, and
the parameter and input gradients are summed over the mesh, so every
rank holds the gradient of the whole, as ``jax.grad`` of the JAX
pipeline returns it. Gradients reach ``params`` and ``x`` only (a stage
function that reads module parameters directly gives them none).

Stage functions take ``(params, activations)``; activations are a tensor
or a tuple of tensors.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from workoutdetector_tpu_torch.parallel.mesh import Mesh

Params = Any  # a (nested) dict of tensors, or None


def _tree_leaves(tree: Params) -> Tuple[List[torch.Tensor], Callable]:
    """(leaves, rebuild) of a nested dict of tensors (None: no leaves)."""
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    keys = list(tree)
    parts = [_tree_leaves(tree[k]) for k in keys]
    sizes = [len(p[0]) for p in parts]

    def rebuild(leaves):
        out, i = {}, 0
        for k, (_, sub), n in zip(keys, parts, sizes):
            out[k] = sub(leaves[i:i + n])
            i += n
        return out

    return [t for p in parts for t in p[0]], rebuild


def _tree_map(fn, *trees):
    if isinstance(trees[0], torch.Tensor):
        return fn(*trees)
    return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}


def stack_stage_params(params: Dict[str, Params],
                       names: Sequence[str]) -> Params:
    """Stack homogeneous per-stage parameter trees (``params[name]`` for
    each name, same keys and shapes) into one tree whose leaves carry a
    leading stage dim: the layout ``pipeline_apply`` takes."""
    return _tree_map(lambda *xs: torch.stack(xs), *[params[n] for n in names])


def _acts(x) -> Tuple[List[torch.Tensor], bool]:
    if isinstance(x, (tuple, list)):
        return list(x), True
    return [x], False


def _pack(leaves: Sequence[torch.Tensor], is_tuple: bool):
    return tuple(leaves) if is_tuple else leaves[0]


class _Schedule:
    """One rank's part of a GPipe run: its stage, its rows of each
    microbatch, its neighbours, and (under autograd) each microbatch's
    inputs and outputs with their graphs."""

    def __init__(self, stage_fns, rebuild, mesh: Mesh, microbatches: int,
                 batch: int, x_tuple: bool, axis: str, data_axis: str):
        self.mesh = mesh
        self.x_tuple = x_tuple
        self.comm = mesh.comm
        self.m = microbatches
        self.n_stages = mesh.size(axis)
        self.s = mesh.coords[axis]
        self.fn = stage_fns[self.s]
        self.rebuild = rebuild
        self.axis, self.data_axis = axis, data_axis
        self.d_size = mesh.size(data_axis)
        self.d = mesh.coords.get(data_axis, 0)
        self.mb = batch // microbatches
        self.mb_loc = self.mb // self.d_size
        self.prev = mesh.rank_at(**{axis: self.s - 1}) if self.s > 0 else None
        self.next = mesh.rank_at(**{axis: self.s + 1}) \
            if self.s < self.n_stages - 1 else None
        self.last = mesh.rank_at(**{axis: self.n_stages - 1})
        self.saved: List[tuple] = []
        self.is_tuple = False
        self.params_graph: List[torch.Tensor] = []

    @property
    def is_last(self) -> bool:
        return self.s == self.n_stages - 1

    def rows(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's rows of microbatch i of a global batch."""
        lo = i * self.mb + self.d * self.mb_loc
        return t[lo:lo + self.mb_loc]

    def forward(self, x: Sequence[torch.Tensor],
                p_leaves: Sequence[torch.Tensor], graph: bool):
        if graph:
            self.params_graph = [p.detach().requires_grad_(p.requires_grad)
                                 for p in p_leaves]
            params = self.rebuild(self.params_graph)
        else:
            params = self.rebuild(list(p_leaves))
        outs, is_tuple = [], False
        for i in range(self.m):
            if self.s == 0:
                inp, in_tuple = [self.rows(t, i) for t in x], self.x_tuple
            else:
                in_tuple, inp = self.comm.recv(self.prev)
                inp = list(inp)
            if graph:
                inp = [t.detach().requires_grad_(t.is_floating_point())
                       for t in inp]
                with torch.enable_grad():
                    y = self.fn(params, _pack(inp, in_tuple))
            else:
                y = self.fn(params, _pack(inp, in_tuple))
            y, is_tuple = _acts(y)
            if graph:
                self.saved.append((inp, y))
            if self.is_last:
                outs.append([t.detach() for t in y])
            else:
                self.comm.send([t.detach() for t in y], self.next,
                               int(is_tuple))
        return self._output(outs, is_tuple)

    def _output(self, outs, is_tuple: bool):
        """The global output on every rank: the last stage's microbatch
        rows gathered over ``data`` in row order, broadcast over
        ``model``."""
        full = None
        if self.is_last:
            full = []
            for j in range(len(outs[0])):
                local = torch.stack([o[j] for o in outs])  # (m, mb_loc, ...)
                if self.d_size > 1:
                    parts = self.comm.all_gather(
                        local, self.mesh.group(self.data_axis))
                    local = torch.stack(parts, dim=1)  # (m, d, mb_loc, ...)
                full.append(local.reshape(self.m * self.mb,
                                          *outs[0][j].shape[1:]))
        if self.n_stages > 1:
            flag, full = self.comm.broadcast_tensors(
                full, int(is_tuple), self.last, self.mesh.group(self.axis))
            is_tuple = bool(flag)
        self.is_tuple = is_tuple
        return list(full), is_tuple

    def backward(self, grad_out: Sequence[Optional[torch.Tensor]],
                 x: Sequence[torch.Tensor]):
        """Every microbatch's backward in reverse order; returns (input
        gradients, parameter gradients), each summed over the mesh."""
        p_grads: List[Optional[torch.Tensor]] = [None] * len(self.params_graph)
        x_rows: List[Optional[List[torch.Tensor]]] = [None] * self.m
        for i in reversed(range(self.m)):
            inp, y = self.saved[i]
            if self.is_last:
                g = [torch.zeros_like(t) if go is None else self.rows(go, i)
                     for t, go in zip(y, grad_out)]
            else:
                g = list(self.comm.recv(self.next)[1])
            pairs = [(t, gi) for t, gi in zip(y, g) if t.requires_grad]
            wrt = [t for t in inp if t.requires_grad] + \
                [p for p in self.params_graph if p.requires_grad]
            grads = torch.autograd.grad(
                [t for t, _ in pairs], wrt,
                [gi.to(t.dtype) for t, gi in pairs],
                allow_unused=True) if pairs and wrt else [None] * len(wrt)
            k = 0
            g_inp = []
            for t in inp:
                if t.requires_grad:
                    g_inp.append(grads[k] if grads[k] is not None
                                 else torch.zeros_like(t))
                    k += 1
                else:
                    g_inp.append(torch.zeros_like(t))
            for j, p in enumerate(self.params_graph):
                if p.requires_grad:
                    gp = grads[k]
                    k += 1
                    if gp is not None:
                        p_grads[j] = gp if p_grads[j] is None \
                            else p_grads[j] + gp
            if self.s > 0:
                self.comm.send(g_inp, self.prev)
            else:
                x_rows[i] = g_inp
        self.saved = []
        # input gradients: stage 0's rows, placed in the global batch
        x_grads = []
        for j, t in enumerate(x):
            if not t.requires_grad:
                x_grads.append(None)
                continue
            full = torch.zeros_like(t)
            if self.s == 0:
                for i in range(self.m):
                    lo = i * self.mb + self.d * self.mb_loc
                    full[lo:lo + self.mb_loc] = x_rows[i][j]
            x_grads.append(self._sum(full))
        params = [None if not p.requires_grad else
                  self._sum(torch.zeros_like(p) if g is None else g)
                  for p, g in zip(self.params_graph, p_grads)]
        return x_grads, params

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the data and model groups (rows and stages are
        disjoint, so the sum is the whole)."""
        for axis, n in ((self.data_axis, self.d_size),
                        (self.axis, self.n_stages)):
            if n > 1:
                self.comm.all_reduce(t, self.mesh.group(axis))
        return t


class _PipelineFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, n_x: int, *tensors):
        x, p = tensors[:n_x], tensors[n_x:]
        outs, _ = sched.forward(x, p, graph=True)
        ctx.sched, ctx.n_x = sched, n_x
        ctx.save_for_backward(*x)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grad_out):
        x = ctx.saved_tensors
        x_grads, p_grads = ctx.sched.backward(grad_out, x)
        return (None, None, *x_grads, *p_grads)


def _run(stage_fns: Sequence[Callable], params: Params, x, mesh: Mesh,
         microbatches: int, axis: str, data_axis: str):
    m = int(microbatches)
    if m < 1:
        raise ValueError("need at least one microbatch")
    leaves, x_tuple = _acts(x)
    b = leaves[0].shape[0]
    if b % m:
        raise ValueError(f"batch {b} not divisible by microbatches={m}")
    d_size = mesh.size(data_axis)
    if (b // m) % d_size:
        raise ValueError(f"microbatch {b // m} not divisible by data axis "
                         f"{d_size}")
    p_leaves, rebuild = _tree_leaves(params)
    sched = _Schedule(stage_fns, rebuild, mesh, m, b, x_tuple, axis,
                      data_axis)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in leaves + p_leaves):
        outs = _PipelineFn.apply(sched, len(leaves), *leaves, *p_leaves)
        return _pack(list(outs), sched.is_tuple)
    outs, is_tuple = sched.forward(leaves, p_leaves, graph=False)
    return _pack(outs, is_tuple)


def pipeline_apply(stage_fn: Callable[[Params, Any], Any],
                   stacked_params: Params, x, mesh: Mesh, microbatches: int,
                   axis: str = "model", data_axis: str = "data"):
    """Run ``x`` through S = ``mesh.size(axis)`` pipelined stages of one
    function: stage s applies ``stage_fn`` to its slice ``[s]`` of
    ``stacked_params`` (``stack_stage_params``). Activations keep their
    structure and shapes from stage to stage; the global batch B splits
    into ``microbatches`` M (B % M == 0, and B / M divisible by the data
    axis). Returns the last stage's output for the whole batch."""
    n = mesh.size(axis)
    fns = [lambda p, a, k=k: stage_fn(_tree_map(lambda v: v[k], p), a)
           for k in range(n)]
    return _run(fns, stacked_params, x, mesh, microbatches, axis, data_axis)


def pipeline_apply_het(stage_fns: Sequence[Callable[[Params, Any], Any]],
                       params: Params, x, mesh: Mesh, microbatches: int,
                       axis: str = "model", data_axis: str = "data"):
    """GPipe over heterogeneous stages: stage s runs ``stage_fns[s]``
    (``(params, act_in) -> act_out``) on the whole ``params``, and
    activation shapes and dtypes may change at every boundary (ResNet
    stages halve the frame and double the channels), each boundary
    travelling at its own. Needs one function per stage rank of ``axis``,
    M ≥ 1 microbatches dividing the batch, and a microbatch that divides
    the data axis, as the JAX function checks."""
    n = mesh.size(axis)
    if len(stage_fns) != n:
        raise ValueError(f"need {n} stages for the {axis}={n} axis, got "
                         f"{len(stage_fns)}")
    return _run(stage_fns, params, x, mesh, microbatches, axis, data_axis)
