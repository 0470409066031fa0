"""Rank meshes, batch placement and the sharded layout of trainer state.

Port of ``workoutdetector_tpu/parallel/mesh.py``. The JAX package lays one
SPMD program over a ``Mesh`` of devices with the axes ``("data",
"model")`` (``("slice", "data", "model")`` with ``slices > 1``) and XLA
inserts the collectives. The port runs one process per rank: ``Mesh`` is
a ``torch.distributed.device_mesh.DeviceMesh`` over those ranks with the
same axes, plus the groups and collectives (``comm``) the parallel paths
run by hand.

* Batches: every rank of an entry point takes the same GLOBAL batch and
  works on its rows: the ``dp_size`` data-parallel ways (slice × data)
  each hold one contiguous block (``batch_sharding``, ``shard_batch``);
  ranks that differ only on ``model`` hold the same rows. Loaders read
  only their block (``host_batch_shard``).
* State: ``param_spec`` is the JAX package's shape rule applied to the
  port's layouts — a conv weight OIHW (the JAX HWIO: ``model`` shards O,
  FSDP shards I), a ``Dense`` weight (out, in) (the JAX (in, out):
  ``model`` shards in, FSDP shards out), 3-D expert stacks and 1-D vectors
  as in JAX — with the same ``min_per_shard`` and nothing ever sharded
  over ``slice``. ``StateLayout`` holds each rank's shard of every such
  leaf (parameters and BatchNorm statistics) at rest, gathers the full
  weights into the model before compute and releases them after, so each
  rank holds the fraction of every leaf the JAX layout gives it; the
  optimizer's momenta live on the shards. A leaf that the model
  computes on in blocks (``compute_sharded``: a MoE's expert stacks under
  expert parallelism, each ``model`` rank holding and computing its own
  experts) is gathered only over its other axes, and the model holds its
  block in compute too.
* Sequences: ``seq_constrain`` is the JAX package's guard on a token
  layout — a token dim shards over ``model`` only where ``model``
  divides it — and ``SeqGroup`` the ``model`` group that a
  sequence-parallel model splits its token dims over, with the
  differentiable all-to-all and sum it moves them with.
"""

from __future__ import annotations

from collections import deque
from typing import (Any, Dict, Iterable, Iterator, Mapping, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from workoutdetector_tpu_torch.device import resolve_device
from workoutdetector_tpu_torch.parallel.distributed import (Collectives,
                                                            all_to_all,
                                                            group_sum)

Spec = Tuple[Optional[str], ...]  # per dim: the axis that shards it, or None


class Mesh:
    """A grid of ranks with named axes over ``torch.distributed``.

    ``shape`` maps each axis to its size in axis order, as a JAX mesh's
    does; ``coords`` maps it to this rank's coordinate (None for a rank of
    the world outside the mesh, ``member`` False). ``group(axis)`` is the
    process group of the ranks that differ from this one only on ``axis``;
    ``dp_group`` spans the data-parallel ways (slice × data) that share
    this rank's ``model`` coordinate; ``all_group`` spans the mesh.
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device: torch.device):
        from torch.distributed.device_mesh import DeviceMesh

        self.axis_names = tuple(axis_names)
        self.ranks = np.asarray(ranks)
        self.shape = {a: int(n) for a, n in zip(self.axis_names,
                                                  self.ranks.shape)}
        self.device = device
        self.backend = dist.get_backend()
        self.comm = Collectives(self.backend, device)
        # every rank of the world takes part in making each subgroup
        self.device_mesh = DeviceMesh(device.type, torch.from_numpy(
            self.ranks.astype(np.int64)), mesh_dim_names=self.axis_names)
        coord = self.device_mesh.get_coordinate()
        self.member = coord is not None
        self.coords = dict(zip(self.axis_names, coord)) \
            if self.member else None
        flat = sorted(int(r) for r in self.ranks.flat)
        self.all_group = dist.group.WORLD \
            if flat == list(range(dist.get_world_size())) \
            else dist.new_group(flat)
        self.dp_group = None
        if "slice" in self.axis_names:
            # the slice × data ranks of each model coordinate
            for m in range(self.shape["model"]):
                ranks_m = sorted(int(r) for r in self.ranks[..., m].flat)
                g = dist.new_group(ranks_m)
                if self.member and self.coords["model"] == m:
                    self.dp_group = g
        elif self.member:
            self.dp_group = self.device_mesh.get_group("data")

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def group(self, axis: str):
        return self.device_mesh.get_group(axis)

    def rank_at(self, **coords: int) -> int:
        """Global rank at this rank's coordinates with ``coords`` replaced."""
        c = dict(self.coords, **coords)
        return int(self.ranks[tuple(c[a] for a in self.axis_names)])

    @property
    def dp_index(self) -> int:
        """This rank's data-parallel way: slice-major over slice × data."""
        return self.coords.get("slice", 0) * self.size("data") + \
            self.coords["data"]

    @property
    def is_main(self) -> bool:
        """The mesh's first rank: the one that writes logs and files."""
        return self.member and dist.get_rank() == int(self.ranks.flat[0])

    def barrier(self) -> None:
        dist.barrier(group=self.all_group)

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Differentiable sum of ``t`` over the data-parallel ways: the
        hook of global-batch BatchNorm (``models/resnet.set_batch_sync``)."""
        return group_sum(t, self.comm, self.dp_group)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.backend}, {self.device})"


def create_mesh(data: int = -1, model: int = 1, slices: int = 1,
                axis_names: Sequence[str] = ("data", "model"),
                device: Union[str, torch.device, None] = "cuda",
                ranks: Optional[Sequence[int]] = None) -> Mesh:
    """A 2-D (data, model) mesh or, with ``slices > 1``, a 3-D (slice,
    data, model) hybrid mesh over ``ranks`` (default: the whole world,
    which must be initialized, ``distributed.initialize``), row-major in
    rank order so that a model group is neighbouring ranks. ``data == -1``
    takes all the remaining ranks. Every rank of the world calls it, the
    ones outside ``ranks`` too (they get a mesh they are not a member of).
    The slice axis is the outermost, the only one the batch all-reduce of
    pure data parallelism crosses."""
    if not dist.is_initialized():
        raise RuntimeError("create_mesh needs a process group: call "
                           "parallel.distributed.initialize first")
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if ranks != sorted(ranks):
        raise ValueError(f"mesh ranks must ascend: {ranks}")
    n = len(ranks)
    per = n // slices if slices > 1 else n
    if slices > 1 and n % slices:
        raise ValueError(f"{n} ranks not divisible by slices={slices}")
    if data == -1:
        if per % model:
            raise ValueError(f"{per} ranks not divisible by model={model}")
        data = per // model
    if slices * data * model != n:
        raise ValueError(f"mesh {slices}x{data}x{model} != {n} ranks")
    names = tuple(axis_names)
    grid = np.asarray(ranks).reshape(data, model) if slices == 1 else \
        np.asarray(ranks).reshape(slices, data, model)
    if slices > 1:
        names = ("slice",) + names
    return Mesh(grid, names, resolve_device(device))


def dp_entry(mesh: Mesh, axis: str = "data"):
    """The axes the batch dim spans: ``('slice', 'data')`` on a hybrid
    mesh, plain ``'data'`` otherwise."""
    if "slice" in mesh.axis_names and axis == "data":
        return ("slice", axis)
    return axis


def dp_size(mesh: Mesh, axis: str = "data") -> int:
    """Total data-parallel ways: slice × data on a hybrid mesh."""
    n = mesh.size(axis)
    if "slice" in mesh.axis_names and axis == "data":
        n *= mesh.size("slice")
    return n


def batch_sharding(mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """(block, blocks): this rank holds block ``block`` of a batch cut in
    ``blocks`` equal contiguous row blocks over the data axis (slice ×
    data on a hybrid mesh); ranks that differ only on ``model`` hold the
    same block."""
    if axis == "data":
        return mesh.dp_index, dp_size(mesh)
    return mesh.coords[axis], mesh.size(axis)


def replicated_sharding(mesh: Mesh) -> Tuple[int, int]:
    """Every row on every rank: the one block of one."""
    return 0, 1


def local_batch_size(global_batch: int, mesh: Mesh, axis: str = "data") -> int:
    n = dp_size(mesh, axis)
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {n} "
                         f"data-parallel ways")
    return global_batch // n


def batch_rows(n: int, mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """[lo, hi): this rank's rows of an n-row global batch."""
    block, blocks = batch_sharding(mesh, axis)
    k = local_batch_size(n, mesh, axis) if blocks > 1 else n
    return block * k, block * k + k


def shard_batch(batch: Any, mesh: Mesh, axis: str = "data") -> Any:
    """This rank's rows of a global batch (a tensor, array or tuple of
    them, leading dim the batch), on the mesh's device."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(b, mesh, axis) for b in batch)
    lo, hi = batch_rows(batch.shape[0], mesh, axis)
    return torch.as_tensor(batch[lo:hi]).to(mesh.device)


def host_batch_shard(mesh: Mesh, axis: str = "data") -> Tuple[int, int]:
    """(shard_id, num_shards) of this process's contiguous block of a
    global batch: what its ``DataLoader`` reads. One process per rank, so
    it is the rank's ``batch_sharding``: a model axis that crosses
    processes gives its ranks the same block (a (data=1, model=8) mesh
    feeds every process the whole batch, (0, 1)); pure data parallelism
    over n ranks gives (rank's data way, n)."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return 0, 1
    return batch_sharding(mesh, axis)


def prefetch_to_device(iterator: Iterable, mesh: Optional[Mesh],
                       size: int = 2,
                       device: Union[str, torch.device, None] = None
                       ) -> Iterator:
    """The loader's (already sharded) host batches on the device, ``size``
    in flight: each is pinned and copied with ``non_blocking``, so the
    copy of batch k+1 overlaps the compute of batch k. Yields tuples of
    tensors in order."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    buf: deque = deque()

    def put(x):
        t = torch.as_tensor(x)
        if dev.type == "cuda":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    for batch in iterator:
        buf.append(tuple(put(x) for x in batch))
        if len(buf) > size:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


# ------------------------------------------------------------ sequences

def seq_constrain(sizes: Sequence[int], mesh: Optional[Mesh],
                  axis: str = "model") -> bool:
    """Whether token dims of ``sizes`` shard over ``axis`` of ``mesh``
    (JAX ``seq_constrain``'s guard on the port's explicit layouts): there
    is a mesh, the axis has more than one rank and divides every size.
    Otherwise the layout stays whole, which is JAX's no-op."""
    if mesh is None or mesh.size(axis) <= 1:
        return False
    n = mesh.size(axis)
    return all(int(k) % n == 0 for k in sizes)


class SeqGroup:
    """The ``model`` group of a sequence-parallel forward: ``n`` ranks,
    this one the ``index``-th; ``block(size)`` is its [lo, hi) of a token
    dim, ``all_to_all`` and ``sum`` the differentiable collectives that
    move and reduce token shards over the group."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.mesh = mesh
        self.n = mesh.size(axis)
        self.index = mesh.coords[axis]
        self.group = mesh.group(axis)

    def block(self, size: int) -> Tuple[int, int]:
        k = size // self.n
        return self.index * k, self.index * k + k

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        return all_to_all(t, self.mesh.comm, self.group)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return group_sum(t, self.mesh.comm, self.group)


# ------------------------------------------------------------ state layout

# the port's kernel layouts: dims of the port tensor in the flax kernel's
# order (Dense (out, in) ↔ (in, out), conv OIHW ↔ HWIO, OIDHW ↔ DHWIO),
# as models/convert maps them
_FLAX_ORDER = {2: (1, 0), 4: (2, 3, 1, 0), 5: (2, 3, 4, 1, 0)}


def _jax_entries(shape: Sequence[int], n: int, nf: int, axis: str,
                 fsdp_axis: Optional[str], min_per_shard: int) -> list:
    """The JAX package's ``param_spec`` rule on a flax-layout shape."""
    entries: list = [None] * len(shape)
    if len(shape) == 4:  # conv HWIO: model shards O, fsdp shards I
        if n > 1 and shape[3] % n == 0 and shape[3] // n >= min_per_shard:
            entries[3] = axis
        if nf > 1 and shape[2] % nf == 0 and shape[2] // nf >= min_per_shard:
            entries[2] = fsdp_axis
    elif len(shape) == 3:  # stacked experts (E, in, out): model shards E
        if n > 1 and shape[0] % n == 0 and \
                int(np.prod(shape)) // n >= min_per_shard:
            entries[0] = axis
        if nf > 1 and shape[1] % nf == 0 and shape[1] // nf >= min_per_shard:
            entries[1] = fsdp_axis
    elif len(shape) == 2:  # dense (in, out): model shards in, fsdp out
        if n > 1 and shape[0] % n == 0 and shape[0] // n >= min_per_shard:
            entries[0] = axis
        if nf > 1 and shape[1] % nf == 0 and shape[1] // nf >= min_per_shard:
            entries[1] = fsdp_axis
    elif len(shape) == 1:  # vectors: fsdp shards them
        if nf > 1 and shape[0] % nf == 0 and shape[0] // nf >= min_per_shard:
            entries[0] = fsdp_axis
    return entries


def param_spec(shape: Sequence[int], mesh: Mesh, axis: str = "model",
               min_per_shard: int = 8, fsdp_axis: Optional[str] = None,
               kernel: bool = True) -> Spec:
    """The sharding of a parameter, statistic or momentum leaf of the
    port's layout ``shape``: per dim the axis that shards it or None;
    ``()`` when nothing is sharded (JAX's canonical ``P()``).

    The JAX rule (``model`` shards a conv's output channels and a dense
    layer's input features, ``fsdp_axis`` another dim; leaves too small
    or not divisible stay whole; never ``slice``) on the flax-layout
    shape of the leaf: ``kernel`` says the port holds a 2-, 4- or 5-D leaf
    transposed from flax's kernel (every ``weight``); False for leaves
    carried in flax's layout (the expert stacks and their biases, the
    embeddings)."""
    order = _FLAX_ORDER.get(len(shape)) if kernel else None
    flax_shape = [shape[d] for d in order] if order else list(shape)
    nf = mesh.size(fsdp_axis) if fsdp_axis else 1
    entries = _jax_entries(flax_shape, mesh.size(axis), nf, axis, fsdp_axis,
                           min_per_shard)
    if order:
        port = [None] * len(shape)
        for i, d in enumerate(order):
            port[d] = entries[i]
        entries = port
    if all(e is None for e in entries):
        return ()
    return tuple(entries)


def is_kernel(name: str, t: torch.Tensor) -> bool:
    """Whether a port leaf is held transposed from a flax kernel: a
    ``weight`` of 2 or more dims (``models/convert``)."""
    return name.rsplit(".", 1)[-1] == "weight" and t.dim() >= 2


def state_sharding(model: nn.Module, mesh: Mesh, fsdp: bool = False
                   ) -> Dict[str, Spec]:
    """{name: spec} of every parameter and buffer of ``model`` under
    ``param_spec`` (``fsdp`` adds the ``data`` axis, ZeRO-3)."""
    fsdp_axis = "data" if fsdp else None
    leaves = list(model.named_parameters()) + list(model.named_buffers())
    return {n: param_spec(tuple(t.shape), mesh, fsdp_axis=fsdp_axis,
                          kernel=is_kernel(n, t)) for n, t in leaves}


def local_index(shape: Sequence[int], spec: Spec, mesh: Mesh,
                axes: Optional[Iterable[str]] = None) -> tuple:
    """This rank's block of a leaf of ``shape`` under ``spec`` (only the
    dims sharded over ``axes`` when given)."""
    idx = []
    for d, n in enumerate(shape):
        axis = spec[d] if spec else None
        if axis is None or (axes is not None and axis not in axes):
            idx.append(slice(None))
        else:
            k = n // mesh.size(axis)
            c = mesh.coords[axis]
            idx.append(slice(c * k, c * k + k))
    return tuple(idx)


def compute_sharded(model: nn.Module) -> Dict[str, Tuple[str, ...]]:
    """{leaf: axes} of the leaves ``model`` computes on in blocks over
    those axes: what a module's ``compute_sharded()`` names (a MoE's
    expert stacks under expert parallelism)."""
    out: Dict[str, Tuple[str, ...]] = {}
    for prefix, mod in model.named_modules():
        fn = getattr(mod, "compute_sharded", None)
        if callable(fn):
            for leaf, axes in fn().items():
                out[f"{prefix}.{leaf}" if prefix else leaf] = tuple(axes)
    return out


class StateLayout:
    """Where a model's leaves lie at rest on this rank (``state_sharding``):
    a sharded leaf as this rank's block in ``shards`` (a parameter's as an
    ``nn.Parameter``, which the optimizer updates), every other leaf whole
    in the model.

    ``materialize`` gathers the sharded weights and statistics into the
    model (before compute), ``release`` keeps this rank's block of the
    statistics the compute updated and frees the gathered tensors (after
    it). A leaf the model computes on in blocks (``compute_sharded``) is
    gathered only over the axes the model does not split, so the model
    holds the block it computes on; one sharded over those axes alone is
    the model's own parameter, never gathered (``resident``). A gathered
    tensor goes in by an in-place copy under ``no_grad``, which moves its
    version, so no weight cache keyed on (storage, version)
    (``models/resnet.cached``) can serve a stale value.
    """

    def __init__(self, model: nn.Module, mesh: Mesh, fsdp: bool = False):
        self.model = model
        self.mesh = mesh
        self.specs = {n: s for n, s in
                      state_sharding(model, mesh, fsdp).items() if s}
        self.leaves: Dict[str, torch.Tensor] = dict(model.named_parameters())
        self.leaves.update(model.named_buffers())
        self.shapes = {n: tuple(self.leaves[n].shape) for n in self.specs}
        compute = {n: a for n, a in compute_sharded(model).items()
                   if n in self.specs}
        self.compute = compute  # the leaves the model computes on in blocks
        # per sharded leaf: the axes it is gathered over before compute
        self.gather_axes = {
            n: tuple(a for a in s if a is not None
                     and a not in compute.get(n, ()))
            for n, s in self.specs.items()}
        self.shards: Dict[str, torch.Tensor] = {}
        params = dict(model.named_parameters())
        with torch.no_grad():
            for n in self.specs:
                leaf = self.leaves[n]
                block = self.local(n, leaf).clone()
                if n in compute:  # the model computes on its block
                    leaf.data = leaf.data[local_index(
                        self.shapes[n], self.specs[n], mesh,
                        compute[n])].clone()
                if self.resident(n):
                    self.shards[n] = leaf
                else:
                    self.shards[n] = nn.Parameter(
                        block, requires_grad=params[n].requires_grad) \
                        if n in params else block
        self.materialized = True

    def sharded(self, name: str) -> bool:
        return name in self.specs

    def resident(self, name: str) -> bool:
        """A sharded leaf the model holds as this rank's block at rest and
        in compute alike (never gathered)."""
        return name in self.specs and not self.gather_axes[name]

    def local(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a whole leaf or momentum, as a
        checkpoint holds it); ``full`` itself for a leaf that is not
        sharded."""
        if name not in self.specs:
            return full
        return full[local_index(self.shapes[name], self.specs[name],
                                self.mesh)]

    def grad_block(self, name: str, grad: torch.Tensor) -> torch.Tensor:
        """This rank's block of the gradient of the model's leaf as the
        model computes on it (whole, or the block of a compute-sharded
        leaf)."""
        if name not in self.specs:
            return grad
        return grad[local_index(grad.shape, self.specs[name], self.mesh,
                                self.gather_axes[name])]

    def owns(self, name: str) -> bool:
        """Whether this rank is the one copy of its block that counts in a
        sum over the mesh: coordinate 0 on every axis the spec leaves out."""
        used = set(self.specs[name])
        return all(c == 0 for a, c in self.mesh.coords.items()
                   if a not in used)

    def gather(self, blocks: Mapping[Any, torch.Tensor],
               names: Mapping[Any, str],
               compute: bool = False) -> Dict[Any, torch.Tensor]:
        """Full tensors from every rank's blocks: ``blocks[key]`` is this
        rank's block of leaf ``names[key]`` (a shard, or a momentum of one);
        with ``compute`` the block the model computes on instead (gathered
        over ``gather_axes`` only). One all-gather of a flat buffer per
        axis and dtype."""
        pieces = dict(blocks)
        for axis in ("data", "model"):
            keys = [k for k in pieces if axis in
                    (self.gather_axes if compute else self.specs)[names[k]]]
            for dtype in sorted({pieces[k].dtype for k in keys}, key=str):
                ks = [k for k in keys if pieces[k].dtype == dtype]
                flat = torch.cat([pieces[k].reshape(-1) for k in ks])
                parts = self.mesh.comm.all_gather(flat,
                                                  self.mesh.group(axis))
                sizes = [pieces[k].numel() for k in ks]
                split = [p.split(sizes) for p in parts]
                for i, k in enumerate(ks):
                    shape = pieces[k].shape
                    d = self.specs[names[k]].index(axis)
                    pieces[k] = torch.cat([s[i].reshape(shape)
                                           for s in split], dim=d)
        return pieces

    def full_state(self) -> Dict[str, torch.Tensor]:
        """Every sharded leaf gathered whole (a collective)."""
        return self.gather({n: t.detach() for n, t in self.shards.items()},
                           {n: n for n in self.shards})

    @torch.no_grad()
    def materialize(self) -> None:
        """The weights and statistics the model computes on into it (a
        collective)."""
        if self.materialized:
            return
        gathered = [n for n in self.shards if not self.resident(n)]
        full = self.gather({n: self.shards[n].detach() for n in gathered},
                           {n: n for n in gathered}, compute=True)
        for n, t in full.items():
            leaf = self.leaves[n]
            leaf.data = torch.empty_like(t)
            leaf.copy_(t)
        self.materialized = True

    @torch.no_grad()
    def release(self) -> None:
        """Keep this rank's block of the statistics the compute updated,
        and free the gathered tensors of the model."""
        if not self.materialized:
            return
        for n in self.specs:
            if self.resident(n):
                continue
            leaf = self.leaves[n]
            if not isinstance(self.shards[n], nn.Parameter):
                self.shards[n].copy_(self.grad_block(n, leaf))
            leaf.data = torch.empty(0, dtype=leaf.dtype, device=leaf.device)
        self.materialized = False

    @torch.no_grad()
    def load_full(self, state: Mapping[str, torch.Tensor]) -> None:
        """Set the shards from full tensors of any saved layout (an elastic
        resume): this rank's block of each."""
        for n, shard in self.shards.items():
            shard.copy_(self.local(n, state[n].to(shard.device)))
            if not self.resident(n):
                leaf = self.leaves[n]
                leaf.data = torch.empty(0, dtype=leaf.dtype,
                                        device=leaf.device)
        self.materialized = False

    def held_fraction(self) -> Dict[str, float]:
        """{leaf: fraction of its elements this rank holds at rest}."""
        return {n: self.shards[n].numel() / float(np.prod(self.shapes[n]))
                for n in self.shards}
