"""Process-group setup and the collectives of the parallel paths.

Port of ``workoutdetector_tpu/parallel/distributed.py``. The JAX package
runs one SPMD program over a mesh and ``jax.distributed.initialize`` joins
the hosts; the port runs one process per rank (the reference's
``torch.distributed.launch`` + gloo DDP, SURVEY §2.8) and ``initialize``
joins them into one ``torch.distributed`` process group.

``initialize`` reads the torchrun contract (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) or
explicit arguments, and does nothing for a single process. The backend is
chosen by one rule, logged and returned: NCCL where each rank of the host
has a card of its own, gloo for CPU ranks and for ranks that share a card
(NCCL refuses two ranks on one device). The group has a timeout, so a
rank that dies fails the others' next collective instead of hanging them.

``Collectives`` runs every collective of the parallel paths (the mesh's
``comm``) through one fixed transport per operation and counts the host
time spent in them. NCCL takes CUDA tensors for every operation. Gloo takes
CPU tensors for every operation, and of CUDA tensors only ``all_reduce``
and ``broadcast``, which it copies through host memory itself; its
all-gather and point-to-point transfers of CUDA tensors are staged here
through pinned host buffers. The compute stays on the card either way:
this is the transport, not a fallback.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue
import socket
import sys
import time
import traceback
from collections import Counter
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from workoutdetector_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)

TIMEOUT_S = 300.0  # a collective that waits longer fails the run

# dtypes a point-to-point header can name (index = code)
_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.uint8, torch.bool)
_HEADER = 64  # int64 slots of a point-to-point header


def choose_backend(device: Union[str, torch.device],
                   local_world_size: int) -> str:
    """NCCL when every rank of this host has a card of its own, gloo for
    CPU ranks and for ranks that share a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and local_world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None,
               device: Union[str, torch.device] = "cuda",
               backend: Optional[str] = None,
               timeout_s: float = TIMEOUT_S) -> Optional[str]:
    """Join this process to the run's process group; returns the backend,
    or None for a single process (no group is made).

    Arguments left None come from the torchrun environment; without one
    the process is alone. ``init_method`` defaults to
    ``tcp://MASTER_ADDR:MASTER_PORT``. A CUDA rank takes card
    ``LOCAL_RANK`` mod the host's cards as its current device. ``backend``
    None applies ``choose_backend``; a named one is used as named. A
    second call in a process that already has a group returns its backend.
    """
    if dist.is_initialized():
        return dist.get_backend()
    env = os.environ
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", "1"))
    if world_size <= 1 and init_method is None:
        return None
    if rank is None:
        rank = int(env.get("RANK", "0"))
    if init_method is None:
        init_method = (f"tcp://{env.get('MASTER_ADDR', 'localhost')}:"
                       f"{env['MASTER_PORT']}")
    local_rank = int(env.get("LOCAL_RANK", rank))
    local_world = int(env.get("LOCAL_WORLD_SIZE", world_size))
    dev = resolve_device(device)
    if backend is None:
        backend = choose_backend(dev, local_world)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("rank %d of %d: backend %s on %s", rank, world_size, backend,
                _device_name(dev))
    return backend


def _device_name(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda:{torch.cuda.current_device()}"
    return str(dev)


def is_main_process() -> bool:
    """Rank 0 of the run, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(fn, rank: int, world_size: int, port: int, device: str,
               backend: Optional[str], args: tuple, results) -> None:
    try:
        initialize(f"tcp://localhost:{port}", world_size, rank, device=device,
                   backend=backend)
        results.put((rank, True, fn(rank, *args)))
    except Exception:  # the parent reports it and fails the run
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# what the server ``spawn`` forks ranks from imports once (the first
# ``torch.optim`` optimizer of a process imports torch._dynamo)
_PRELOAD = ["torch", "torch.distributed", "torch._dynamo",
            "workoutdetector_tpu_torch.parallel.distributed"]
_server_stop_registered = False


def _rank_context():
    """The multiprocessing context of ``spawn``'s ranks: forked from one
    server process that imported torch once, not each importing it anew
    (seconds a rank). The server touches no card; it ends after this
    process does, which may take it a moment, so this process stops it
    and waits for it when it exits."""
    global _server_stop_registered
    import atexit
    import multiprocessing as mp
    from multiprocessing import forkserver

    ctx = mp.get_context("forkserver")
    ctx.set_forkserver_preload(_PRELOAD)
    if not _server_stop_registered:
        # CPython's own way to end the server and wait for it
        atexit.register(forkserver._forkserver._stop)
        _server_stop_registered = True
    return ctx


def spawn(fn: Callable[..., Any], world_size: int, args: tuple = (),
          device: Union[str, torch.device] = "cuda",
          backend: Optional[str] = None,
          timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` in ``world_size`` new processes on this host
    joined into one process group (``initialize`` over
    tcp://localhost:<free port> on ``device``; ``backend`` None chooses by
    the rule) and return their results in rank order. ``fn`` and its
    results travel by pickle: ``fn`` is a module-level function. A rank
    that raises or dies, or a run past ``timeout_s``, raises RuntimeError
    after every rank is stopped; so does a ``device`` of ``"cuda"`` without
    a card, before any process starts."""
    device = str(resolve_device(device))
    ctx = _rank_context()
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world_size, port, device, backend, args,
                               results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout_s
    failure = None
    try:
        while len(out) < world_size and failure is None:
            left = deadline - time.monotonic()
            if left <= 0:
                late = sorted(set(range(world_size)) - set(out))
                failure = f"ranks {late} did not finish in {timeout_s:.0f} s"
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and not p.is_alive()
                        and p.exitcode not in (0, None)]
                if dead:
                    failure = f"ranks {dead} died (exit codes " \
                        f"{[procs[r].exitcode for r in dead]})"
                continue
            if not ok:
                failure = f"rank {rank} failed:\n{value}"
            out[rank] = value
        if failure is None:
            for p in procs:
                p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    if failure is not None:
        raise RuntimeError(f"spawned world of {world_size}: {failure}")
    return [out[r] for r in range(world_size)]


class Collectives:
    """The collectives of one process's parallel paths, each through one
    fixed transport (module docstring), with their calls and host seconds.

    With ``timed`` set the device is synchronised before and after each
    call, so ``seconds`` holds the collectives' own wall time and not that
    of the compute queued before them.
    """

    # operations gloo runs on CUDA tensors itself
    GLOO_CUDA_OPS = ("all_reduce", "broadcast")

    def __init__(self, backend: str, device: torch.device):
        self.backend = backend
        self.device = torch.device(device)
        self.timed = False
        self.seconds = 0.0
        self.calls: Counter = Counter()

    def staged(self, op: str) -> bool:
        """Whether ``op`` on this process's tensors goes through pinned
        host buffers."""
        return (self.backend == "gloo" and self.device.type == "cuda"
                and op not in self.GLOO_CUDA_OPS)

    def transport(self, op: str) -> str:
        if self.device.type != "cuda":
            return f"{self.backend}, CPU tensors"
        if self.staged(op):
            return f"{self.backend}, staged through pinned host buffers"
        if self.backend == "gloo":
            return "gloo, CUDA tensors (gloo copies them through host memory)"
        return f"{self.backend}, CUDA tensors"

    def transports(self) -> Dict[str, str]:
        """{operation: transport} of every operation called so far."""
        return {op: self.transport(op) for op in sorted(self.calls)}

    def reset(self) -> None:
        self.seconds = 0.0
        self.calls.clear()

    def _enter(self, op: str) -> float:
        self.calls[op] += 1
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def _leave(self, t0: float) -> None:
        if self.timed and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds += time.perf_counter() - t0

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def all_reduce(self, t: torch.Tensor, group) -> torch.Tensor:
        """In-place sum of ``t`` over ``group``; returns ``t``. The
        backends read a tensor's storage as dense, so a strided ``t`` goes
        through a contiguous copy."""
        t0 = self._enter("all_reduce")
        buf = t.contiguous()
        dist.all_reduce(buf, group=group)
        if buf is not t:
            t.copy_(buf)
        self._leave(t0)
        return t

    def all_gather(self, t: torch.Tensor, group) -> List[torch.Tensor]:
        """Every member's ``t`` (same shape), in group-rank order."""
        t0 = self._enter("all_gather")
        n = dist.get_world_size(group)
        src = self._host(t) if self.staged("all_gather") else t.contiguous()
        out = [torch.empty(src.shape, dtype=src.dtype,
                           pin_memory=src is not t) for _ in range(n)] \
            if src is not t else [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(out, src, group=group)
        if src is not t:
            out = [o.to(t.device, non_blocking=True) for o in out]
        self._leave(t0)
        return out

    def _header(self, tensors: Sequence[torch.Tensor],
                flag: int = 0) -> torch.Tensor:
        fields = [flag, len(tensors)]
        for t in tensors:
            fields += [_DTYPES.index(t.dtype), t.dim(), *t.shape]
        header = torch.zeros(_HEADER, dtype=torch.int64)
        header[:len(fields)] = torch.tensor(fields)
        return header

    @staticmethod
    def _specs(header: torch.Tensor) -> Tuple[int, list]:
        """(flag, [(dtype, shape)]) of a header."""
        fields = header.cpu().tolist()
        specs, k = [], 2
        for _ in range(fields[1]):
            dtype, ndim = _DTYPES[fields[k]], fields[k + 1]
            specs.append((dtype, fields[k + 2:k + 2 + ndim]))
            k += 2 + ndim
        return fields[0], specs

    def send(self, tensors: Sequence[torch.Tensor], dst: int,
             flag: int = 0) -> None:
        """Point-to-point: a header of ``flag`` and the tensors' dtypes and
        shapes, then each tensor, to global rank ``dst`` (``recv`` there)."""
        t0 = self._enter("send")
        dist.send(self._wire(self._header(tensors, flag)), dst)
        for t in tensors:
            dist.send(self._wire(t), dst)
        self._leave(t0)

    def recv(self, src: int) -> Tuple[int, Tuple[torch.Tensor, ...]]:
        """(flag, tensors) that ``send`` sent from global rank ``src``, the
        tensors on this process's device."""
        t0 = self._enter("recv")
        header = self._wire(torch.zeros(_HEADER, dtype=torch.int64))
        dist.recv(header, src)
        flag, specs = self._specs(header)
        out = []
        for dtype, shape in specs:
            buf = self._wire(torch.empty(shape, dtype=dtype))
            dist.recv(buf, src)
            out.append(buf.to(self.device, non_blocking=True))
        self._leave(t0)
        return flag, tuple(out)

    def broadcast_tensors(self, tensors: Optional[Sequence[torch.Tensor]],
                          flag: int, src: int, group
                          ) -> Tuple[int, Tuple[torch.Tensor, ...]]:
        """(flag, tensors) of global rank ``src`` on every member of
        ``group``; the others pass None and learn dtypes and shapes from a
        header."""
        t0 = self._enter("broadcast")
        on_device = self.backend == "nccl"
        mine = tensors is not None
        header = self._header(tensors, flag) if mine else \
            torch.zeros(_HEADER, dtype=torch.int64)
        if on_device:
            header = header.to(self.device)
        dist.broadcast(header, src, group=group)
        flag, specs = self._specs(header)
        out = []
        for i, (dtype, shape) in enumerate(specs):
            buf = tensors[i].contiguous() if mine else \
                torch.empty(shape, dtype=dtype, device=self.device)
            dist.broadcast(buf, src, group=group)
            out.append(buf)
        self._leave(t0)
        return flag, tuple(out)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where point-to-point ops take it: pinned host memory when
        staged, else this process's device."""
        if self.staged("send"):
            return self._host(t)
        return t.to(self.device).contiguous()


class _GroupSum(torch.autograd.Function):
    """Differentiable sum over a process group: the backward sums the
    incoming gradients over the group too, so each rank's backward of its
    own loss yields the gradient of the sum of the ranks' losses."""

    @staticmethod
    def forward(ctx, t, comm: Collectives, group):
        ctx.comm, ctx.group = comm, group
        return comm.all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm.all_reduce(grad.contiguous().clone(), ctx.group), \
            None, None


def group_sum(t: torch.Tensor, comm: Collectives, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, differentiable (``_GroupSum``). The
    counterpart of ``torch.distributed.nn.functional.all_reduce``, which
    newer PyTorch deprecates, through ``comm``'s transport."""
    return _GroupSum.apply(t, comm, group)
