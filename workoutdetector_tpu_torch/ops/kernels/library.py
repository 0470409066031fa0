"""The forward kernels as ``torch.library`` custom ops in the ``wd``
namespace, and the launch counters.

Each forward kernel (the shift, the shift-matmul, the fused bottleneck's
two routes, the attention forward's two routes) is one op,
``torch.ops.wd.<name>``, with three implementations:

* CUDA: the kernel's launch (the operand checks that read addresses, the
  ctypes call on the current stream, the launch count);
* CPU: the kernel's plain version;
* fake: the output's shape, dtype and strides, for ``torch.export`` and
  ``opcheck``.

So the dispatcher holds the rule the wrappers state: a CPU tensor takes
the plain version, a CUDA tensor the kernel, any other device raises, and
nothing falls back. The Python wrappers (``shift_matmul``,
``fused_bottleneck``, ``attention``, ...) keep their names and
signatures, choose the route from static shapes, and call the op; the
main path and an exported graph go through the same ops. CPU operands
under autograd take the plain version directly (``cpu_autograd``). The
backward kernels stay plain ctypes calls: training is not exported.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch

NAMESPACE = "wd"

_count_lock = threading.Lock()
_LIB = torch.library.Library(NAMESPACE, "DEF")


def count_launch(wrapper: Callable) -> None:
    """Add one to ``wrapper.launches``. Under a lock: engines score from
    executor and HTTP threads, and ``+=`` on an attribute is a read, an
    add and a write that two threads can interleave."""
    with _count_lock:
        wrapper.launches += 1


def cpu_autograd(*tensors: Optional[torch.Tensor]) -> bool:
    """True for CPU operands under autograd. The ops have no autograd
    formula (on the card the autograd Functions around them carry the
    gradient), so a wrapper given these runs its plain version itself,
    whose torch ops do."""
    return tensors[0].device.type == "cpu" and torch.is_grad_enabled() and \
        any(t is not None and t.requires_grad for t in tensors)


def kernel_op(name: str, cpu: Callable, fake: Callable):
    """Decorator: define the op ``wd::<name>`` (its schema from the
    decorated function's annotations) with the decorated function (the
    CUDA launch) as its CUDA kernel, ``cpu`` as its CPU kernel and
    ``fake`` as its fake one. Returns the op, called like the function.
    Registered through ``torch.library.Library`` rather than
    ``custom_op``, whose Python layers cost a launch-bound forward ≈ 20 µs
    a call more."""

    def register(launch: Callable):
        _LIB.define(name + torch.library.infer_schema(launch, mutates_args=()))
        _LIB.impl(name, launch, "CUDA")
        _LIB.impl(name, cpu, "CPU")
        torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
        return getattr(getattr(torch.ops, NAMESPACE), name).default

    return register
