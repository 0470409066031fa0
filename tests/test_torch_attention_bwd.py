"""PyTorch port, the attention backward's routes on the CPU: the rule that
sends a shape to the one-launch kernel or to the tiled dK/dV and dQ
kernels (pure Python; the kernels run only on the card, see
``tests/test_torch_cuda.py``), ``attention_bwd``'s plain path, and the
packed gradient of ``Attention`` against ``jax.grad`` through the JAX
package's ``_flash_mha`` (the library Pallas TPU flash attention, forward
and backward, in interpret mode).

Tolerance: fp32 on both sides, sums in another order: 1e-5.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu_torch.ops import kernels

# the module (the package's name ``attention`` is its wrapper function)
ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")


@pytest.mark.parametrize("l, dh, short", [
    (1, 64, True),
    (197, 64, True),      # TimeSformer-B/16 at 224²
    (208, 64, True),
    (224, 64, True),      # the last length whose slice fits a block
    (225, 64, False),     # one past the limit: tiled
    (240, 64, False),
    (256, 64, False),
    (257, 64, False),     # 256² frames
    (300, 64, False),
    (0, 64, False),
    (197, 32, False),     # head widths other than 64: tiled
    (197, 128, False),
])
def test_short_route_rule(l, dh, short):
    assert ka.short_route(l, dh) is short


@pytest.mark.parametrize("l, rows", [(197, 208), (224, 224)])
def test_short_route_limit_is_the_shared_memory_reckoning(l, rows):
    """The route's limit is where the kernel's shared memory runs out: every
    length up to 224 fits a block, none beyond; and the sum at l = 197 and
    at the limit is q, k, v, dO (4 R rows of 128 bytes), dS (one R-row tile
    per 64 queries), lse and D (2 R floats) and 1024 + 16 bytes."""
    assert [n for n in range(1, 600) if ka.short_route(n, 64)] == \
        list(range(1, 225))
    assert ka.short_smem(224) <= ka.SHORT_SMEM_MAX < ka.short_smem(225)
    want = 1024 + 4 * rows * 128 + -(-rows // 64) * rows * 128 + 8 * rows + 16
    assert ka.short_smem(l) == want <= ka.SHORT_SMEM_MAX


@pytest.mark.parametrize("packed", [True, False])
def test_attention_bwd_cpu_is_the_plain_backward(packed):
    """On the CPU ``attention_bwd`` is ``attention_bwd_plain``, written into
    the given views (the thirds of a packed gradient) or new tensors, with
    no launch counted on any route."""
    rng = np.random.default_rng(7)
    n, h, l, dh = 2, 3, 19, 64
    qkv = torch.from_numpy(rng.normal(size=(n, l, 3 * h * dh)).astype(
        np.float32))
    q, k, v = kernels.split_heads(qkv, h)
    o, lse = kernels.attention_lse_plain(q, k, v, 0.125)
    do = torch.from_numpy(rng.normal(size=(n, h, l, dh)).astype(np.float32))
    dqkv = torch.zeros_like(qkv)
    outs = kernels.split_heads(dqkv, h) if packed else (None, None, None)
    before = kernels.launch_counts()
    got = kernels.attention_bwd(q, k, v, o, lse, do, 0.125, *outs)
    assert kernels.launch_counts() == before
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if packed:
        assert all(g.data_ptr() == t.data_ptr() for g, t in zip(got, outs))
        assert dqkv.abs().sum() > 0


@pytest.mark.parametrize("l", [17, 197])
def test_attention_function_packed_gradient_matches_the_tpu_flash_backward(l):
    """``Attention`` on a packed (n, l, 3·h·dh) qkv (CPU: the plain forward
    and ``attention_bwd``'s plain path) against ``jax.grad`` through
    ``_flash_mha`` on the same packed projection, at a narrow width (n 2,
    h 2, dh 32) and l = 17 and 197 (TimeSformer-B/16's tokens)."""
    n, h, dh = 2, 2, 32
    scale = dh ** -0.5
    rng = np.random.default_rng(l)
    qkv = rng.normal(size=(n, l, 3 * h * dh)).astype(np.float32)
    do = rng.normal(size=(n, l, h * dh)).astype(np.float32)

    def f(qkv, do):
        q, k, v = (t.reshape(n, l, h, dh).transpose(0, 2, 1, 3)
                   for t in jnp.split(qkv, 3, axis=-1))
        out = jts._flash_mha(q, k, v, scale).transpose(0, 2, 1, 3)
        return jnp.sum(out.reshape(n, l, h * dh) * do)

    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(jax.grad(f))(jnp.asarray(qkv), jnp.asarray(do))
    tqkv = torch.from_numpy(qkv).requires_grad_(True)
    (kernels.Attention.apply(tqkv, h, scale) * torch.from_numpy(do)).sum() \
        .backward()
    np.testing.assert_allclose(tqkv.grad.numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
