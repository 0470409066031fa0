"""PyTorch port, the routes of the attention forward and of the fused
bottleneck on the CPU: the rules that send a shape to the one-block
attention kernel or to the tiled one, and to the wgmma bottleneck kernel or
to the WMMA one (pure Python, worked out by hand here; the card holds each
rule to its kernel's own shared-memory sum, ``tests/test_torch_cuda.py``),
the wgmma kernel's tile walk, and each route's CPU path against the JAX
function it replaces (the library Pallas TPU flash attention in interpret
mode; the Pallas fused bottleneck in interpret mode).

Tolerance: fp32 on both sides, sums in another order: 1e-5.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from workoutdetector_tpu.models import timesformer as jts
from workoutdetector_tpu.ops.pallas.fused_block import (
    FusedBlockParams as JParams, fused_bottleneck as j_fused_bottleneck)
from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.ops.kernels import fused_block as fb

# the module (the package's name ``attention`` is its wrapper function)
ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")


# ------------------------------------------------------ attention forward

@pytest.mark.parametrize("l, dh, rows, short", [
    (1, 64, 64, True), (17, 64, 64, True), (64, 64, 64, True),
    (65, 64, 128, True), (128, 64, 128, True),
    (129, 64, 208, True),
    (197, 64, 208, True),    # TimeSformer-B/16 at 224²
    (208, 64, 208, True),
    (209, 64, 256, True), (256, 64, 256, True),  # one TMA box: <= 256 rows
    (257, 64, 0, False),     # 256² frames: tiled
    (325, 64, 0, False),     # 288² frames: tiled
    (0, 64, 0, False),
    (197, 32, 208, False), (197, 128, 208, False),  # other head widths
])
def test_fwd_route_rule(l, dh, rows, short):
    """R, the rows of each of q, k and v in shared memory, is the first
    instantiation (64, 128, 208, 256) that holds l; beyond 256 rows, at l
    < 1 or at a head width other than 64 the tiled kernel runs."""
    assert ka.fwd_rows(l) == rows
    assert ka.fwd_route(l, dh) is short


@pytest.mark.parametrize("l, rows", [(1, 64), (197, 208), (256, 256)])
def test_fwd_smem_is_the_reckoning(l, rows):
    """q, k and v (3 R rows of 128 bytes), two mbarriers (16 bytes) and
    1024 bytes of alignment slack: 80,912 bytes at l = 197, two blocks an
    SM; the largest, at l = 256, 99,344 bytes."""
    want = 1024 + 3 * rows * 128 + 16
    assert ka.fwd_smem(l) == want
    assert 2 * ka.fwd_smem(l) <= 232448
    assert ka.fwd_smem(257) == 0
    assert [n for n in range(0, 400) if ka.fwd_route(n, 64)] == \
        list(range(1, 257))


@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_routes_on_the_cpu_are_the_plain_versions(with_lse):
    """On the CPU both routes are the plain forward, and no launch is
    counted on any route."""
    rng = np.random.default_rng(11)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 3, 33, 64)).astype(
        np.float32)) for _ in range(3))
    before = kernels.launch_counts()
    o, lse = kernels.attention_tiled(q, k, v, 0.125, with_lse=with_lse)
    if with_lse:
        o_ref, lse_ref = kernels.attention_lse_plain(q, k, v, 0.125)
        assert torch.equal(lse, lse_ref)
        assert all(torch.equal(a, b) for a, b in zip(
            kernels.attention_lse(q, k, v, 0.125), (o_ref, lse_ref)))
    else:
        o_ref = kernels.attention_plain(q, k, v, 0.125)
        assert lse is None
        assert torch.equal(kernels.attention(q, k, v, 0.125), o_ref)
    assert torch.equal(o, o_ref)
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("l", [17, 197, 325])
def test_attention_forward_matches_the_tpu_flash_forward(l):
    """The forward on either route (CPU: the plain version) against the
    JAX package's ``_flash_mha`` (the library Pallas TPU flash attention in
    interpret mode) on the same q, k, v, at l = 17, 197 (TimeSformer-B/16's
    tokens, the one-block route on the card) and 325 (288² frames, the
    tiled route)."""
    n, h, dh = 2, 2, 64
    scale = dh ** -0.5
    rng = np.random.default_rng(l)
    q, k, v = (rng.normal(size=(n, h, l, dh)).astype(np.float32)
               for _ in range(3))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jts._flash_mha(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), scale))
    got, _ = kernels.attention_tiled(*(torch.from_numpy(a) for a in (q, k, v)),
                                     scale)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        kernels.attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          scale).numpy(), want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------ fused bottleneck

# (C, F, O, downsample, the route, shared memory worked out by hand)
# 1024 slack + 8 x 8192 ring + 2 warpgroups x (two x buffers of 16,384
# bytes; 16,384 of downsample panels; F / 64 y1 panels of 14,336) + 16
# mbarriers x 8 + 4 bytes x (4 F + 2 O, twice 2 O with a downsample)
ROUTES = [
    (64, 64, 256, True, True,      # layer1_0
     1024 + 65536 + 2 * (2 * 16384 + 16384 + 14336) + 128 + 4 * (256 + 1024)),
    (256, 64, 256, False, True,    # layer1_1..2
     1024 + 65536 + 2 * (2 * 16384 + 16384 + 14336) + 128 + 4 * (256 + 512)),
    (512, 128, 512, False, True,   # layer2_1..3
     1024 + 65536 + 2 * (2 * 16384 + 16384 + 2 * 14336) + 128 + 4 * (512 + 1024)),
    (128, 128, 128, True, True,
     1024 + 65536 + 2 * (2 * 16384 + 16384 + 2 * 14336) + 128 + 4 * (512 + 512)),
    (128, 128, 512, True, False, 0),  # 232,576 bytes: one past the limit
    (256, 64, 256, True, False, 0),   # downsample over C > 128
    (1024, 256, 1024, False, False, 0),  # layer3: F = 256
    (256, 32, 256, False, False, 0),
]


@pytest.mark.parametrize("c, f, o, ds, route, smem", ROUTES)
def test_wgmma_route_rule_and_smem(c, f, o, ds, route, smem):
    assert fb.wgmma_smem(c, f, o, ds) == smem
    assert kernels.wgmma_route(c, f, o, ds) is route
    assert smem <= fb.SMEM_MAX


@pytest.mark.parametrize("frames, h, w, tiles, pairs", [
    (128, 56, 56, 128 * 14 * 4, 128 * 14 * 4 // 2),  # layer1 at 16 clips
    (128, 28, 28, 128 * 7 * 2, 128 * 7),             # layer2
    (8, 9, 21, 8 * 3 * 2, 24),                       # ragged edges
    (1, 5, 7, 2, 1),
    (3, 4, 16, 3, 2),                                # odd: a lone last tile
])
def test_wgmma_tile_walk(frames, h, w, tiles, pairs):
    """4 x 16 output tiles, ⌈h/4⌉ ⌈w/16⌉ a frame, two to a pair."""
    assert fb.wgmma_tiles(frames, h, w) == (tiles, pairs)


def _jax_fused(p, x, t, fold):
    jp = JParams(*(None if a is None else jnp.asarray(a.numpy())
                   for a in p))
    return np.asarray(j_fused_bottleneck(jnp.asarray(x), jp, n_segment=t,
                                         fold=fold, interpret=True))


@pytest.mark.parametrize("with_ds", [False, True])
def test_fused_routes_on_the_cpu_match_jax(with_ds):
    """Both routes of the bottleneck (CPU: the plain version) against the
    JAX package's Pallas fused bottleneck in interpret mode, ragged frames
    (5 x 7) over 2 clips of 4 frames, fold 2 of 16 channels."""
    rng = np.random.default_rng(12)
    t, b, h, w, c, f = 4, 2, 5, 7, 16, 8
    o = 2 * c if with_ds else c

    def arr(*shape, scale=0.3):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    def sb(n):
        return torch.from_numpy(np.stack([rng.uniform(0.5, 1.0, n),
                                          rng.normal(0, 0.1, n)]).astype(
                                              np.float32))

    p = kernels.FusedBlockParams(arr(c, f), sb(f), arr(3, 3, f, f), sb(f),
                                 arr(f, o), sb(o),
                                 arr(c, o) if with_ds else None,
                                 sb(o) if with_ds else None)
    x = rng.standard_normal((b * t, h, w, c)).astype(np.float32)
    want = _jax_fused(p, x, t, 2)
    before = kernels.launch_counts()
    for fn in (kernels.fused_bottleneck, kernels.fused_bottleneck_wmma):
        got = fn(torch.from_numpy(x), p, n_segment=t, fold=2).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert kernels.launch_counts() == before
