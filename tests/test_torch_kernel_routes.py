"""PyTorch port, the routes of the attention forward and of the fused
bottleneck on the CPU: the rules that send a shape to the one-block
attention kernel or to the tiled one, and to the wgmma bottleneck kernel or
to the WMMA one (pure Python, worked out by hand here; the card holds each
rule to its kernel's own shared-memory sum, ``tests/test_torch_cuda.py``),
the wgmma kernel's tile walk, and each route's CPU path against the JAX
function it replaces (the library Pallas TPU flash attention in interpret
mode; the Pallas fused bottleneck in interpret mode). Also the
shift-matmul kernel's walk (``shift_matmul_plan``: its tiles, and each ring
stage's K chunk, channel region and row offset), worked out by
hand and run in numpy against the plain version; the card holds it to the
kernel's own plan.

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

# the modules (the package's names ``attention`` and ``shift_matmul`` are
# their wrapper functions)
ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")
sm = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.shift_matmul")


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


# ------------------------------------------------------ shift-matmul walk

# (m, hw, t, c, o, fold) -> tile width, ring stages, shared memory, clip
# rows, clips, row tiles a clip, row tiles, column tiles, block tiles and
# the ring stages (region passes) of a block tile (K chunk, region, row
# offset), worked out by hand. A stage: two 64 x 64 x boxes (16,384 bytes)
# and a 64 x BN W box (BN x 128 bytes); beside the ring the warpgroups'
# staged output boxes (64 x 64, 8,192 bytes; one each at BN = 64, two
# else); stages = min(8, (232,448 - 1024 - the output boxes - 256) //
# stage); shared memory = 1024 + stages x stage + the output boxes + 2 x 8
# bytes a stage.
SM_PLANS = [
    # layer2_0 at 16 clips: fold 32 cuts chunk 0 at k = 32: two passes;
    # 25,088 rows a clip = 392 tiles, no padding
    ((401408, 3136, 8, 256, 128, 32),
     (128, 6, 1024 + 6 * 32768 + 4 * 8192 + 96, 25088, 16, 392, 6272, 1, 3136),
     ((0, 0, 3136), (0, 1, -3136), (1, 2, 0), (2, 2, 0), (3, 2, 0))),
    # layer1_0 in training (32 clips): fold 8, chunk 0 in three passes
    ((802816, 3136, 8, 64, 64, 8),
     (64, 8, 1024 + 8 * 24576 + 2 * 8192 + 128, 25088, 32, 392, 12544, 1, 6272),
     ((0, 0, 3136), (0, 1, -3136), (0, 2, 0))),
    # layer3_1 at 16 clips: 1568 rows a clip = 25 tiles (the last 32 real
    # rows); folds of two whole chunks each
    ((25088, 196, 8, 1024, 256, 128),
     (256, 4, 1024 + 4 * 49152 + 4 * 8192 + 64, 1568, 16, 25, 400, 1, 200),
     ((0, 0, 196), (1, 0, 196), (2, 1, -196), (3, 1, -196))
     + tuple((k, 2, 0) for k in range(4, 16))),
    # layer4_1 at 16 clips: 392 rows a clip = 7 tiles (the last 8 real
    # rows), O = 512 in two column tiles
    ((6272, 49, 8, 2048, 512, 256),
     (256, 4, 230464, 392, 16, 7, 112, 2, 112),
     tuple((k, 0, 49) for k in range(4)) + tuple((k, 1, -49) for k in range(4, 8))
     + tuple((k, 2, 0) for k in range(8, 32))),
    # TSM-R18's fold 16 of 128: chunk 0 in three passes
    ((2 * 8 * 49, 49, 8, 128, 128, 16),
     (128, 6, 230496, 392, 2, 7, 14, 1, 7),
     ((0, 0, 49), (0, 1, -49), (0, 2, 0), (1, 2, 0))),
    # fold 24: both folds and the unshifted rest in chunk 0
    ((4 * 6, 6, 4, 192, 16, 24),
     (64, 8, 214144, 24, 1, 1, 1, 1, 1),
     ((0, 0, 6), (0, 1, -6), (0, 2, 0), (1, 2, 0), (2, 2, 0))),
    # unshifted: all 490 rows one clip of 8 tiles; C = 72: a part chunk
    ((490, 49, 10, 72, 16, 0),
     (64, 8, 214144, 490, 1, 8, 8, 1, 4),
     ((0, 2, 0), (1, 2, 0))),
    # fold = C / 2 (fold_div 2): no unshifted channels
    ((3 * 2 * 5, 5, 2, 64, 32, 32),
     (64, 8, 214144, 10, 3, 1, 3, 1, 2),
     ((0, 0, 5), (0, 1, -5))),
    # O = 320: two column tiles of 256, the second 64 real columns
    ((4 * 9, 9, 4, 64, 320, 8),
     (256, 4, 230464, 36, 1, 1, 1, 2, 2),
     ((0, 0, 9), (0, 1, -9), (0, 2, 0))),
]


@pytest.mark.parametrize("shape, counts, steps", SM_PLANS)
def test_shift_matmul_plan(shape, counts, steps):
    plan = sm.shift_matmul_plan(*shape)
    assert tuple(plan[:9]) == counts
    assert plan.steps == steps
    assert plan.smem <= sm.SMEM_MAX


@pytest.mark.parametrize("shape, padding", [
    ((6272, 49, 8, 2048, 512, 256), 56 / 448),    # 7 x 7: 12.5 %
    ((25088, 196, 8, 1024, 256, 128), 32 / 1600),  # 14 x 14: 2 %
    ((100352, 784, 8, 512, 256, 64), 0.0),         # 28 x 28
])
def test_shift_matmul_plan_padding(shape, padding):
    assert sm.shift_matmul_plan(*shape).padding == pytest.approx(padding)


@pytest.mark.parametrize("shape", [
    (10, 5, 4, 64, 16, 8),   # rows not whole clips
    (8, 1, 8, 60, 16, 0),    # C % 8
    (8, 1, 8, 64, 24, 0),    # O % 16
    (8, 1, 8, 64, 16, 4),    # fold % 8
    (8, 1, 8, 64, 16, 40),   # 2·fold > C
])
def test_shift_matmul_plan_refuses(shape):
    with pytest.raises(ValueError):
        sm.shift_matmul_plan(*shape)


def _walk(x, w, plan, c, fold):
    """The kernel's walk in numpy: each row tile's ring stages, each x box
    loaded at its region's row offset inside the clip and zero outside the
    clip and outside the region's channels, its four 16-deep k-steps
    summed; then the stores, rows past the clip dropped."""
    o = w.shape[1]
    xc = x.reshape(plan.clips, plan.clip_rows, c)
    y = np.zeros((plan.clips, plan.clip_rows, o))
    regions = sm._regions(c, fold)
    for s in range(plan.row_tiles):
        clip, row0 = s // plan.tiles_per_clip, s % plan.tiles_per_clip * 64
        acc = np.zeros((64, o))
        for chunk, r, dr in plan.steps:
            lo, hi = regions[r]
            box = np.zeros((64, 64))
            src = np.arange(row0, row0 + 64) + dr
            rows = (src >= 0) & (src < plan.clip_rows)
            ch = np.arange(chunk * 64, chunk * 64 + 64)
            cols = (ch >= lo) & (ch < hi)
            box[np.ix_(rows, cols)] = xc[clip][np.ix_(src[rows], ch[cols])]
            wk = np.zeros((64, o))
            wk[:min(64, c - chunk * 64)] = w[chunk * 64:chunk * 64 + 64]
            for k in range(4):
                acc += box[:, 16 * k:16 * k + 16] @ wk[16 * k:16 * k + 16]
        n = min(64, plan.clip_rows - row0)
        y[clip, row0:row0 + n] = acc[:n]
    return y.reshape(-1, o)


@pytest.mark.parametrize("frames, h, w, c, o, t, fold_div", [
    (2 * 8, 7, 7, 64, 16, 8, 8),    # 392-row clips, fold 8
    (2 * 4, 3, 4, 256, 32, 4, 8),   # fold 32
    (2 * 4, 5, 3, 192, 16, 4, 8),   # fold 24
    (4, 4, 5, 72, 16, 4, 1000),     # unshifted, C = 72
    (2 * 2, 3, 3, 64, 16, 2, 2),    # fold = C / 2
    (2 * 4, 2, 3, 128, 32, 4, 8),   # fold 16: three passes in chunk 0
])
def test_shift_matmul_walk_is_the_plain_product(frames, h, w, c, o, t,
                                                fold_div):
    """The plan's stages, run as the kernel runs them, give the plain
    version's shift(x) @ W (fp64 walk against the fp32 plain version)."""
    rng = np.random.default_rng(c + o)
    x = rng.standard_normal((frames, h, w, c)).astype(np.float32)
    wt = (rng.standard_normal((c, o)) * 0.1).astype(np.float32)
    fold = c // fold_div
    plan = sm.shift_matmul_plan(frames * h * w, h * w, t, c, o, fold)
    got = _walk(x.reshape(-1, c).astype(np.float64), wt.astype(np.float64),
                plan, c, fold)
    want = kernels.shift_matmul(torch.from_numpy(x), torch.from_numpy(wt), t,
                                fold_div).numpy().reshape(-1, o)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
