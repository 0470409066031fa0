"""PyTorch port, op level: the plain versions of the port's ops and hand
kernels against the JAX functions they replace (JAX Pallas kernels in
interpret mode), fp32 on the CPU. The kernels themselves are held to
their plain versions on the card in tests/test_torch_cuda.py.

Inputs come from numpy seeds and go through both stacks as numpy arrays.
Tolerance: 1e-5 absolute and relative in fp32 (the two stacks sum in
different orders); shifts, gathers and copies are exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from workoutdetector_tpu.ops import preprocess as jpre
from workoutdetector_tpu.ops import temporal_shift as jts
from workoutdetector_tpu.ops.pallas.fused_block import (
    FusedBlockParams as JParams, fold_bn as j_fold_bn,
    fused_bottleneck as j_fused_bottleneck)
from workoutdetector_tpu.ops.pallas.shift import temporal_shift_pallas
from workoutdetector_tpu.ops.pallas.shift_matmul import make_shift_matmul
from workoutdetector_tpu_torch.ops import kernels
from workoutdetector_tpu_torch.ops import preprocess as tpre
from workoutdetector_tpu_torch.ops import temporal_shift as tts

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are small: one intra-op thread, so the parallel
    test workers do not oversubscribe the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("shape,fold_div", [
    ((2, 4, 3, 3, 16), 8),
    ((3, 8, 2, 2, 32), 4),
    ((1, 3, 2, 2, 8), 16),  # fold 0: a copy
])
def test_temporal_shift_matches_jax(shape, fold_div):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    b, t = shape[:2]
    want = np.asarray(jts.temporal_shift(jnp.asarray(x), fold_div))
    np.testing.assert_array_equal(_np(tts.temporal_shift(_t(x), fold_div)), want)
    flat = x.reshape(b * t, *shape[2:])
    want_flat = np.asarray(jts.temporal_shift_flat(jnp.asarray(flat), t, fold_div))
    np.testing.assert_array_equal(
        _np(tts.temporal_shift_flat(_t(flat), t, fold_div)), want_flat)
    # the kernel wrapper on a CPU tensor = its plain version = Pallas kernel
    pallas = np.asarray(temporal_shift_pallas(jnp.asarray(x), fold_div,
                                              interpret=True))
    np.testing.assert_array_equal(
        _np(kernels.temporal_shift_clips(_t(x), fold_div)), pallas)
    np.testing.assert_array_equal(
        _np(kernels.temporal_shift(_t(flat), t, fold_div)), want_flat)


def test_shift_does_not_cross_clips():
    """Flat (B·T) layout with B = 3: frame T−1 of clip k gets zeros in the
    left fold, not frame 0 of clip k+1 (and symmetrically for t = 0)."""
    b, t, c = 3, 4, 16
    x = np.arange(b * t * c, dtype=np.float32).reshape(b * t, 1, 1, c) + 1
    y = _np(tts.temporal_shift_flat(_t(x), t, 8))
    fold = c // 8
    for k in range(b):
        assert (y[k * t + t - 1, ..., :fold] == 0).all()
        assert (y[k * t, ..., fold:2 * fold] == 0).all()
        np.testing.assert_array_equal(y[k * t, ..., :fold],
                                      x[k * t + 1, ..., :fold])


@pytest.mark.parametrize("khw,strides,padding,c,o", [
    ((1, 1), (1, 1), "SAME", 64, 16),
    ((3, 3), (1, 1), [(1, 1), (1, 1)], 32, 32),
    ((3, 3), (2, 2), [(1, 1), (1, 1)], 16, 8),
    ((3, 3), (2, 2), "SAME", 16, 8),  # XLA SAME: the odd pixel pads last
])
def test_shift_conv_matches_jax(khw, strides, padding, c, o):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2 * 4, 8, 8, c)).astype(np.float32)
    k = (rng.standard_normal(khw + (c, o)) * 0.1).astype(np.float32)
    want = np.asarray(jts.shift_conv(jnp.asarray(x), jnp.asarray(k), 4, 8,
                                     strides, padding))
    got = _np(tts.shift_conv(_t(x), _t(k), 4, 8, strides, padding))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fold_div", [8, 4, 128])
def test_shift_matmul_matches_jax(fold_div):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3 * 4, 6, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 16)) * 0.1).astype(np.float32)
    op = make_shift_matmul(4, fold_div, interpret=True)
    want = np.asarray(op(jnp.asarray(x), jnp.asarray(w)))
    before = kernels.shift_matmul.launches
    got = _np(kernels.shift_matmul(_t(x), _t(w), 4, fold_div))
    assert kernels.shift_matmul.launches == before  # CPU: plain version
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(
        _np(kernels.shift_matmul_plain(_t(x), _t(w), 4, fold_div)), want, **TOL)


def _rand_params(rng, c, f, o, with_ds):
    ks = rng.standard_normal

    def sb(n):
        return np.stack([1 + 0.1 * ks(n), 0.1 * ks(n)]).astype(np.float32)

    return dict(
        w1=(ks((c, f)) * 0.1).astype(np.float32), sb1=sb(f),
        w2=(ks((3, 3, f, f)) * 0.1).astype(np.float32), sb2=sb(f),
        w3=(ks((f, o)) * 0.1).astype(np.float32), sb3=sb(o),
        wd=(ks((c, o)) * 0.1).astype(np.float32) if with_ds else None,
        sbd=sb(o) if with_ds else None)


def _both_fused(p, x, t, fold, row_tile=None):
    jp = JParams(**{k: None if v is None else jnp.asarray(v)
                    for k, v in p.items()})
    want = np.asarray(j_fused_bottleneck(jnp.asarray(x), jp, n_segment=t,
                                         fold=fold, row_tile=row_tile,
                                         interpret=True))
    tp = kernels.FusedBlockParams(**{k: None if v is None else _t(v)
                                     for k, v in p.items()})
    got = _np(kernels.fused_bottleneck(_t(x), tp, n_segment=t, fold=fold))
    return got, want


@pytest.mark.parametrize("with_ds", [False, True])
@pytest.mark.parametrize("fold_div", [0, 4])
def test_fused_bottleneck_matches_jax(with_ds, fold_div):
    rng = np.random.default_rng(3)
    t, b, h, w, c, f = 4, 2, 8, 8, 16, 8
    o = 2 * c if with_ds else c
    p = _rand_params(rng, c, f, o, with_ds)
    x = rng.standard_normal((b * t, h, w, c)).astype(np.float32)
    fold = 0 if fold_div == 0 else c // fold_div
    got, want = _both_fused(p, x, t, fold)
    np.testing.assert_allclose(got, want, **TOL)


def test_fused_bottleneck_row_tile_halo_and_clip_wrap():
    """JAX side tiled in 4-row tiles (halo rows between tiles), B = 3 clips
    (the shift must stop at every clip boundary)."""
    rng = np.random.default_rng(4)
    t, b, h, w, c, f = 2, 3, 16, 8, 16, 8
    p = _rand_params(rng, c, f, c, False)
    x = rng.standard_normal((b * t, h, w, c)).astype(np.float32)
    got, want = _both_fused(p, x, t, fold=2, row_tile=4)
    np.testing.assert_allclose(got, want, **TOL)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(5)
    scale, bias, mean = (rng.standard_normal(8).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, 8).astype(np.float32)
    want = np.asarray(j_fold_bn(*(jnp.asarray(a) for a in (scale, bias, mean, var)),
                                1e-5))
    got = _np(kernels.fold_bn(_t(scale), _t(bias), _t(mean), _t(var), 1e-5))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_preprocess_matches_jax():
    rng = np.random.default_rng(6)
    video = rng.integers(0, 256, (21, 6, 5, 3), dtype=np.uint8)
    starts = np.array([0, 4, 8, 15, 20, 21], np.int32)
    want = np.asarray(jpre.sparse_window_gather(jnp.asarray(video),
                                                jnp.asarray(starts), 8, 2))
    got = _np(tpre.sparse_window_gather(_t(video), _t(starts), 8, 2))
    np.testing.assert_array_equal(got, want)
    want_n = np.asarray(jpre.normalize_clip(jnp.asarray(video)))
    np.testing.assert_allclose(_np(tpre.normalize_clip(_t(video))), want_n,
                               rtol=1e-6, atol=1e-6)
    want_p = np.asarray(jpre.preprocess_windows(jnp.asarray(video),
                                                jnp.asarray(starts),
                                                num_frames=8, stride=1))
    got_p = _np(tpre.preprocess_windows(_t(video), _t(starts), 8, 1))
    np.testing.assert_allclose(got_p, want_p, rtol=1e-6, atol=1e-6)


def test_kernel_wrappers_refuse_other_devices():
    """A tensor that is neither on the CPU nor on CUDA is refused, never
    moved: the wrappers have no silent fallback."""
    x = torch.zeros((8, 2, 2, 16), device="meta")
    w = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError):
        kernels.temporal_shift(x, 4)
    with pytest.raises(ValueError):
        kernels.shift_matmul(x, w, 4)
    p = kernels.FusedBlockParams(w, torch.zeros(2, 16), torch.zeros(3, 3, 16, 16),
                                 torch.zeros(2, 16), w, torch.zeros(2, 16))
    with pytest.raises(ValueError):
        kernels.fused_bottleneck(x, p, n_segment=4, fold=2)


# ---------------------------------------------------------------- 1×1 backward


def test_conv1x1_dx_dw_plain_match_pallas():
    """The plain dx / dW against the Pallas kernels (interpret mode) at a
    two-tile row count."""
    from workoutdetector_tpu.ops.pallas.conv1x1 import _dw_pallas, _dx_pallas
    rng = np.random.default_rng(7)
    r, c, o = 1024, 64, 48
    g = rng.standard_normal((r, o)).astype(np.float32)
    wt = (rng.standard_normal((o, c)) * 0.1).astype(np.float32)
    x = rng.standard_normal((r, c)).astype(np.float32)
    want_dx = np.asarray(_dx_pallas(jnp.asarray(g), jnp.asarray(wt), 512, True))
    want_dw = np.asarray(_dw_pallas(jnp.asarray(x), jnp.asarray(g), 512, True))
    before = (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches)
    got_dx = _np(kernels.conv1x1_dx(_t(g), _t(wt)))
    got_dw = _np(kernels.conv1x1_dw(_t(x), _t(g)))
    assert (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches) == before
    assert got_dw.dtype == np.float32
    np.testing.assert_allclose(got_dx, want_dx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_dw, want_dw, rtol=1e-4, atol=1e-4)


# (B·T, H, W): rows 512, 1024, 192 and a ragged 75 (300 for the shifted
# conv, whose B·T is a multiple of T = 4), where the JAX package takes its
# XLA fallback; the port has no row-tile limit
VJP_ROWS = [(8, 8, 8), (16, 8, 8), (12, 4, 4), (3, 5, 5)]
SHIFT_VJP_ROWS = [(8, 8, 8), (16, 8, 8), (12, 4, 4), (12, 5, 5)]


def _vjp_inputs(rows_shape, c, o, seed):
    rng = np.random.default_rng(seed)
    bt, h, w = rows_shape
    x = rng.standard_normal((bt, h, w, c)).astype(np.float32)
    k = (rng.standard_normal((1, 1, c, o)) * .05).astype(np.float32)
    g = rng.standard_normal((bt, h, w, o)).astype(np.float32)
    return x, k, g


def _torch_vjp(fn, x, k, g):
    xt = _t(x).requires_grad_(True)
    wt = _t(k[0, 0]).requires_grad_(True)
    y = fn(xt, wt)
    y.backward(_t(g))
    return _np(y), _np(xt.grad), _np(wt.grad)


@pytest.mark.parametrize("rows_shape", VJP_ROWS)
def test_conv1x1_vjp_matches_make_conv1x1(rows_shape):
    import jax
    from workoutdetector_tpu.ops.pallas.conv1x1 import make_conv1x1
    x, k, g = _vjp_inputs(rows_shape, 64, 32, 8)
    y_j, vjp = jax.vjp(make_conv1x1(), jnp.asarray(x), jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(g))
    y, dx, dw = _torch_vjp(kernels.Conv1x1.apply, x, k, g)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(dk_j)[0, 0], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows_shape", SHIFT_VJP_ROWS)
def test_shift_conv1x1_vjp_matches_make_shift_conv1x1(rows_shape):
    import jax
    from workoutdetector_tpu.ops.pallas.conv1x1 import make_shift_conv1x1
    x, k, g = _vjp_inputs(rows_shape, 64, 32, 9)
    y_j, vjp = jax.vjp(make_shift_conv1x1(4, 8), jnp.asarray(x),
                       jnp.asarray(k))
    dx_j, dk_j = vjp(jnp.asarray(g))
    y, dx, dw = _torch_vjp(
        lambda a, b: kernels.ShiftConv1x1.apply(a, b, 4, 8), x, k, g)
    np.testing.assert_allclose(y, np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dx, np.asarray(dx_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(dw, np.asarray(dk_j)[0, 0], rtol=1e-4, atol=1e-4)


def test_shifted_dx_dw_plain_match_the_shift_transpose():
    """conv1x1_dx with a shift spec is Sᵀ(g Wᵀ) and conv1x1_dw is
    shift(x)ᵀ g, S the JAX temporal shift (its vjp gives Sᵀ)."""
    import jax
    rng = np.random.default_rng(10)
    t, hw, c, o = 4, 6, 32, 16
    x = rng.standard_normal((2 * t, 2, 3, c)).astype(np.float32)
    g = rng.standard_normal((2 * t * hw, o)).astype(np.float32)
    wt = (rng.standard_normal((o, c)) * 0.1).astype(np.float32)
    shifted, vjp = jax.vjp(lambda a: jts.temporal_shift_flat(a, t, 8),
                           jnp.asarray(x))
    dsh = (g @ wt).reshape(x.shape)
    want_dx = np.asarray(vjp(jnp.asarray(dsh))[0]).reshape(-1, c)
    want_dw = np.asarray(shifted).reshape(-1, c).T @ g
    np.testing.assert_allclose(
        _np(kernels.conv1x1_dx(_t(g), _t(wt), t, c // 8, hw)), want_dx,
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(kernels.conv1x1_dw(_t(x.reshape(-1, c)), _t(g), t, c // 8, hw)),
        want_dw, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("fold_div", [8, 4])
def test_temporal_shift_function_vjp_matches_jax(fold_div):
    """TemporalShift's backward (the shift reversed) equals jax.vjp of the
    JAX temporal shift."""
    import jax
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3 * 4, 2, 3, 16)).astype(np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    y_j, vjp = jax.vjp(lambda a: jts.temporal_shift_flat(a, 4, fold_div),
                       jnp.asarray(x))
    xt = _t(x).requires_grad_(True)
    y = kernels.TemporalShift.apply(xt, 4, fold_div)
    y.backward(_t(g))
    np.testing.assert_array_equal(_np(y), np.asarray(y_j))
    np.testing.assert_array_equal(_np(xt.grad),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_backward_kernel_wrappers_refuse_other_devices():
    g = torch.zeros((64, 16), device="meta")
    w = torch.zeros((16, 32), device="meta")
    with pytest.raises(ValueError):
        kernels.conv1x1_dx(g, w)
    with pytest.raises(ValueError):
        kernels.conv1x1_dw(torch.zeros((64, 32), device="meta"), g)
    with pytest.raises(ValueError):
        kernels.temporal_shift(torch.zeros((8, 2, 2, 16), device="meta"), 4,
                               reverse=True)
