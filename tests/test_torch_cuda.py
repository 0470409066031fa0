"""PyTorch port on the card: each hand kernel against its plain version.

Marked ``cuda``; each test skips without a CUDA device (the kernels have
no CPU mode). This file imports no jax, so on a machine with the card it
runs without the JAX package's test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the shift is a copy (exact). The GEMM and attention kernels
round once per stored tensor like their plain versions but sum in another
order (the attention kernels also round their unnormalised probabilities,
the plain version the normalised ones), so they may differ by a few bf16
ulps: |kernel − plain| ≤ (1 + |plain|) / 64, on every route: the
attention forward's one-block and tiled kernels (``fwd_route``), the
fused bottleneck's wgmma and WMMA kernels (``wgmma_route``). The attention backward
kernels round P and dS to bf16 where their plain version does, sum in
another order and recompute the scores in another operand order, and are
held to the same rule, on both routes of ``attention_bwd`` (the one-launch
kernel where ``short_route`` takes the shape, the tiled dK/dV and dQ
kernels beyond); the forward's fp32 log-sum-exp to 1e-3.
"""

import importlib

import numpy as np
import pytest
import torch

from workoutdetector_tpu_torch.ops import kernels

# the module (the package's name ``attention`` is its wrapper function)
ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    assert ((got - want).abs() <= (1 + want.abs()) / 64).all(), \
        float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_shift_kernel_exact(cuda_device, dtype):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2 * 8, 7, 5, 64, generator=g, device=cuda_device).to(dtype)
    before = kernels.temporal_shift.launches
    torch.testing.assert_close(kernels.temporal_shift(x, 8),
                               kernels.temporal_shift_plain(x, 8),
                               rtol=0, atol=0)
    assert kernels.temporal_shift.launches == before + 1


@pytest.mark.cuda
def test_cuda_shift_matmul_vs_plain(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn(3 * 8, 9, 7, 256, generator=g, device=cuda_device).bfloat16()
    w = (torch.randn(256, 144, generator=g, device=cuda_device) / 16).bfloat16()
    _close(kernels.shift_matmul(x, w, 8), kernels.shift_matmul_plain(x, w, 8))


def _sm_inputs(seed, frames, h, w, c, o):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(frames, h, w, c, generator=g, device="cuda").bfloat16()
    wt = (torch.randn(c, o, generator=g, device="cuda") / c ** 0.5).bfloat16()
    return x, wt


# (frames, H, W, C, O, T, fold_div): the shapes the kernel's walk makes
# special (clips of 392 rows, which 64-row tiles do not divide; a fold of
# 8 cutting a 16-deep k-step; a fold of 32 cutting the first K chunk; no
# fold; C = 72 (fold 8) and O = 16, a part chunk and a part column tile;
# O = 320, two column tiles; fold 24; fold 16, three passes in chunk 0, at
# BN = 128 and 256; fold = C / 2), then one shape of each TSM-R50 site
# class over 2 clips of 8 frames (inference and training: C -> O at 56²,
# 28², 14², 7²)
SM_SHAPES = [(16, 7, 7, 64, 64, 8, 8), (8, 4, 6, 256, 128, 4, 8),
             (8, 7, 7, 256, 64, 8, 512), (8, 5, 5, 72, 16, 4, 9),
             (8, 3, 3, 64, 320, 4, 8), (4, 5, 3, 192, 32, 4, 8),
             (8, 4, 5, 128, 128, 4, 8), (8, 4, 5, 64, 256, 4, 4),
             (4, 3, 3, 64, 32, 2, 2)]
SM_SITES = [(16, 56, 56, 64, 64, 8, 8), (16, 56, 56, 256, 64, 8, 8),
            (16, 56, 56, 256, 128, 8, 8), (16, 28, 28, 512, 128, 8, 8),
            (16, 28, 28, 512, 256, 8, 8), (16, 14, 14, 1024, 256, 8, 8),
            (16, 14, 14, 1024, 512, 8, 8), (16, 7, 7, 2048, 512, 8, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("frames,h,w,c,o,t,fold_div", SM_SHAPES + SM_SITES)
def test_cuda_shift_matmul_shapes_vs_plain(cuda_device, frames, h, w, c, o, t,
                                           fold_div):
    x, wt = _sm_inputs(11, frames, h, w, c, o)
    before = kernels.shift_matmul.launches
    got = kernels.shift_matmul(x, wt, t, fold_div)
    assert kernels.shift_matmul.launches == before + 1
    _close(got, kernels.shift_matmul_plain(x, wt, t, fold_div))


@pytest.mark.cuda
def test_cuda_shift_matmul_is_deterministic(cuda_device):
    """Each output element is summed by one warpgroup in a fixed order:
    equal bits every call, at layer2_0's shape over 2 clips."""
    x, wt = _sm_inputs(12, 16, 56, 56, 256, 128)
    first = kernels.shift_matmul(x, wt, 8)
    for _ in range(3):
        assert torch.equal(kernels.shift_matmul(x, wt, 8), first)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(256, 128), (64, 64)])
def test_cuda_shift_matmul_check_catches_swapped_folds(cuda_device, c, o):
    """A planted fault: the plain version with the two folds' directions
    swapped (the first fold reading frame t-1, the second t+1) must fail
    the check the kernel passes."""
    from workoutdetector_tpu_torch.ops.temporal_shift import shift_folds
    x, wt = _sm_inputs(13, 16, 7, 7, c, o)
    got = kernels.shift_matmul(x, wt, 8)
    _close(got, kernels.shift_matmul_plain(x, wt, 8))
    swapped = (shift_folds(x, 8, c // 8, reverse=True).float() @ wt.float()
               ).bfloat16()
    with pytest.raises(AssertionError):
        _close(got, swapped)


@pytest.mark.cuda
def test_cuda_shift_matmul_plan_is_the_kernels(cuda_device):
    """The walk in Python (shift_matmul.py: shift_matmul_plan) is the
    kernel's own (wd_shift_matmul_plan in csrc/shift_matmul.cu): tiles,
    ring, shared memory and every ring stage of a block tile; both refuse
    the same shapes."""
    import ctypes

    from workoutdetector_tpu_torch.ops.kernels import _build
    sm = importlib.import_module(
        "workoutdetector_tpu_torch.ops.kernels.shift_matmul")
    lib = _build.load().lib
    out = (ctypes.c_int64 * (10 + 3 * 64))()
    for m, hw, t in ((401408, 3136, 8), (6272, 49, 8), (490, 49, 10),
                     (36, 9, 4)):
        for c in (64, 72, 128, 192, 256, 1024, 2048):
            for o in (16, 64, 128, 144, 256, 320, 512):
                for fold in (0, 8, 16, 24, 32, c // 8, c // 2):
                    code = lib.wd_shift_matmul_plan(m, hw, t, c, o, fold, out, 64)
                    try:
                        plan = sm.shift_matmul_plan(m, hw, t, c, o, fold)
                    except ValueError:
                        assert code != 0, (m, hw, t, c, o, fold)
                        continue
                    assert code == 0, (m, hw, t, c, o, fold)
                    n = out[9]
                    assert tuple(out[:9]) == tuple(plan[:9]), (m, c, o, fold)
                    assert n == len(plan.steps)
                    assert tuple(tuple(out[10 + 3 * i:13 + 3 * i])
                                 for i in range(n)) == plan.steps


def _fused_params(rng, c, f, o, ds, device):
    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * np.sqrt(2 / np.prod(shape[:-1]))) \
            .to(device, torch.bfloat16)

    def sb(n):
        return torch.from_numpy(np.stack(
            [rng.uniform(0.5, 1.0, n), rng.normal(0, 0.1, n)]).astype(
                np.float32)).to(device)

    return kernels.FusedBlockParams(w(c, f), sb(f), w(3, 3, f, f), sb(f),
                                    w(f, o), sb(o), w(c, o) if ds else None,
                                    sb(o) if ds else None)


def _fused_launches():
    return (kernels.fused_bottleneck.launches,
            kernels.fused_bottleneck_wmma.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,o,ds,hw", [(64, 64, 256, True, (9, 21)),
                                         (256, 64, 256, False, (8, 16)),
                                         (512, 128, 512, False, (5, 7)),
                                         (256, 256, 256, False, (6, 6))])
def test_cuda_fused_bottleneck_vs_plain(cuda_device, c, f, o, ds, hw):
    """Each call launches the route ``wgmma_route`` names (F = 256: the
    WMMA kernel) and nothing else."""
    rng = np.random.default_rng(7)
    p = _fused_params(rng, c, f, o, ds, cuda_device)
    x = torch.from_numpy(rng.standard_normal((2 * 4,) + hw + (c,)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    route = (1, 0) if kernels.wgmma_route(c, f, o, ds) else (0, 1)
    for fold in (c // 8, 0):
        before = _fused_launches()
        got = kernels.fused_bottleneck(x, p, n_segment=4, fold=fold)
        assert tuple(a - b for a, b in zip(_fused_launches(), before)) == route
        _close(got, kernels.fused_bottleneck_plain(x, p, n_segment=4, fold=fold))


# TSM-R50's fused sites (C, F, O, downsample) at their fold C / 8 and at fold
# 0, on ragged frames (9 x 21: a partial last row of tiles and a partial last
# column, which also cuts the halo) and on frames of one tile, over clips of
# 4 frames (t = 0 and t = T - 1 in every clip)
FUSED_SITES = [(64, 64, 256, True), (256, 64, 256, False),
               (512, 128, 512, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(9, 21), (4, 16), (56, 56)])
@pytest.mark.parametrize("c,f,o,ds", FUSED_SITES)
def test_cuda_fused_bottleneck_sites_on_both_routes(cuda_device, c, f, o, ds,
                                                    hw):
    rng = np.random.default_rng(c + f + hw[0])
    p = _fused_params(rng, c, f, o, ds, cuda_device)
    x = torch.from_numpy(rng.standard_normal((3 * 4,) + hw + (c,)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    assert kernels.wgmma_route(c, f, o, ds)
    for fold in (c // 8, 0):
        want = kernels.fused_bottleneck_plain(x, p, n_segment=4, fold=fold)
        before = _fused_launches()
        _close(kernels.fused_bottleneck(x, p, n_segment=4, fold=fold), want)
        _close(kernels.fused_bottleneck_wmma(x, p, n_segment=4, fold=fold),
               want)
        assert _fused_launches() == (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_fused_bottleneck_is_deterministic(cuda_device):
    """Each output element has one writer and a fixed summation order:
    equal bits every call, at layer1_1's shape."""
    rng = np.random.default_rng(8)
    p = _fused_params(rng, 256, 64, 256, False, cuda_device)
    x = torch.from_numpy(rng.standard_normal((16, 56, 56, 256)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    first = kernels.fused_bottleneck(x, p, n_segment=8, fold=32)
    for _ in range(2):
        assert torch.equal(kernels.fused_bottleneck(x, p, n_segment=8, fold=32),
                           first)


@pytest.mark.cuda
def test_cuda_fused_bottleneck_refuses_unsupported(cuda_device):
    """fp32 operands, F % 32, O % 16, a fold not a multiple of 8, frames
    not a whole number of clips and weights left on the CPU raise before
    any launch, on either route."""
    rng = np.random.default_rng(9)
    p = _fused_params(rng, 64, 64, 256, True, cuda_device)
    x = torch.zeros(8, 4, 16, 64, device=cuda_device, dtype=torch.bfloat16)
    before = _fused_launches()
    for fn in (kernels.fused_bottleneck, kernels.fused_bottleneck_wmma):
        with pytest.raises(TypeError):
            fn(x.float(), p, n_segment=4, fold=8)
        with pytest.raises(ValueError):
            fn(x, p, n_segment=4, fold=4)
        with pytest.raises(ValueError):
            fn(x[:6], p, n_segment=4, fold=8)
        with pytest.raises(ValueError):
            fn(x, p._replace(w1=p.w1.cpu()), n_segment=4, fold=8)
        odd = _fused_params(rng, 64, 48, 256, True, cuda_device)
        with pytest.raises(ValueError):
            fn(x, odd, n_segment=4, fold=8)
    assert _fused_launches() == before


@pytest.mark.cuda
def test_cuda_fused_smem_rule_is_the_kernels(cuda_device):
    """The route rule's shared-memory sum (fused_block.py: wgmma_smem) is
    the kernel's own (wd_fused_bottleneck_smem in csrc/fused_block.cu), 0
    on both sides where the wgmma kernel does not take the shape."""
    from workoutdetector_tpu_torch.ops.kernels import _build
    from workoutdetector_tpu_torch.ops.kernels import fused_block as fb
    lib = _build.load().lib
    for c in (64, 72, 128, 256, 512, 1024):
        for f in (32, 64, 128, 256):
            for o in (64, 256, 512, 1024):
                for ds in (False, True):
                    assert lib.wd_fused_bottleneck_smem(c, f, o, int(ds)) == \
                        fb.wgmma_smem(c, f, o, ds), (c, f, o, ds)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_unsupported(cuda_device):
    x = torch.zeros(8, 4, 4, 64, device=cuda_device)  # fp32: no GEMM kernel
    with pytest.raises(TypeError):
        kernels.shift_matmul(x, torch.zeros(64, 16, device=cuda_device), 4)
    with pytest.raises(ValueError):  # weights left on the CPU
        kernels.shift_matmul(x.bfloat16(), torch.zeros(64, 16).bfloat16(), 4)


@pytest.mark.cuda
def test_cuda_shift_kernel_reverse_exact(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x = torch.randn(3 * 4, 5, 3, 64, generator=g, device=cuda_device).bfloat16()
    torch.testing.assert_close(
        kernels.temporal_shift(x, 4, reverse=True),
        kernels.temporal_shift_plain(x, 4, reverse=True), rtol=0, atol=0)


def _dw_close(got, want):
    """dW sums R products in fp32 in another order than the plain
    version: |kernel − plain| ≤ 1e-3·(1 + |plain|) at these magnitudes."""
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).abs() <= 1e-3 * (1 + want.abs())).all(), \
        float((got - want).abs().max())


# (frames, H, W, C, O, T, shifted): even and ragged row counts, narrow and
# wide channel counts, one and several (C, O) tiles and row splits
BWD_SHAPES = [(8, 7, 5, 64, 256, 4, True), (16, 14, 14, 256, 64, 8, True),
              (3, 5, 5, 64, 32, 1, False), (8, 7, 7, 2048, 512, 8, True),
              (2, 28, 28, 128, 512, 1, False)]
# two clips of 8 frames at every frame size of the TSM-R50 224² path (HW =
# 3136, 784, 196, 49), so row tiles and K chunks cross frame and clip ends;
# folds of 8, 32, 64, 128 and 256 columns (and TSM-R18's 16 at C = 128);
# C = O = 64 (narrow tiles, a single 64-deep K step for dx); 490 rows,
# which leave a ragged last tile
BWD_PATH_SHAPES = [(16, 56, 56, 64, 64, 8, True), (16, 56, 56, 256, 128, 8, True),
                   (16, 28, 28, 128, 128, 8, True),
                   (16, 28, 28, 512, 128, 8, True),
                   (16, 14, 14, 1024, 256, 8, True),
                   (16, 7, 7, 2048, 512, 8, True), (16, 7, 7, 512, 2048, 1, False),
                   (10, 7, 7, 256, 1024, 1, False)]


def _bwd_inputs(seed, r, c, o):
    """x (R, C), g (R, O) and W (C, O), bf16 on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(r, c, generator=g, device="cuda").bfloat16()
    gy = torch.randn(r, o, generator=g, device="cuda").bfloat16()
    w = (torch.randn(c, o, generator=g, device="cuda") / o ** 0.5).bfloat16()
    return x, gy, w


@pytest.mark.cuda
@pytest.mark.parametrize("frames,h,w,c,o,t,shifted", BWD_SHAPES + BWD_PATH_SHAPES)
def test_cuda_conv1x1_dx_dw_vs_plain(cuda_device, frames, h, w, c, o, t,
                                     shifted):
    r, fold = frames * h * w, (c // 8 if shifted else 0)
    x, gy, wgt = _bwd_inputs(3, r, c, o)
    spec = (t, fold, h * w)
    before = (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches)
    _close(kernels.conv1x1_dx(gy, wgt.t(), *spec),
           kernels.conv1x1_dx_plain(gy, wgt.t(), *spec))
    _dw_close(kernels.conv1x1_dw(x, gy, *spec),
              kernels.conv1x1_dw_plain(x, gy, *spec))
    assert (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_conv1x1_dw_is_deterministic(cuda_device):
    """The row splits are summed in a fixed order: equal bits every call."""
    x, gy, _ = _bwd_inputs(4, 8 * 56 * 56, 64, 256)
    first = kernels.conv1x1_dw(x, gy, 8, 8, 56 * 56)
    for _ in range(3):
        assert torch.equal(kernels.conv1x1_dw(x, gy, 8, 8, 56 * 56), first)


@pytest.mark.cuda
@pytest.mark.parametrize("c,o", [(64, 64), (1024, 256)])
def test_cuda_conv1x1_dx_is_deterministic(cuda_device, c, o):
    """Each dx element is summed by one warpgroup in a fixed order and
    stored by one writer: equal bits every call."""
    _, gy, w = _bwd_inputs(6, 16 * 14 * 14, c, o)
    first = kernels.conv1x1_dx(gy, w.t(), 8, c // 8, 14 * 14)
    for _ in range(3):
        assert torch.equal(kernels.conv1x1_dx(gy, w.t(), 8, c // 8, 14 * 14),
                           first)


@pytest.mark.cuda
def test_cuda_conv1x1_dx_reads_the_weight_as_it_lies(cuda_device):
    """The dx kernel takes W (C, O) through ``w.t()``; a contiguous (O, C)
    Wᵀ, whose transpose is not contiguous, is refused, not copied."""
    _, gy, w = _bwd_inputs(7, 64, 64, 32)
    with pytest.raises(ValueError):
        kernels.conv1x1_dx(gy, w.t().contiguous())


@pytest.mark.cuda
def test_cuda_train_steps_repeat_bit_for_bit(cuda_device):
    """Two identical 2-step runs of the trainer on the card (TSM-R50 at
    64 px, bf16) end with bit-identical parameters."""
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.train.trainer import Trainer

    def run():
        cfg = Config()
        cfg.model.num_segments = cfg.data.num_segments = 4
        cfg.model.num_class = 3
        state_x = np.random.default_rng(5).integers(
            0, 256, (2, 4, 64, 64, 3), dtype=np.uint8)
        trainer = Trainer(cfg, device=cuda_device)
        state = trainer.init_state(steps_per_epoch=10)
        for _ in range(2):
            trainer.train_step(state, state_x, np.array([0, 2], np.int32))
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in state.model.state_dict().items()}

    a, b = run(), run()
    assert all(torch.equal(a[k], b[k]) for k in a)


def _qkv(g, n, h, l, dh, packed):
    """q, k, v (n, h, l, dh) bf16: thirds of a packed (n, l, 3·h·dh)
    projection as strided views (TimeSformer's MHA), or contiguous."""
    d = h * dh
    if packed:
        qkv = torch.randn(n, l, 3 * d, generator=g, device=g.device).bfloat16()
        return [t.view(n, l, h, dh).transpose(1, 2)
                for t in qkv.split(d, dim=-1)]
    return [torch.randn(n, h, l, dh, generator=g, device=g.device).bfloat16()
            for _ in range(3)]


def _fwd_launches():
    return kernels.attention.launches, kernels.attention_tiled.launches


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("l", [1, 8, 17, 197, 300])
def test_cuda_attention_vs_plain(cuda_device, l, packed):
    """``attention`` launches the route ``fwd_route`` names: the one-block
    kernel up to l = 256, the tiled one beyond."""
    g = torch.Generator(device=cuda_device).manual_seed(l)
    q, k, v = _qkv(g, 3, 4, l, 64, packed)
    before = _fwd_launches()
    got = kernels.attention(q, k, v, 0.125)
    route = (1, 0) if kernels.fwd_route(l, 64) else (0, 1)
    assert tuple(a - b for a, b in zip(_fwd_launches(), before)) == route
    assert got.shape == (3, 4, l, 64)
    assert got.transpose(1, 2).is_contiguous()  # (n, l, h, dh) buffer
    _close(got, kernels.attention_plain(q, k, v, 0.125))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("l", [1, 17, 197, 208, 209, 256, 325])
def test_cuda_attention_forward_routes_vs_plain(cuda_device, l, packed):
    """o and lse of both forward routes against attention_lse_plain: the
    one-block kernel where ``fwd_route`` takes l (through
    ``attention_lse``), the tiled kernel at every l (``attention_tiled``);
    lse within 1e-3."""
    g = torch.Generator(device=cuda_device).manual_seed(300 + l)
    q, k, v = _qkv(g, 3, 4, l, 64, packed)
    o_ref, lse_ref = kernels.attention_lse_plain(q, k, v, 0.125)
    before = _fwd_launches()
    o, lse = kernels.attention_tiled(q, k, v, 0.125, with_lse=True)
    assert _fwd_launches() == (before[0], before[1] + 1)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max() <= 1e-3
    if kernels.fwd_route(l, 64):
        o, lse = kernels.attention_lse(q, k, v, 0.125)
        assert _fwd_launches() == (before[0] + 1, before[1] + 1)
        _close(o, o_ref)
        assert (lse - lse_ref).abs().max() <= 1e-3


@pytest.mark.cuda
def test_cuda_attention_fwd_smem_rule_is_the_kernels(cuda_device):
    """The forward's route rule (attention.py: fwd_smem, fwd_route) is the
    kernel's own shared-memory reckoning (wd_attention_fwd_smem in
    csrc/attention_fwd.cu), 0 where the one-block kernel does not take l."""
    from workoutdetector_tpu_torch.ops.kernels import _build
    lib = _build.load().lib
    for l in list(range(0, 260)) + [300, 325, 400]:
        assert lib.wd_attention_fwd_smem(l) == ka.fwd_smem(l), l
        assert (lib.wd_attention_fwd_smem(l) > 0) is ka.fwd_route(l, 64), l


@pytest.mark.cuda
def test_cuda_attention_tiled_is_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = _qkv(g, 8, 12, 325, 64, True)
    a, la = kernels.attention_tiled(q, k, v, 0.125, with_lse=True)
    b, lb = kernels.attention_tiled(q, k, v, 0.125, with_lse=True)
    assert torch.equal(a, b) and torch.equal(la, lb)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 128])
def test_cuda_attention_head_widths(cuda_device, dh):
    """Head widths other than 64 take the tiled route."""
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    q, k, v = _qkv(g, 2, 3, 197, dh, True)
    before = _fwd_launches()
    _close(kernels.attention(q, k, v, dh ** -0.5),
           kernels.attention_plain(q, k, v, dh ** -0.5))
    assert _fwd_launches() == (before[0], before[1] + 1)


@pytest.mark.cuda
def test_cuda_attention_refuses_unsupported(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = _qkv(g, 2, 2, 9, 24, False)
    with pytest.raises(ValueError, match="head width"):
        kernels.attention(q, k, v, 0.2)
    q, k, v = _qkv(g, 2, 2, 9, 64, False)
    with pytest.raises(TypeError):
        kernels.attention(q.float(), k.float(), v.float(), 0.125)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.attention(q, k.cpu(), v, 0.125)
    # forward only: under autograd the caller runs Attention on the packed
    # projection (test_cuda_attention_function_packed_gradient)
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Attention.apply"):
        kernels.attention(q, k, v, 0.125)
    with torch.no_grad():  # inference under no_grad launches
        before = kernels.attention.launches
        kernels.attention(q, k, v, 0.125)
        assert kernels.attention.launches == before + 1
    for fn in (kernels.attention_tiled, kernels.attention_lse):
        with pytest.raises(TypeError):
            fn(q.float(), k.float(), v.float(), 0.125)
        with pytest.raises(ValueError, match="tensors on"):
            fn(q, k.cpu(), v, 0.125)


@pytest.mark.cuda
def test_cuda_attention_is_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q, k, v = _qkv(g, 16, 12, 197, 64, True)
    assert torch.equal(kernels.attention(q, k, v, 0.125),
                       kernels.attention(q, k, v, 0.125))


@pytest.mark.cuda
def test_cuda_timesformer_runs_the_attention_kernel(cuda_device):
    """A small divided TimeSformer (bf16) on the card: one attention launch
    per block, logits within bf16 rounding of the plain bf16 model."""
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (TimeSformer,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    def engine(use_kernels):
        m = TimeSformer(3, 4, 32, 8, 128, 2, 2, dtype=torch.bfloat16,
                        use_kernels=use_kernels)
        load_flax_variables(m, random_flax_variables(m, seed=0))
        return InferenceEngine(m, 4, 2, device=cuda_device)

    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3),
                                              dtype=np.uint8)
    before = kernels.attention.launches
    got = engine(True).score_windows(clips)
    assert kernels.attention.launches == before + 2
    want = engine(False).score_windows(clips)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05 * (1 + np.abs(want).max())


def launches():
    """(forward, one-launch backward, tiled dK/dV, tiled dQ) launches."""
    return (kernels.attention.launches, kernels.attention_bwd.launches,
            kernels.attention_dkv.launches, kernels.attention_dq.launches)


def _residuals(g, n, h, l, dh, packed, scale):
    """q, k, v (packed or contiguous), the plain forward's o and lse, an
    output gradient and D = rowsum(dO ∘ O) (which the tiled kernels read)."""
    from workoutdetector_tpu_torch.ops.kernels.attention import attention_delta
    q, k, v = _qkv(g, n, h, l, dh, packed)
    o, lse = kernels.attention_lse_plain(q, k, v, scale)
    do = torch.randn(n, h, l, dh, generator=g, device=g.device).bfloat16()
    return q, k, v, o, lse, do, attention_delta(o, do)


def _grads_out(n, h, l, dh, packed, device):
    """dq, dk, dv to write into: thirds of one packed (n, l, 3·h·dh)
    gradient (the model's layout), or None (the wrappers allocate)."""
    if not packed:
        return None, None, None
    return kernels.split_heads(
        torch.empty(n, l, 3 * h * dh, dtype=torch.bfloat16, device=device), h)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("l", [1, 8, 17, 197, 300])
def test_cuda_attention_bwd_vs_plain(cuda_device, l, packed):
    """The tiled dK/dV and dQ kernels, called directly, against
    attention_bwd_plain on the same residuals, reading strided thirds of a
    packed qkv and writing into the thirds of a packed gradient, or
    contiguous tensors."""
    g = torch.Generator(device=cuda_device).manual_seed(l)
    q, k, v, o, lse, do, delta = _residuals(g, 3, 4, l, 64, packed, 0.125)
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    dq, dk, dv = _grads_out(3, 4, l, 64, packed, cuda_device)
    before = launches()
    dk, dv = kernels.attention_dkv(q, k, v, do, lse, delta, 0.125, dk, dv)
    dq = kernels.attention_dq(q, k, v, do, lse, delta, 0.125, dq)
    assert launches() == (before[0], before[1], before[2] + 1, before[3] + 1)
    for got, ref in zip((dq, dk, dv), want):
        _close(got, ref)


def _route(l, dh):
    """The launches ``attention_bwd`` should add on each route: (0, 1, 0, 0)
    for the one-launch kernel, (0, 0, 1, 1) for the tiled kernels."""
    return (0, 1, 0, 0) if kernels.short_route(l, dh) else (0, 0, 1, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("l", [1, 8, 16, 17, 64, 65, 197, 224, 225, 256, 257,
                               300])
def test_cuda_attention_bwd_routes_vs_plain(cuda_device, l, packed):
    """``attention_bwd`` (D, dQ, dK, dV from o and lse) against
    attention_bwd_plain at lengths up to the one-launch kernel's limit (l =
    224 at dh 64), one past it and beyond, on packed thirds written into a
    packed gradient or on contiguous tensors; each call launches the route
    ``short_route`` names and nothing else."""
    g = torch.Generator(device=cuda_device).manual_seed(l)
    q, k, v, o, lse, do, _ = _residuals(g, 3, 4, l, 64, packed, 0.125)
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    outs = _grads_out(3, 4, l, 64, packed, cuda_device)
    before = launches()
    got = kernels.attention_bwd(q, k, v, o, lse, do, 0.125, *outs)
    assert tuple(a - b for a, b in zip(launches(), before)) == _route(l, 64)
    if packed:
        assert all(a.data_ptr() == b.data_ptr() for a, b in zip(got, outs))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", ka.HEAD_DIMS)
def test_cuda_attention_bwd_every_head_width(cuda_device, dh):
    """Every head width the kernels take, at l = 197: dh 64 on the
    one-launch kernel, the others (no 128-byte panel) on the tiled route."""
    g = torch.Generator(device=cuda_device).manual_seed(200 + dh)
    s = dh ** -0.5
    q, k, v, o, lse, do, _ = _residuals(g, 2, 3, 197, dh, True, s)
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, s)
    before = launches()
    got = kernels.attention_bwd(q, k, v, o, lse, do, s)
    assert tuple(a - b for a, b in zip(launches(), before)) == _route(197, dh)
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
def test_cuda_attention_bwd_one_launch_is_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(8)
    q, k, v, o, lse, do, _ = _residuals(g, 16, 12, 197, 64, True, 0.125)
    first = kernels.attention_bwd(q, k, v, o, lse, do, 0.125)
    second = kernels.attention_bwd(q, k, v, o, lse, do, 0.125)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.cuda
def test_cuda_attention_bwd_one_launch_refuses_unsupported(cuda_device):
    """Non-bf16 tensors, tensors on two devices and an lse of the wrong
    shape raise before any launch."""
    g = torch.Generator(device=cuda_device).manual_seed(9)
    q, k, v, o, lse, do, _ = _residuals(g, 2, 2, 33, 64, True, 0.125)
    before = launches()
    with pytest.raises(TypeError):
        kernels.attention_bwd(q.float(), k.float(), v.float(), o.float(), lse,
                              do.float(), 0.125)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.attention_bwd(q, k, v.cpu(), o, lse, do, 0.125)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.attention_bwd(q, k, v, o.cpu(), lse, do, 0.125)
    with pytest.raises(ValueError, match="lse"):
        kernels.attention_bwd(q, k, v, o, lse.cpu(), do, 0.125)
    with pytest.raises(ValueError, match="lse"):
        kernels.attention_bwd(q, k, v, o, lse[:, :, :-1].contiguous(), do, 0.125)
    assert launches() == before


@pytest.mark.cuda
def test_cuda_attention_bwd_smem_rule_is_the_kernels(cuda_device):
    """The route rule's shared-memory sum (attention.py) is the kernel's own
    (wd_attention_bwd_smem in csrc/attention_bwd_short.cu)."""
    from workoutdetector_tpu_torch.ops.kernels import _build
    lib = _build.load().lib
    for l in (1, 16, 17, 64, 197, 208, 224, 225, 256, 300):
        assert lib.wd_attention_bwd_smem(l) == ka.short_smem(l), l


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_cuda_attention_bwd_head_widths(cuda_device, dh):
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    s = dh ** -0.5
    q, k, v, o, lse, do, delta = _residuals(g, 2, 3, 197, dh, True, s)
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do, s)
    got = (kernels.attention_dq(q, k, v, do, lse, delta, s),
           *kernels.attention_dkv(q, k, v, do, lse, delta, s))
    for a, b in zip(got, want):
        _close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("l", [1, 17, 197, 300])
def test_cuda_attention_lse_vs_plain(cuda_device, l):
    """The forward's log-sum-exp (fp32 sums in another order, exp2/log2)
    within 1e-3 of the plain version's; its o as the inference forward's."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + l)
    q, k, v = _qkv(g, 3, 4, l, 64, True)
    o, lse = kernels.attention_lse(q, k, v, 0.125)
    o_ref, lse_ref = kernels.attention_lse_plain(q, k, v, 0.125)
    assert lse.shape == (3, 4, l) and lse.dtype == torch.float32
    assert (lse - lse_ref).abs().max() <= 1e-3
    assert torch.equal(o, kernels.attention(q, k, v, 0.125))
    _close(o, o_ref)


@pytest.mark.cuda
def test_cuda_attention_bwd_is_deterministic(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    q, k, v, o, lse, do, delta = _residuals(g, 16, 12, 197, 64, True, 0.125)

    def run():
        return (kernels.attention_dq(q, k, v, do, lse, delta, 0.125),
                *kernels.attention_dkv(q, k, v, do, lse, delta, 0.125))

    assert all(torch.equal(a, b) for a, b in zip(run(), run()))


@pytest.mark.cuda
def test_cuda_attention_bwd_refuses_unsupported(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, o, lse, do, delta = _residuals(g, 2, 2, 9, 24, False, 0.2)
    with pytest.raises(ValueError, match="head width"):
        kernels.attention_dkv(q, k, v, do, lse, delta, 0.2)
    q, k, v, o, lse, do, delta = _residuals(g, 2, 2, 9, 64, False, 0.125)
    with pytest.raises(TypeError):
        kernels.attention_dq(q.float(), k.float(), v.float(), do.float(),
                             lse, delta, 0.125)
    with pytest.raises(ValueError, match="tensors on"):
        kernels.attention_dkv(q, k, v.cpu(), do, lse, delta, 0.125)
    with pytest.raises(ValueError, match="lse and delta"):
        kernels.attention_dq(q, k, v, do, lse.cpu(), delta, 0.125)


@pytest.mark.cuda
def test_cuda_attention_function_packed_gradient(cuda_device):
    """``Attention`` on a packed qkv at l = 197: one forward and one
    one-launch backward, dqkv the packed layout of attention_bwd_plain's
    gradients on the kernel's own residuals."""
    from workoutdetector_tpu_torch.ops.kernels.attention import attention_delta
    g = torch.Generator(device=cuda_device).manual_seed(4)
    n, h, l, dh = 4, 12, 197, 64
    qkv = torch.randn(n, l, 3 * h * dh, generator=g,
                      device=cuda_device).bfloat16().requires_grad_(True)
    before = launches()
    out = kernels.Attention.apply(qkv, h, 0.125)
    do = torch.randn(out.shape, generator=g, device=cuda_device).bfloat16()
    out.backward(do)
    assert launches() == (before[0] + 1, before[1] + 1, before[2], before[3])
    q, k, v = kernels.split_heads(qkv.detach(), h)
    o, lse = kernels.attention_lse(q, k, v, 0.125)
    (do4,) = kernels.split_heads(do, h, parts=1)
    assert attention_delta(o, do4).shape == (n, h, l)
    want = kernels.attention_bwd_plain(q, k, v, o, lse, do4, 0.125)
    for got, ref in zip(kernels.split_heads(qkv.grad, h), want):
        _close(got, ref)


@pytest.mark.cuda
def test_cuda_timesformer_train_step_runs_the_backward_kernels(cuda_device):
    """A small divided TimeSformer train step (bf16) on the card: per block
    one attention and one one-launch backward (l = 17), finite nonzero
    gradients."""
    from workoutdetector_tpu_torch.models import (TimeSformer,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    m = TimeSformer(3, 4, 32, 8, 128, 2, 2, dtype=torch.bfloat16,
                    drop_path_rate=0.1)
    load_flax_variables(m, random_flax_variables(m, seed=0))
    m = m.to(cuda_device).train()
    x = torch.randn(2, 4, 32, 32, 3, device=cuda_device)
    before = launches()
    logits = m(x, dropout_generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    logits.sum().backward()
    assert launches() == (before[0] + 2, before[1] + 2, before[2], before[3])
    for name, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name
        assert p.grad.abs().max() > 0, name


@pytest.mark.cuda
def test_cuda_video_staged_from_threads_scores_as_a_synchronous_copy(
        cuda_device):
    """``stage_video`` from decode threads (a pinned copy on the engine's
    copy stream, waited on by ``score_staged``) gives the logits of a
    synchronous pageable copy on the current stream, bit for bit."""
    from concurrent.futures import ThreadPoolExecutor

    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import TSM, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    model = TSM(4, 8, "resnet50", dtype=torch.bfloat16)
    load_flax_variables(model, random_flax_variables(model, seed=0))
    engine = InferenceEngine(model, 8, 2, device=cuda_device)
    rng = np.random.default_rng(0)
    videos = [rng.integers(0, 256, (t, 224, 224, 3), dtype=np.uint8)
              for t in (37, 20, 5)]
    with ThreadPoolExecutor(2) as pool:
        staged = list(pool.map(engine.stage_video, videos))
    for video, s in zip(videos, staged):
        assert s.ready is not None and s.host.is_pinned()
        starts = engine.windows_for_video(len(video))
        got = engine.score_staged(s, starts)
        sync = engine.stage_video(video, pin_memory=False)
        assert sync.ready is None and sync.video.device.type == "cuda"
        assert got.shape == (len(starts), 4) and np.isfinite(got).all()
        assert np.array_equal(got, engine.score_staged(sync, starts))
        assert np.array_equal(got, engine.score_video(video)[1])


@pytest.mark.cuda
def test_cuda_ops_are_the_wrappers(cuda_device):
    """The ``wd::`` ops called directly launch what the wrappers launch and
    give their results bit for bit; an op handed what its kernel does not
    take raises, it does not fall back."""
    rng = np.random.default_rng(11)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(cuda_device, torch.bfloat16)

    x, w = bf16(8, 7, 9, 64), bf16(64, 128)
    assert torch.equal(torch.ops.wd.shift_matmul(x, w, 4, 8),
                       kernels.shift_matmul(x, w, 4))
    assert torch.equal(torch.ops.wd.temporal_shift(x, 4, 8, True),
                       kernels.temporal_shift(x, 4, reverse=True))
    p = _fused_params(rng, 64, 64, 256, True, cuda_device)
    assert torch.equal(torch.ops.wd.fused_bottleneck(x, *p, 4, 8),
                       kernels.fused_bottleneck(x, p, n_segment=4, fold=8))
    q, k, v = kernels.split_heads(bf16(6, 197, 3 * 2 * 64), 2)
    o, lse = torch.ops.wd.attention(q, k, v, 0.125, True)
    o2, lse2 = kernels.attention_lse(q, k, v, 0.125)
    assert torch.equal(o.transpose(1, 2), o2) and torch.equal(lse, lse2)
    before = kernels.launch_counts()
    with pytest.raises(TypeError):
        torch.ops.wd.shift_matmul(x.float(), w, 4, 8)
    with pytest.raises(ValueError):
        torch.ops.wd.attention(q, k, v[:, :, :100], 0.125, False)
    assert kernels.launch_counts() == before


@pytest.mark.cuda
def test_cuda_artifacts_launch_the_live_engines_kernels(cuda_device, tmp_path):
    """An artifact exported on the card launches per forward the hand
    kernels the live engine launches (TSM-R50: 10 shift-matmul and 6
    fused-bottleneck; a TimeSformer: one attention a layer), and scores
    within the kernels' rule of it."""
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (TSM, TimeSformer,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.utils.export import export_model

    rng = np.random.default_rng(12)
    for model, t, size, want in (
            (TSM(4, 8, "resnet50", dtype=torch.bfloat16), 8, 64,
             {"shift_matmul": 10, "fused_bottleneck": 6}),
            (TimeSformer(4, 4, 32, 8, 128, 2, 2, dtype=torch.bfloat16), 4, 32,
             {"attention": 2})):
        load_flax_variables(model, random_flax_variables(model, seed=0))
        live = InferenceEngine(model, t, 2, image_size=size,
                               device=cuda_device)
        path = export_model(model, str(tmp_path / "m"), (2, t, size, size, 3),
                            device=cuda_device)
        art = InferenceEngine.from_exported(path, device=cuda_device)
        x = rng.integers(0, 256, (2, t, size, size, 3), dtype=np.uint8)
        counts = []
        for eng in (live, art):
            eng.score_windows(x)
            kernels.reset_launches()
            got = eng.score_windows(x)
            counts.append({k: n for k, n in kernels.launch_counts().items()
                           if n})
            if eng is live:
                ref = got
        assert counts[0] == counts[1] == want
        _close(torch.from_numpy(got), torch.from_numpy(ref))


@pytest.mark.cuda
def test_cuda_tpn_launches_and_logits_vs_plain(cuda_device):
    """TPN-R50 at 64 px (bf16) launches TSM-R50's kernels, 6 fused and 10
    shift-matmul a forward, and 16 shift-matmul, 33 dx and 33 dW a train
    step; its logits keep the plain fp32 model's argmax within the logit
    rule of chip_smoke.py (0.05 · (1 + max|logit|))."""
    from workoutdetector_tpu_torch.models import TPN, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import train_loss

    model = TPN(4, 8, "resnet50", dtype=torch.bfloat16)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    ref = TPN(4, 8, "resnet50", use_kernels=False)
    load_flax_variables(ref, variables)
    model, ref = model.to(cuda_device), ref.to(cuda_device)
    x = torch.randn(2, 8, 64, 64, 3, generator=torch.Generator().manual_seed(0)
                    ).to(cuda_device)
    kernels.reset_launches()
    with torch.no_grad():
        got, want = model(x), ref(x)
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"shift_matmul": 10, "fused_bottleneck": 6}
    err = (got - want).abs().max()
    assert torch.isfinite(got).all() and err <= 0.05 * (1 + want.abs().max())
    margin = want.topk(2, dim=1).values
    decided = (margin[:, 0] - margin[:, 1]) > 2 * err
    assert (got.argmax(1) == want.argmax(1))[decided].all()

    model.train()
    kernels.reset_launches()
    out = model(x, dropout_generator=torch.Generator(
        device=cuda_device).manual_seed(0))
    loss, _ = train_loss(out, torch.tensor([0, 3], device=cuda_device), 0.5)
    loss.backward()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"shift_matmul": 16, "conv1x1_dx": 33, "conv1x1_dw": 33}
    assert torch.isfinite(loss)


# the image ResNet-50's fused sites (C, F, O, downsample): stride-1 blocks of
# stages 0-1 on single 224² images (56² and 28² maps), no shift
IMAGE_FUSED_SITES = [(64, 64, 256, True, 56), (256, 64, 256, False, 56),
                     (512, 128, 512, False, 28)]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 16])
@pytest.mark.parametrize("c,f,o,ds,hw", IMAGE_FUSED_SITES)
def test_cuda_fused_bottleneck_image_sites(cuda_device, c, f, o, ds, hw, n):
    """The image path's calls: n_segment 1, fold 0, on one image, on a
    ragged batch of 3 and on a 16-image batch; the wgmma route, one launch
    each, against the plain version."""
    rng = np.random.default_rng(c + n)
    p = _fused_params(rng, c, f, o, ds, cuda_device)
    x = torch.from_numpy(rng.standard_normal((n, hw, hw, c)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    assert kernels.wgmma_route(c, f, o, ds)
    before = _fused_launches()
    _close(kernels.fused_bottleneck(x, p, n_segment=1, fold=0),
           kernels.fused_bottleneck_plain(x, p, n_segment=1, fold=0))
    assert _fused_launches() == (before[0] + 1, before[1])


# the image ResNet-50's 1×1 backward sites at lit_img.yaml's batch of 64
# 224² images (frames, H, W, C, O): conv1 and conv3 of each stage, the
# stage-0 downsample, every one unshifted
IMAGE_BWD_SHAPES = [(64, 56, 56, 64, 64), (64, 56, 56, 256, 64),
                    (64, 56, 56, 64, 256), (64, 28, 28, 512, 128),
                    (64, 28, 28, 128, 512), (64, 14, 14, 1024, 256),
                    (64, 14, 14, 256, 1024), (64, 7, 7, 2048, 512),
                    (64, 7, 7, 512, 2048)]


@pytest.mark.cuda
@pytest.mark.parametrize("frames,h,w,c,o", IMAGE_BWD_SHAPES)
def test_cuda_conv1x1_dx_dw_image_sites(cuda_device, frames, h, w, c, o):
    """dx by the elementwise rule; dW, sums of up to 200,704 products
    here, by chip_smoke.py's rule for such sums: the fp32 rounding of a
    sum scales with the sizes of its terms, not with the entry, so an
    entry that nearly cancels carries an error of the row sums' order:
    |kernel − plain| ≤ 1e-4·max|plain| (a wrong row split or shift errs by
    the order of max|plain|)."""
    r = frames * h * w
    x, gy, wgt = _bwd_inputs(5, r, c, o)
    before = (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches)
    _close(kernels.conv1x1_dx(gy, wgt.t()), kernels.conv1x1_dx_plain(gy, wgt.t()))
    got, want = kernels.conv1x1_dw(x, gy), kernels.conv1x1_dw_plain(x, gy)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (got - want).abs().max() <= 1e-4 * want.abs().max()
    assert (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_image_resnet50_launches_and_logits_vs_plain(cuda_device):
    """The image ResNet-50 (bf16, 64 px) launches 6 fused bottlenecks a
    forward and 33 dx + 33 dW a train step, nothing else; its logits within
    chip_smoke.py's rule of the fp32 plain model's."""
    from workoutdetector_tpu_torch.models import (ImageClassifier,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import cross_entropy

    model = ImageClassifier("resnet50", 2, dtype=torch.bfloat16)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    ref = ImageClassifier("resnet50", 2, use_kernels=False)
    load_flax_variables(ref, variables)
    model, ref = model.to(cuda_device), ref.to(cuda_device)
    x = torch.randn(5, 1, 64, 64, 3, generator=torch.Generator().manual_seed(0)
                    ).to(cuda_device)
    kernels.reset_launches()
    with torch.no_grad():
        got, want = model(x), ref(x)
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"fused_bottleneck": 6}
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 0.05 * (1 + want.abs().max())
    model.train()
    kernels.reset_launches()
    loss = cross_entropy(model(x), torch.tensor([0, 1, 1, 0, 1],
                                                device=cuda_device)).mean()
    loss.backward()
    counts = {k: n for k, n in kernels.launch_counts().items() if n}
    assert counts == {"conv1x1_dx": 33, "conv1x1_dw": 33}
    assert torch.isfinite(loss)


@pytest.mark.cuda
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_cuda_moe_mlp_routes_and_computes_as_the_cpu(cuda_device, cf):
    """``MoEMlp`` in fp32 on the card against its CPU result on identical
    inputs: the same experts and slots for every token (dropped tokens
    too, at capacity factor 0.5), outputs and the load-balance loss within
    1e-4, gradients of the router and the experts within 1e-4."""
    from workoutdetector_tpu_torch.models import MoEMlp, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    m = MoEMlp(64, 256, 8, cf)
    load_flax_variables(m, random_flax_variables(m, seed=0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (4, 50, 64)).astype(np.float32))
    outs = []
    for dev in ("cpu", cuda_device):
        mm = m.to(dev)
        mm.zero_grad()
        route = [r.cpu() if torch.is_tensor(r) else r
                 for r in mm.route(x.to(dev).reshape(-1, 64))]
        y, loss = mm(x.to(dev))
        (y.square().sum() + loss).backward()
        # copies: moving the module moves the gradients it holds too
        outs.append((route, y.detach().cpu(), float(loss.detach()),
                     {n: p.grad.detach().cpu().clone()
                      for n, p in mm.named_parameters()}))
    (r0, y0, l0, g0), (r1, y1, l1, g1) = outs
    assert torch.equal(r0[1], r1[1]) and torch.equal(r0[2], r1[2])
    assert r0[3] == r1[3]
    if cf < 1:
        assert (r0[2] > r0[3]).any()
    torch.testing.assert_close(y1, y0, rtol=1e-4, atol=1e-4)
    assert abs(l1 - l0) < 1e-5
    for n in g0:
        torch.testing.assert_close(g1[n], g0[n], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_moe_timesformer_runs_the_attention_kernels(cuda_device):
    """A small divided MoE TimeSformer (bf16) on the card: one attention
    launch per block a forward, one more and one backward launch per block
    a train step (l = 17), logits within bf16 rounding of the plain bf16
    model, finite gradients for every expert leaf and the routers."""
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (TimeSformer,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import train_loss

    def model(use_kernels):
        m = TimeSformer(3, 4, 32, 8, 128, 2, 2, dtype=torch.bfloat16,
                        use_kernels=use_kernels, moe_experts=4)
        load_flax_variables(m, random_flax_variables(m, seed=0))
        return m

    clips = np.random.default_rng(0).integers(0, 256, (2, 4, 32, 32, 3),
                                              dtype=np.uint8)
    before = launches()
    got = InferenceEngine(model(True), 4, 2, device=cuda_device) \
        .score_windows(clips)
    assert launches() == (before[0] + 2,) + before[1:]
    want = InferenceEngine(model(False), 4, 2, device=cuda_device) \
        .score_windows(clips)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 0.05 * (1 + np.abs(want).max())
    m = model(True).to(cuda_device).train()
    before = launches()
    loss, _ = train_loss(m(torch.randn(2, 4, 32, 32, 3, device=cuda_device)),
                         torch.tensor([0, 2], device=cuda_device), 0.5, 0.01)
    loss.backward()
    assert launches() == (before[0] + 2, before[1] + 2) + before[2:]
    for name, p in m.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), name


@pytest.mark.cuda
def test_cuda_repnet_frame_logits_vs_cpu(cuda_device):
    """The tiny RepNet's per-frame logits in fp32 on the card against the
    CPU within 1e-4, and the bf16 model within bf16 rounding; no hand
    kernel launches (RepNet has none)."""
    from workoutdetector_tpu_torch.models import RepNet, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    m = RepNet(16, 4, 8, 16, 2)
    variables = random_flax_variables(m, seed=0)
    load_flax_variables(m, variables)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, 24, 24, 3)).astype(np.float32))
    counts = kernels.launch_counts()
    with torch.no_grad():
        want = m(x, per_frame=True)
        got = m.to(cuda_device)(x.to(cuda_device), per_frame=True).cpu()
        half = RepNet(16, 4, 8, 16, 2, dtype=torch.bfloat16)
        load_flax_variables(half, variables)
        h = half.to(cuda_device)(x.to(cuda_device), per_frame=True).cpu()
    assert kernels.launch_counts() == counts
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    assert (h - want).abs().max() <= 0.05 * (1 + want.abs().max())


@pytest.mark.cuda
def test_cuda_resnet50_detector_and_pose_launch_the_fused_kernel(cuda_device):
    """A bf16 ResNet-50 detector and pose model at 128² launch 6 fused
    bottlenecks a forward (layer1 at 32², layer2 at 16²) and nothing else;
    their maps within chip_smoke.py's rule of the fp32 plain models'."""
    from workoutdetector_tpu_torch.models import load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.models.detector import CenterNetDetector
    from workoutdetector_tpu_torch.models.pose import TopDownPose

    x = torch.randn(4, 128, 128, 3, generator=torch.Generator().manual_seed(0)
                    ).to(cuda_device)
    for cls in (CenterNetDetector, TopDownPose):
        model = cls("resnet50", dtype=torch.bfloat16)
        variables = random_flax_variables(model, seed=0)
        load_flax_variables(model, variables)
        ref = cls("resnet50", use_kernels=False)
        load_flax_variables(ref, variables)
        model, ref = model.to(cuda_device), ref.to(cuda_device)
        kernels.reset_launches()
        with torch.no_grad():
            got, want = model(x), ref(x)
        counts = {k: n for k, n in kernels.launch_counts().items() if n}
        assert counts == {"fused_bottleneck": 6}, cls.__name__
        got = got["heatmap"] if isinstance(got, dict) else got
        want = want["heatmap"] if isinstance(want, dict) else want
        assert torch.isfinite(got).all()
        assert (got - want).abs().max() <= 0.05 * (1 + want.abs().max())


@pytest.mark.cuda
def test_cuda_tiny_detector_and_pose_match_the_cpu(cuda_device):
    """The fp32 tiny detector and pose model on the card against the CPU
    on the same weights (TF32 off, as the fixture sets): maps within 1e-4,
    the same number of boxes within 1e-3 px, the same keypoints."""
    from workoutdetector_tpu_torch.data.synthetic import person_scene
    from workoutdetector_tpu_torch.models import load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.models.detector import (
        CenterNetDetector, LearnedDetectorBackend)
    from workoutdetector_tpu_torch.models.pose import (PoseEstimator,
                                                       TopDownPose)

    clip = person_scene(np.random.default_rng(0), size=96, t=21)[0]
    for cls in (CenterNetDetector, TopDownPose):
        variables = random_flax_variables(cls(), seed=0)
        pair = []
        for dev in ("cpu", "cuda"):
            m = cls()
            load_flax_variables(m, variables)
            run = LearnedDetectorBackend if cls is CenterNetDetector \
                else PoseEstimator
            pair.append(run(m, input_size=64, device=dev))
        maps = [p.heatmaps(clip) for p in pair]
        if cls is CenterNetDetector:
            for k in maps[0]:
                np.testing.assert_allclose(maps[1][k], maps[0][k], atol=1e-4)
            for a, b in zip(pair[1](clip, threshold=0.05),
                            pair[0](clip, threshold=0.05)):
                assert a.shape == b.shape
                np.testing.assert_allclose(a, b, atol=1e-3)
        else:
            np.testing.assert_allclose(maps[1], maps[0], atol=1e-4)
            a, b = pair[1].estimate_clip(clip), pair[0].estimate_clip(clip)
            np.testing.assert_array_equal(a[..., :2], b[..., :2])


@pytest.mark.cuda
def test_cuda_dryrun_two_ranks_share_the_card(cuda_device, tmp_path):
    """The parallel dry run (``parallel/dryrun.py``) over 2 gloo ranks on
    the one card, TSM-R50 at 128², 4 segments: fp32 DP (the plain model)
    equals the one-process steps within 1e-4, bf16 FSDP equals bf16 DP
    (the clip's norm summed in float64 over shards), every rank
    launches the shift-matmul, dx and dW kernels in a bf16 step (16, 33,
    33) and the fused bottleneck on the pp-staged engine's stem-side
    stage, the sharded fp32 engine gives the one-shot logits within 1e-4
    and the staged bf16 one its argmax, and the all-gather and
    point-to-point transfers go through pinned host buffers."""
    from workoutdetector_tpu_torch.models import TSM
    from workoutdetector_tpu_torch.models.convert import (
        init_flax_variables, random_flax_variables)
    from workoutdetector_tpu_torch.parallel import dryrun
    from workoutdetector_tpu_torch.parallel.distributed import spawn
    from workoutdetector_tpu_torch.train.trainer import Trainer

    model = TSM(5, 4, "resnet50")
    torch.save(random_flax_variables(model, seed=0), tmp_path / "v.pt")
    train_vars = init_flax_variables(model, seed=0)
    torch.save(train_vars, tmp_path / "t.pt")
    spec = dryrun.DryrunSpec(
        base_model="resnet50", num_class=5, num_segments=4, image_size=128,
        train_dtypes=("float32", "bfloat16"),
        serve_dtypes=("float32", "bfloat16"), dropout=0.5, batch=4, steps=2,
        window_batch=8, device="cuda", weights=str(tmp_path / "v.pt"),
        train_weights=str(tmp_path / "t.pt"), tf32=False,
        phases=("dp", "fsdp", "serve", "pp-serve"))
    tr = Trainer(dryrun.train_config(spec, "float32"), device=cuda_device)
    assert not tr.model.backbone.use_kernels  # fp32 on the card: plain
    st = tr.init_state(steps_per_epoch=10, variables=train_vars)
    x, y = dryrun.train_batch(spec)
    one = [float(tr.train_step(st, x, y)["loss"]) for _ in range(spec.steps)]
    ranks = spawn(dryrun.run, 2, (spec,), device="cuda", timeout_s=600)
    for r in ranks:
        np.testing.assert_allclose(r["dp-float32"]["losses"], one, rtol=1e-4)
        np.testing.assert_allclose(r["fsdp-bfloat16"]["losses"],
                                   r["dp-bfloat16"]["losses"], rtol=1e-6)
        got = {k: r["dp-bfloat16"]["launches"][k]
               for k in ("shift_matmul", "conv1x1_dx", "conv1x1_dw")}
        assert got == {"shift_matmul": 32, "conv1x1_dx": 66,
                       "conv1x1_dw": 66}
        assert r["serve-float32"]["max_abs_err"] <= 1e-4
        pp = r["pp-serve-bfloat16"]
        assert (pp["logits"].argmax(-1) == pp["ref"].argmax(-1)).all()
        fused = r["pp-serve-bfloat16"]["launches"]["fused_bottleneck"]
        assert fused == (2 * 2 * 6 if r["rank"] == 0 else 0)
        assert r["serve-bfloat16"]["launches"]["fused_bottleneck"] == 12
        transports = r["fsdp-bfloat16"]["transports"]
        assert "pinned host" in transports["all_gather"]
        assert "pinned host" in r["pp-serve-bfloat16"]["transports"][
            "send" if r["rank"] == 0 else "recv"]
