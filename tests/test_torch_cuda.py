"""PyTorch port on the card: each hand kernel against its plain version.

Marked ``cuda``; each test skips without a CUDA device (the kernels have
no CPU mode). This file imports no jax, so on a machine with the card it
runs without the JAX package's test harness:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: the shift is a copy (exact). The GEMM kernels round once per
stored tensor like their plain versions but sum in another order, so they
may differ by a few bf16 ulps: |kernel − plain| ≤ (1 + |plain|) / 64.
"""

import numpy as np
import pytest
import torch

from workoutdetector_tpu_torch.ops import kernels


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


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,o,ds,hw", [(64, 64, 256, True, (9, 21)),
                                         (256, 64, 256, False, (8, 16)),
                                         (512, 128, 512, False, (5, 7)),
                                         (256, 256, 256, False, (6, 6))])
def test_cuda_fused_bottleneck_vs_plain(cuda_device, c, f, o, ds, hw):
    rng = np.random.default_rng(7)

    def w(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                                * np.sqrt(2 / np.prod(shape[:-1]))) \
            .to(cuda_device, torch.bfloat16)

    def sb(n):
        return torch.from_numpy(np.stack(
            [rng.uniform(0.5, 1.0, n), rng.normal(0, 0.1, n)]).astype(
                np.float32)).to(cuda_device)

    p = kernels.FusedBlockParams(w(c, f), sb(f), w(3, 3, f, f), sb(f),
                                 w(f, o), sb(o), w(c, o) if ds else None,
                                 sb(o) if ds else None)
    x = torch.from_numpy(rng.standard_normal((2 * 4,) + hw + (c,)).astype(
        np.float32)).to(cuda_device, torch.bfloat16)
    for fold in (c // 8, 0):
        _close(kernels.fused_bottleneck(x, p, n_segment=4, fold=fold),
               kernels.fused_bottleneck_plain(x, p, n_segment=4, fold=fold))


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


@pytest.mark.cuda
@pytest.mark.parametrize("frames,h,w,c,o,t,shifted", BWD_SHAPES)
def test_cuda_conv1x1_dx_dw_vs_plain(cuda_device, frames, h, w, c, o, t,
                                     shifted):
    g = torch.Generator(device=cuda_device).manual_seed(3)
    r, fold = frames * h * w, (c // 8 if shifted else 0)
    x = torch.randn(r, c, generator=g, device=cuda_device).bfloat16()
    gy = torch.randn(r, o, generator=g, device=cuda_device).bfloat16()
    wt = (torch.randn(o, c, generator=g, device=cuda_device)
          / o ** 0.5).bfloat16()
    spec = (t, fold, h * w)
    before = (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches)
    _close(kernels.conv1x1_dx(gy, wt, *spec),
           kernels.conv1x1_dx_plain(gy, wt, *spec))
    _dw_close(kernels.conv1x1_dw(x, gy, *spec),
              kernels.conv1x1_dw_plain(x, gy, *spec))
    assert (kernels.conv1x1_dx.launches, kernels.conv1x1_dw.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_cuda_conv1x1_dw_is_deterministic(cuda_device):
    """The row splits are summed in a fixed order: equal bits every call."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = torch.randn(8 * 56 * 56, 64, generator=g, device=cuda_device).bfloat16()
    gy = torch.randn(8 * 56 * 56, 256, generator=g, device=cuda_device).bfloat16()
    first = kernels.conv1x1_dw(x, gy, 8, 8, 56 * 56)
    for _ in range(3):
        assert torch.equal(kernels.conv1x1_dw(x, gy, 8, 8, 56 * 56), first)


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
