"""Backward of the stride-1 1×1 convs: hand kernels, plain versions, and
the two differentiable convs that use them.

Port of ``workoutdetector_tpu/ops/pallas/conv1x1.py``:

* ``conv1x1_dx(g, wt)`` — ``_dx_pallas``: (R, O) @ (O, C) → (R, C) in g's
  dtype; with a shift spec it also applies Sᵀ (the fold shift's
  transpose) to the result, as ``make_shift_conv1x1``'s backward does.
  On the card the kernel reads W (C, O) as it lies, so ``wt`` is passed
  as ``w.t()``.
* ``conv1x1_dw(x, g)`` — ``_dw_pallas``: xᵀ @ g → (C, O) in fp32; with a
  shift spec x's fold columns are shifted first (shift(x)ᵀ @ g).
* ``Conv1x1`` — ``make_conv1x1``: y = x @ W with a plain matmul forward
  (XLA's conv in the JAX package) and both cotangents from the kernels.
* ``ShiftConv1x1`` — ``make_shift_conv1x1``: y = shift(x) @ W on the
  shift-matmul kernel, backward dsh = g Wᵀ then dx = Sᵀ dsh (one dx
  launch), dW = shift(x)ᵀ g.

The JAX package's ragged-row fallback (``_round_rows``) is a TPU tiling
limit; the CUDA kernels mask any row count. Rounding points are the JAX
package's: g is cast to x's dtype before both products, dx is rounded to
that dtype once, and dW is summed in fp32 and then cast to the weight's
(compute) dtype once. Bound and design: see the note at the top of
``csrc/conv1x1_bwd.cu``.
"""

from __future__ import annotations

import torch

from workoutdetector_tpu_torch.ops.kernels import _build
from workoutdetector_tpu_torch.ops.kernels.library import count_launch
from workoutdetector_tpu_torch.ops.kernels.shift_matmul import shift_matmul
from workoutdetector_tpu_torch.ops.temporal_shift import shift_folds

DW_CHUNK = 64  # rows of one K step of the dW kernel


def _frames(a: torch.Tensor, frame_rows: int) -> torch.Tensor:
    """(R, C) rows → (R / frame_rows, frame_rows, C) frames for the shift."""
    return a.reshape(-1, frame_rows, a.shape[-1])


def conv1x1_dx_plain(g: torch.Tensor, wt: torch.Tensor, n_segment: int = 1,
                     fold: int = 0, frame_rows: int = 1) -> torch.Tensor:
    """g (R, O) @ wt (O, C) with fp32 products, rounded to g's dtype once;
    then Sᵀ on the first 2·fold columns when fold > 0 (rows form clips of
    n_segment frames of frame_rows rows)."""
    dx = (g.float() @ wt.to(g.dtype).float()).to(g.dtype)
    if fold:
        dx = shift_folds(_frames(dx, frame_rows), n_segment, fold,
                         reverse=True).reshape(dx.shape)
    return dx


def conv1x1_dw_plain(x: torch.Tensor, g: torch.Tensor, n_segment: int = 1,
                     fold: int = 0, frame_rows: int = 1) -> torch.Tensor:
    """x (R, C)ᵀ @ g (R, O) → (C, O) fp32, x's fold columns shifted when
    fold > 0."""
    if fold:
        x = shift_folds(_frames(x, frame_rows), n_segment, fold).reshape(x.shape)
    return x.float().t() @ g.float()


def _check(name: str, tensors, shift_ok: bool) -> None:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"{name} kernel takes bf16, got "
                        f"{[t.dtype for t in tensors]}")
    if any(t.dim() != 2 or not t.is_contiguous() or t.data_ptr() % 16
           for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous, 16-byte aligned "
                         "2-D tensors")
    if not shift_ok:
        raise ValueError(f"{name}: rows must form whole clips of frames, and "
                         "fold % 8 == 0 with 2·fold ≤ C")


def _shift_ok(rows: int, c: int, n_segment: int, fold: int,
              frame_rows: int) -> bool:
    if not fold:
        return True
    return (fold % 8 == 0 and 2 * fold <= c and frame_rows > 0
            and n_segment > 0 and rows % (frame_rows * n_segment) == 0)


# The dx kernel's tile width for (C, O), and the folds it takes inside its
# first tile (2·fold ≤ width); any other fold must be a whole number of tiles
DX_FOLDS = {64: (8, 16), 128: (16, 32, 64), 256: (32, 64)}


def _dx_fold_ok(c: int, o: int, fold: int) -> bool:
    width = 64 if c <= 64 else 256 if 128 < c <= 256 and o <= 64 else 128
    return fold % width == 0 or fold in DX_FOLDS[width]


def conv1x1_dx(g: torch.Tensor, wt: torch.Tensor, n_segment: int = 1,
               fold: int = 0, frame_rows: int = 1) -> torch.Tensor:
    """dx = g @ wt (then Sᵀ when fold > 0): the kernel for CUDA tensors
    (bf16), the plain version for CPU ones. g (R, O), wt (O, C). The
    kernel reads the weight W (C, O) as it lies, so on the card wt must be
    ``w.t()`` of a contiguous W: no transposed copy is made."""
    if g.device.type == "cpu":
        return conv1x1_dx_plain(g, wt, n_segment, fold, frame_rows)
    r, o = g.shape
    c = wt.shape[1]
    w = wt.t()
    _check("conv1x1_dx", [g, w],
           _shift_ok(r, c, n_segment, fold, frame_rows))
    if wt.shape[0] != o or o % 8 or c % 8 or not _dx_fold_ok(c, o, fold):
        raise ValueError(f"conv1x1_dx kernel: g {tuple(g.shape)}, wt "
                         f"{tuple(wt.shape)}, fold {fold}: needs O % 8 == 0, "
                         "C % 8 == 0 and a fold of whole tiles or one of "
                         f"{DX_FOLDS}")
    dx = torch.empty((r, c), dtype=g.dtype, device=g.device)
    lib = _build.load()
    lib.check(lib.lib.wd_conv1x1_dx_bf16(
        g.data_ptr(), w.data_ptr(), dx.data_ptr(), r, o, c, frame_rows,
        n_segment, fold, g.device.index or 0, _build.stream_handle(g.device)),
        "conv1x1_dx")
    count_launch(conv1x1_dx)
    return dx


conv1x1_dx.launches = 0

_SM_COUNT = {}


def dw_splits(device: torch.device, r: int, c: int, o: int,
              clip_rows: int) -> int:
    """Row splits of the dW kernel: its (C, O) tiles (64 or 128 channels of
    C, as C ≤ 64 or not, by 64 or 128 of O) times the splits fill the SMs
    once; no split is shorter than one 64-row chunk (chunks are cut inside
    each clip of ``clip_rows`` rows)."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    tiles = -(-c // (64 if c <= 64 else 128)) * -(-o // (64 if o <= 64 else 128))
    chunks = (r // clip_rows) * -(-clip_rows // DW_CHUNK)
    return max(1, min(chunks, _SM_COUNT[device] // tiles))


def conv1x1_dw(x: torch.Tensor, g: torch.Tensor, n_segment: int = 1,
               fold: int = 0, frame_rows: int = 1) -> torch.Tensor:
    """dW = A^T @ g in fp32, A = x (shift(x) when fold > 0): the kernel for
    CUDA tensors (bf16), the plain version for CPU ones. x (R, C), g (R, O).
    The row splits are summed in a fixed order: the same bits every run."""
    if x.device.type == "cpu":
        return conv1x1_dw_plain(x, g, n_segment, fold, frame_rows)
    r, c = x.shape
    o = g.shape[1]
    _check("conv1x1_dw", [x, g], _shift_ok(r, c, n_segment, fold, frame_rows))
    if g.shape[0] != r or c % 8 or o % 8:
        raise ValueError(f"conv1x1_dw kernel: x {tuple(x.shape)}, g "
                         f"{tuple(g.shape)}: needs C % 8 == 0, O % 8 == 0")
    dw = torch.empty((c, o), dtype=torch.float32, device=x.device)
    splits = dw_splits(x.device, r, c, o,
                       frame_rows * n_segment if fold else r) if r else 1
    work = torch.empty((splits, c, o), dtype=torch.float32, device=x.device) \
        if splits > 1 else dw
    lib = _build.load()
    lib.check(lib.lib.wd_conv1x1_dw_bf16(
        x.data_ptr(), g.data_ptr(), dw.data_ptr(), work.data_ptr(), r, c, o,
        frame_rows, n_segment, fold, splits, x.device.index or 0,
        _build.stream_handle(x.device)), "conv1x1_dw")
    count_launch(conv1x1_dw)
    return dw


conv1x1_dw.launches = 0


def _rows(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class Conv1x1(torch.autograd.Function):
    """y = x @ W for x (N, H, W, C) and W (C, O), both in the compute
    dtype; forward a plain matmul, backward the dx and dW kernels."""

    @staticmethod
    def forward(ctx, x, w):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        return (_rows(x) @ w).reshape(*x.shape[:-1], w.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = _rows(g).to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv1x1_dx(g2, w.contiguous().t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = conv1x1_dw(_rows(x), g2).to(w.dtype)
        return dx, dw


class ShiftConv1x1(torch.autograd.Function):
    """y = shift(x) @ W for x (B·T, H, W, C) and W (C, O): forward the
    shift-matmul kernel, backward dx = Sᵀ(g Wᵀ) and dW = shift(x)ᵀ g."""

    @staticmethod
    def forward(ctx, x, w, n_segment: int, fold_div: int):
        x = x.contiguous()
        ctx.save_for_backward(x, w)
        ctx.shift = (n_segment, x.shape[-1] // fold_div, x.shape[1] * x.shape[2])
        return shift_matmul(x, w, n_segment, fold_div)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = _rows(g).to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv1x1_dx(g2, w.contiguous().t(), *ctx.shift).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            dw = conv1x1_dw(_rows(x), g2, *ctx.shift).to(w.dtype)
        return dx, dw, None, None
