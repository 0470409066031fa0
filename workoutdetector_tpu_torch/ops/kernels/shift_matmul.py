"""Temporal shift fused into a stride-1 1×1 conv: y = shift(x) @ W.

Port of ``workoutdetector_tpu/ops/pallas/shift_matmul.py``
(``_shift_matmul_fwd_impl``), forward only: the hand kernel in
``csrc/shift_matmul.cu`` and its plain version. At TSM-R50 it runs the
shifted conv1 of every bottleneck outside the fused stages (10 sites a
forward) and the forward of every shifted conv1 in training (16 sites a
step, through ``ShiftConv1x1``).

The kernel is a persistent TMA-fed ``wgmma`` GEMM: blocks of two 64-row
tiles (each inside one clip) by 64, 128 or 256 columns, W read as it lies,
the shift carried by the x loads (one tensor map per channel region, each
box loaded at its region's row offset, ±HW, zero-filled past the clip's
ends). ``shift_matmul_plan`` is its walk in Python. The bound is bytes
(x and W read once, y written once) at every TSM-R50 site but layer4's,
where the tensor cores bind. Design and bound in full: the note at the top
of the CUDA source.

Weights are (C, O) — the squeezed HWIO 1×1 kernel of the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from workoutdetector_tpu_torch.ops.kernels import _build
from workoutdetector_tpu_torch.ops.temporal_shift import shift_folds

ROWS = 64           # rows of a warpgroup's tile (a row tile)
K_CHUNK = 64        # channels of one ring stage
SMEM_MAX = 227 * 1024
MAX_STAGES = 8
_ROW_BYTES = 128    # 64 bf16 channels or columns
_BOX = 64 * _ROW_BYTES  # a 64 x 64 bf16 box


class Plan(NamedTuple):
    """The kernel's walk of one shape (``shift_matmul_plan``)."""
    tile_width: int      # BN, output columns of a block tile
    stages: int          # ring stages
    smem: int            # bytes of shared memory a block takes
    clip_rows: int       # rows of a clip (T·HW; all M rows when unshifted)
    clips: int
    tiles_per_clip: int  # 64-row tiles of a clip
    row_tiles: int
    col_tiles: int
    tiles: int           # block tiles: pairs of row tiles × column tiles
    # per ring stage of a block tile, each a pass of four 16-deep k-steps
    # over one K chunk: (K chunk, region, row offset); region 0 = [0, fold)
    # at +HW, 1 = [fold, 2·fold) at −HW, 2 = the rest at 0
    steps: Tuple[Tuple[int, int, int], ...]

    @property
    def padding(self) -> float:
        """Share of the rows walked that lie past a clip's end."""
        walked = self.row_tiles * ROWS
        return (walked - self.clips * self.clip_rows) / walked


def _regions(c: int, fold: int):
    """[lo, hi) of the three channel regions (2·fold ≤ c)."""
    return [(0, fold), (fold, 2 * fold), (2 * fold, c)]


def shift_matmul_plan(m: int, hw: int, t: int, c: int, o: int,
                      fold: int) -> Plan:
    """The walk ``csrc/shift_matmul.cu`` takes for x (m, c) over clips of t
    frames of hw rows, W (c, o) and ``fold`` channels shifted each way (its
    ``wd_shift_matmul_plan``; the card tests hold the two equal)."""
    if m < 1 or c < 8 or c % 8 or o < 16 or o % 16 or fold < 0 or fold % 8 \
            or 2 * fold > c or t < 1 or hw < 1:
        raise ValueError(f"shift_matmul: no plan for m={m}, hw={hw}, t={t}, "
                         f"c={c}, o={o}, fold={fold}")
    bn = 64 if o <= 64 else 128 if o <= 128 else 256
    col_tiles = -(-o // bn)
    chunks = -(-c // K_CHUNK)
    out = 2 * min(bn // 64, 2) * _BOX  # the warpgroups' staged output boxes
    stage = 2 * ROWS * _ROW_BYTES + bn * _ROW_BYTES  # x boxes and a W box
    stages = min(MAX_STAGES, (SMEM_MAX - 1024 - out - 256) // stage)
    clip_rows = hw * t if fold else m
    if m % clip_rows:
        raise ValueError(f"shift_matmul: {m} rows are not whole clips of "
                         f"{clip_rows}")
    clips = m // clip_rows
    per_clip = -(-clip_rows // ROWS)
    shift = hw if fold else 0
    steps = tuple((k, r, (shift, -shift, 0)[r]) for k in range(chunks)
                  for r, (lo, hi) in enumerate(_regions(c, fold))
                  if lo < hi and lo < (k + 1) * K_CHUNK and k * K_CHUNK < hi)
    return Plan(bn, stages, 1024 + stages * stage + out + 2 * stages * 8,
                clip_rows, clips, per_clip, clips * per_clip, col_tiles,
                -(-clips * per_clip // 2) * col_tiles, steps)


def shift_matmul_plain(x: torch.Tensor, w: torch.Tensor, n_segment: int,
                       fold_div: int = 8) -> torch.Tensor:
    """Plain version: fp32 products of the x-dtype inputs, one rounding to
    x's dtype — the kernel's arithmetic. x (B·T, H, W, C), w (C, O)."""
    shifted = shift_folds(x, n_segment, x.shape[-1] // fold_div)
    return (shifted.float() @ w.to(x.dtype).float()).to(x.dtype)


def shift_matmul(x: torch.Tensor, w: torch.Tensor, n_segment: int,
                 fold_div: int = 8) -> torch.Tensor:
    """The kernel for a CUDA tensor (bf16), the plain version for a CPU one."""
    if x.device.type == "cpu":
        return shift_matmul_plain(x, w, n_segment, fold_div)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"shift_matmul: x on {x.device}, w on {w.device}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"shift_matmul kernel takes bf16, got {x.dtype}/{w.dtype}")
    bt, h, wd, c = x.shape
    o = w.shape[1]
    fold = c // fold_div
    if w.shape[0] != c or c % 8 or o % 16 or fold % 8 or 2 * fold > c or \
            bt % n_segment:
        raise ValueError(
            f"shift_matmul kernel: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"T={n_segment}, fold={fold}: needs C % 8 == 0, O % 16 == 0, "
            "fold % 8 == 0, 2·fold ≤ C, B·T % T == 0")
    if not (x.is_contiguous() and w.is_contiguous()) or \
            x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("shift_matmul kernel needs contiguous, 16-byte "
                         "aligned x and w")
    y = torch.empty((bt, h, wd, o), dtype=x.dtype, device=x.device)
    lib = _build.load()
    lib.check(lib.lib.wd_shift_matmul_bf16(
        x.data_ptr(), w.data_ptr(), y.data_ptr(), bt * h * wd, h * wd,
        n_segment, c, o, fold, x.device.index or 0,
        _build.stream_handle(x.device)), "shift_matmul")
    shift_matmul.launches += 1
    return y


shift_matmul.launches = 0
