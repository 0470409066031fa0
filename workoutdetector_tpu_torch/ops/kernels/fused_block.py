"""One whole stride-1 inference ResNet bottleneck as one kernel.

Port of ``workoutdetector_tpu/ops/pallas/fused_block.py``
(``fused_bottleneck``, ``FusedBlockParams``, ``fold_bn``): the hand kernels
and their plain version. It computes

    y1  = relu(s1 · (shift(x) @ W1) + b1)      → x.dtype
    y2  = relu(s2 · conv3x3_same(y1) + b2)      → x.dtype
    y3  = s3 · (y2 @ W3) + b3                   fp32
    out = relu(y3 + res)                        res = x or sd · (x @ Wd) + bd

with BatchNorm folded from running statistics (inference only). At
TSM-R50 it runs the stride-1 blocks of stages 0-1 (6 per forward). Two
routes, chosen by ``wgmma_route`` on the widths: the wgmma kernel
(``csrc/fused_block.cu``, counted in ``fused_bottleneck.launches``) for F
64 and 128 with a downsample over at most 128 channels, every TSM-R50
site; the WMMA kernel (``csrc/fused_block_wmma.cu``, counted in
``fused_bottleneck_wmma.launches``) for the other widths. Bounds and
designs: see the notes at the top of the CUDA sources.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from workoutdetector_tpu_torch.ops.conv import conv2d_nhwc
from workoutdetector_tpu_torch.ops.kernels import _build
from workoutdetector_tpu_torch.ops.temporal_shift import shift_folds


class FusedBlockParams(NamedTuple):
    """Folded inference parameters of one bottleneck block.

    w1/w2/w3: conv kernels as (C,F), (3,3,F,F), (F,O) — squeezed HWIO.
    sb1/sb2/sb3: (2, features) fp32 rows [scale; bias] from BN folding.
    wd/sbd: optional 1×1 downsample projection (C,O) and its (2,O) fold.
    """
    w1: torch.Tensor
    sb1: torch.Tensor
    w2: torch.Tensor
    sb2: torch.Tensor
    w3: torch.Tensor
    sb3: torch.Tensor
    wd: Optional[torch.Tensor] = None
    sbd: Optional[torch.Tensor] = None


def fold_bn(scale: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
            var: torch.Tensor, eps: float) -> torch.Tensor:
    """BN(running stats) → (2, F) fp32 [multiplier; offset]."""
    s = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * s
    return torch.stack([s, b])


def fused_bottleneck_plain(x: torch.Tensor, p: FusedBlockParams, *,
                           n_segment: int, fold: int) -> torch.Tensor:
    """Plain version with the kernel's arithmetic: fp32 products of
    x-dtype operands, rounding to x's dtype at y1, y2 and the output."""
    dt = x.dtype
    y = shift_folds(x, n_segment, fold)
    y1 = torch.relu((y.float() @ p.w1.to(dt).float()) * p.sb1[0] + p.sb1[1])
    y1 = y1.to(dt)
    w2 = p.w2.to(dt).float().permute(3, 2, 0, 1)
    y2 = conv2d_nhwc(y1.float(), w2, (1, 1), "SAME")
    y2 = torch.relu(y2 * p.sb2[0] + p.sb2[1]).to(dt)
    y3 = (y2.float() @ p.w3.to(dt).float()) * p.sb3[0] + p.sb3[1]
    if p.wd is not None:
        res = (x.float() @ p.wd.to(dt).float()) * p.sbd[0] + p.sbd[1]
    else:
        res = x.float()
    return torch.relu(y3 + res).to(dt)


# The wgmma kernel (csrc/fused_block.cu): F in WGMMA_WIDTHS (its register
# tiles are 64 F columns wide, at most two); a downsample's unshifted x
# panels (64 rows of 128 bytes per 64 input channels) must fit their
# 16,384-byte buffer; a block may use SMEM_MAX bytes.
WGMMA_WIDTHS = (64, 128)
SMEM_MAX = 232448
_RING = 8 * 8192            # 8 stages of a 64 x 64 bf16 weight tile
_X_BUFFERS = 2 * 128 * 128  # per warpgroup: two 64-channel chunks of 128 rows
_DS_PANELS = 2 * 8192       # per warpgroup: the downsample's x panels
_Y1_PANEL = 112 * 128       # per warpgroup and 64 F columns: y1's 108 rows


TILE = (4, 16)  # output rows x columns of a warpgroup's tile (wgmma kernel)


def wgmma_tiles(frames: int, h: int, w: int) -> Tuple[int, int]:
    """(tiles, tile pairs) the wgmma kernel walks for ``frames`` frames of
    h × w: ⌈h / 4⌉ · ⌈w / 16⌉ tiles a frame, two neighbouring tiles a pair
    (one per warpgroup); each pair reads every weight tile once from L2."""
    tiles = frames * -(-h // TILE[0]) * -(-w // TILE[1])
    return tiles, -(-tiles // 2)


def wgmma_smem(c: int, f: int, o: int, ds: bool) -> int:
    """Bytes of shared memory the wgmma kernel takes for input width c,
    bottleneck width f, output width o and a downsample (or not), as
    ``csrc/fused_block.cu``'s ``wd_fused_bottleneck_smem``: 1024 of
    alignment slack, the weight ring, per warpgroup (two) its two x
    buffers, the downsample's panels and f / 64 y1 panels, the ring's 16 8-byte
    mbarriers, the fp32 BN scales and biases (2 f for conv1 and conv2 each,
    2 o for conv3 and the downsample each); 0 where the kernel does not take
    the shape (f not in WGMMA_WIDTHS, a downsample over c > 128, or more
    than SMEM_MAX)."""
    if f not in WGMMA_WIDTHS or ds and -(-c // 64) * 8192 > _DS_PANELS:
        return 0
    smem = 1024 + _RING + 2 * (_X_BUFFERS + _DS_PANELS + f // 64 * _Y1_PANEL) \
        + 16 * 8 + 4 * (4 * f + 2 * o * (2 if ds else 1))
    return smem if smem <= SMEM_MAX else 0


def wgmma_route(c: int, f: int, o: int, ds: bool) -> bool:
    """The route rule: True where the wgmma kernel takes (c, f, o, ds) — f
    64 or 128, a downsample only over c ≤ 128, within SMEM_MAX
    (``wgmma_smem`` > 0); elsewhere the WMMA kernel runs."""
    return wgmma_smem(c, f, o, ds) > 0


def fused_bottleneck(x: torch.Tensor, p: FusedBlockParams, *, n_segment: int,
                     fold: int) -> torch.Tensor:
    """Run one fused bottleneck on x (B·T, H, W, C) → (B·T, H, W, O): the
    kernel of the shape's route (``wgmma_route``: the wgmma kernel, counted
    here, or the WMMA one, counted in ``fused_bottleneck_wmma``) for a CUDA
    tensor (bf16), the plain version for a CPU one.

    n_segment: T (ignored when fold == 0); fold: channels shifted each way
    (C // fold_div), 0 = no shift.
    """
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, p, n_segment=n_segment, fold=fold)
    return _launch(x, p, n_segment, fold, wmma=False)


fused_bottleneck.launches = 0


def fused_bottleneck_wmma(x: torch.Tensor, p: FusedBlockParams, *,
                          n_segment: int, fold: int) -> torch.Tensor:
    """The WMMA kernel (``csrc/fused_block_wmma.cu``) whatever the widths,
    for a CUDA tensor (bf16); the plain version for a CPU one.
    ``fused_bottleneck`` takes this route where ``wgmma_route`` leaves a
    shape out; its launches count here."""
    if x.device.type == "cpu":
        return fused_bottleneck_plain(x, p, n_segment=n_segment, fold=fold)
    return _launch(x, p, n_segment, fold, wmma=True)


fused_bottleneck_wmma.launches = 0


def _launch(x: torch.Tensor, p: FusedBlockParams, n_segment: int, fold: int,
            wmma: bool) -> torch.Tensor:
    """Check the operands and launch the kernel of the shape's route, or
    the WMMA one where ``wmma``."""
    tensors = [t for t in p if t is not None]
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError("fused_bottleneck: x and every parameter must lie "
                         f"on one CUDA device (x on {x.device})")
    weights = [p.w1, p.w2, p.w3] + ([p.wd] if p.wd is not None else [])
    folds = [p.sb1, p.sb2, p.sb3] + ([p.sbd] if p.sbd is not None else [])
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in weights) \
            or any(s.dtype != torch.float32 for s in folds):
        raise TypeError("fused_bottleneck kernel takes bf16 x and weights "
                        "with fp32 scale/bias")
    bt, h, w, c = x.shape
    f, o = p.w1.shape[1], p.w3.shape[1]
    t = n_segment if fold > 0 else 1
    shapes_ok = (p.w1.shape == (c, f) and p.w2.shape == (3, 3, f, f)
                 and p.w3.shape == (f, o) and p.sb1.shape == (2, f)
                 and p.sb2.shape == (2, f) and p.sb3.shape == (2, o)
                 and (p.wd is None and c == o
                      or p.wd is not None and p.wd.shape == (c, o)
                      and p.sbd.shape == (2, o)))
    if not shapes_ok or c % 8 or f % 32 or o % 16 or fold % 8 or bt % t:
        raise ValueError(
            f"fused_bottleneck kernel: x {tuple(x.shape)}, F={f}, O={o}, "
            f"fold={fold}, T={t}: needs C % 8 == 0, F % 32 == 0, "
            "O % 16 == 0, fold % 8 == 0 and matching parameter shapes")
    if not all(v.is_contiguous() and v.data_ptr() % 16 == 0
               for v in [x] + tensors):
        raise ValueError("fused_bottleneck kernel needs contiguous, 16-byte "
                         "aligned tensors")
    out = torch.empty((bt, h, w, o), dtype=x.dtype, device=x.device)
    wgmma = not wmma and wgmma_route(c, f, o, p.wd is not None)
    lib = _build.load()
    fn = lib.lib.wd_fused_bottleneck_bf16 if wgmma else \
        lib.lib.wd_fused_bottleneck_wmma_bf16
    lib.check(fn(
        x.data_ptr(), p.w1.data_ptr(), p.sb1.data_ptr(), p.w2.data_ptr(),
        p.sb2.data_ptr(), p.w3.data_ptr(), p.sb3.data_ptr(),
        p.wd.data_ptr() if p.wd is not None else None,
        p.sbd.data_ptr() if p.sbd is not None else None,
        out.data_ptr(), bt, h, w, c, f, o, t, fold, x.device.index or 0,
        _build.stream_handle(x.device)), "fused_bottleneck")
    if wgmma:
        fused_bottleneck.launches += 1
    else:
        fused_bottleneck_wmma.launches += 1
    return out
