#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure → exit 1, and the final ``{"ok": true, ...}`` line is
not printed; no CUDA device → exit 2):

  1. the card's name and power limit (nvidia-smi);
  2. build the hand kernels from ``workoutdetector_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at every TSM-R50 224²
     shape of its main path, bf16 — the inference kernels at window batch
     16 (128 frames; the fused bottleneck's wgmma kernel at its three site
     shapes, the WMMA kernel of the other route timed beside it and checked
     at a layer3-width F = 256, where the route rule sends it), dx and dW at
     the 12 backward site shapes of a batch-32 train step (256 frames) and
     the shift-matmul at the 8 shifted ones (16 sites), beside
     ``torch.matmul``; the attention forward as the model runs it
     (``attention_lse``, o and the log-sum-exp) at TimeSformer-B/16's
     spatial attention, (n, h, l, dh) = (128, 12, 197, 64) cut from a
     packed qkv, on the one-block kernel (the tiled kernel timed beside it),
     and at the 288² step's l = 325 on the tiled kernel, each beside
     ``scaled_dot_product_attention``; the one-launch attention backward
     (D, dQ, dK and dV) at the same shape, o and lse from the forward
     kernel, writing into a packed gradient, beside the backward alone of
     ``scaled_dot_product_attention``; and the tiled dK/dV and dQ kernels,
     the backward's route for sequences too long for one block, at the
     shape phase 8's 288² step gives them (l = 325): max error, kernel /
     plain / library time and the bound (per site, the larger of the
     call's bytes over the H100's 3.35 TB/s and its operations over 989
     TFLOP/s bf16);
  4. the main path: TSM-R50 224², 8 segments, 12 classes, bf16, random
     numpy-seeded flax weights through ``load_flax_variables``;
     ``InferenceEngine.score_video`` on a synthetic ~300-frame uint8 video
     and ``count_by_video_model`` on the same video, with the kernel launch
     counts checked (10 shift-matmul and 6 fused-block launches per
     forward) and the logits held against the port's plain path in fp32 on
     the card; one ``score_windows`` batch under torch.profiler (device
     time by kernel and the device's idle share); and the count check
     (``count_check``: a head bias set per block of windows makes the
     argmax run through the states, the bf16 kernel path's argmax sequence
     and count must equal the fp32 plain path's, and a planted swap of two
     windows' logits must fail the same rule);
  5. ``shift_place='block'`` TSM-R50 on 4 clips, which runs the shift
     kernel (16 launches per forward);
  6. training, the flagship configuration at full width
     (``workoutdetector_tpu/configs/repcount_12_tsm.yaml``: TSM-R50 224²,
     8 segments, 12 classes, bf16, batch 32, SGD with the TSN policies,
     clip 20, partial BN, fc_lr5, dropout 0.5) on a ``DebugDataset``:
     ``Trainer.fit`` for 4 steps and one validation pass, with the launch
     counts checked (per step 33 dx and 33 dW launches of the 1×1 backward
     kernels and 16 shift-matmul forwards; per validation forward 10
     shift-matmul and 6 fused-block launches) and finite losses; one
     batch's gradients against the plain path in fp32, and the same check
     on two planted wiring faults of the shifted backward, which it must
     catch; two identical
     2-step runs compared bit for bit; train clips/s and one profiled step;
  7. TimeSformer-B/16 inference (``workoutdetector_tpu/configs/
     timesformer.yaml``: ViT-B/16 224², 8 segments, 12 classes,
     divided space-time attention, bf16, window batch 16), random
     numpy-seeded flax weights through ``load_flax_variables``, t_fc folded
     by the engine: ``score_video`` and ``count_by_video_model`` on the
     phase-4 video with the launch counts checked (12 attention launches
     per forward, no other kernel), the logits held against the unfolded
     plain fp32 model on the card by phase 4's rule, phase 4's count check,
     one profiled batch (the one-block attention kernel, l = 197);
  8. TimeSformer-B/16 training (``timesformer.yaml``'s model and
     optimizer: drop_path 0.1, SGD Nesterov, wd 1e-4 with the embeddings
     exempt, clip 40, bf16, batch 16) on a ``DebugDataset``: ``Trainer.fit``
     from the port's flax initializers for 4 steps and one validation pass,
     with the launch counts checked (per step 12 attention and 12
     attention_bwd launches, no tiled dK/dV or dQ; 12 attention launches
     per validation forward) and finite losses; one batch's gradients
     against the fp32 plain path with the same drop-path masks, and the
     same check on a planted fault (the backward handed the neighbouring
     head's dO), which it must catch; train clips/s and one profiled
     step; then the tiled routes through the model: one train step of
     TimeSformer-B/16 on 288² frames (l = 325 tokens, beyond the
     one-block forward's 256 rows and the one-launch backward's shared
     memory) with 12 tiled forward (``attention_tiled``), 12 dK/dV and 12
     dQ launches and a finite loss;
  9. the sweep: a RepCount-shaped corpus written by the phase
     (``annotation.csv`` and 6 test videos of ≈ 300 frames at 320×240, a
     known number of dark/bright reps each; mp4 through ``write_video``
     where cv2 imports, else YUV4MPEG2, and where no decoder backend
     loads, a stand-in reader of the generated frames, said so on its own
     line), a port checkpoint of TSM-R50 (``repcount_12_tsm.yaml``, random
     weights from seed 0, the head set so that its state follows the
     brightness: ``brightness_head``) and ``engine_from_checkpoint``: ``inference_dataset``
     with 2 decode workers staging on the device (launches: 10
     shift-matmul and 6 fused-block per forward; every score JSON in the
     JAX schema), held to an unstaged one-worker sweep (identical JSONs),
     to the fp32 plain path (``compare_dirs`` and phase 4's logit rule on
     the two live classes) and to a ``chunk_frames=64`` sweep;
     ``eval_dataset`` on one shard, on two merged by
     ``eval_count_shards``, and on the plain path (equal counts, MAE and
     OBO); the CLI in ``--score`` and ``--merge-shards`` mode; a planted
     fault (a video renamed: the manifest names it, the others are
     scored, the CLI exits non-zero on a shard of that video alone); the
     sweep's windows/s, the decode share of its wall time and
     ``score_video`` alone on the decoded videos; and one video counted
     by TimeSformer-B/16 through ``engine_from_checkpoint``
     (``timesformer.yaml``; 12 attention launches per forward);
 10. training on rawframe files: a probe of ``native/libwdjpeg.so``
     (``ctypes.CDLL``: loaded or the OSError) and the decode path
     FrameDataset takes (native prepped, native full or cv2); a
     RepCount-shaped corpus written by the phase (``annotation.csv``, 48
     frame folders of ``img_{:05}.jpg`` at 320×240 through
     ``cv2.imwrite``, the 6 actions each with its own figure, high in a
     rep's first half and low in its second; 144 train and 48 val clips
     in the lists ``build_video_label_list`` writes); the loader alone
     (``DataLoader(FrameDataset)`` at the yaml's 8 workers and batch 32:
     clips/s and JPEGs/s); ``repcount_12_tsm.yaml`` loaded by
     ``load_config`` with the corpus's paths, trained by ``Trainer.fit``
     for 15 epochs (60 steps) and one validation pass from the port's
     initializers (seed 0), with the launch counts of phase 6's rule and
     finite losses, validation accuracy before and after (a report, not a
     gate), train clips/s fed from the files beside phase 6's, and three
     loader-fed steps under the profiler (the device's idle share); the
     fit for 3 epochs with ``data.device_augment`` (256² canvases cropped,
     resized and flipped on the card; the same launch counts), and its
     ``crop_flip`` on one batch held to the same function on the CPU copy
     within 1e-3 on [0, 255];
 11. one JSON line of per-kernel numbers (and the sweep's and the file
     training's numbers), the card line again, the script's wall time,
     and the contract line ``{"ok": true, "device": {...}}`` last.

Kernel times are CUDA-event means over repeated launches on the current
stream; ``ms``, ``plain_ms`` and ``bound_ms`` are per R50 forward (the sum
over the kernel's launch sites) for the inference kernels and per train
step (batch 32, the sum over the 33 backward sites) for dx and dW and
over the 16 shifted conv1 sites for the shift-matmul's training row
(``shift_matmul_train``), per
TimeSformer-B/16 forward (12 launches) for the attention forward (its
one-block route at l = 197, its tiled route at l = 325, both with the
log-sum-exp). No single
PyTorch call computes the shift or the fused block, so their
``library_ms`` is null; the shift-matmul, dx and dW are timed beside
``torch.matmul`` of the same operands without the shift (x @ W, g @ Wᵀ,
xᵀ @ g), the attention beside
``scaled_dot_product_attention`` on the same q, k, v views. The
attention backward rows are per train step (12 launches each): the
one-launch kernel's at TimeSformer-B/16's l = 197, the tiled dK/dV and dQ
kernels' at the 288² step's l = 325. Their ``plain_ms`` and
``library_ms`` are each one call that computes dQ, dK and dV together (``attention_bwd_plain``; the
backward alone of ``scaled_dot_product_attention`` on contiguous q, k, v,
the fastest of its backends, which also computes D = rowsum(dO ∘ O)), the
same number in the dK/dV and dQ rows; phase 3 prints the tiled route's
dK/dV + dQ + D beside it.
"""

from __future__ import annotations

import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
BF16_FLOP_PER_S = 989e12   # H100 SXM, dense
WINDOW_BATCH = 16
FRAMES = 8
SIZE = 224
NUM_CLASS = 12
BLOCK_BATCH = 4
TRAIN_BATCH = 32
TRAIN_STEPS = 4
# TimeSformer-B/16 (vit_base_patch16_224): layers, heads, head width
TS_LAYERS, TS_HEADS, TS_DH = 12, 12, 64
TS_TOKENS = (SIZE // 16) ** 2 + 1  # 196 patches + the cls token
TS_TRAIN_BATCH = 16  # timesformer.yaml's batch
TS_LONG_SIZE = 288   # frames whose tokens take the tiled backward route
# their tokens (18² patches + the cls token = 325, beyond the one-launch
# kernel's l ≤ 224): phase 3 checks and times the tiled kernels at this l
TILED_L = (TS_LONG_SIZE // 16) ** 2 + 1
TOL = 1.0 / 64  # |kernel - plain| <= TOL * (1 + |plain|): a few bf16 ulps
# dW entries are sums of up to 802,816 bf16 products, taken in fp32 in
# another order (tensor-core partial sums, then the row splits) than the
# plain version's, so their rounding error scales with the size of the
# sums, not with each entry: |kernel - plain| <= DW_TOL * max|plain|. A
# wrong split or shift shows as an error of the order of max|plain|
DW_TOL = 1e-4
# gradients of one bf16 train step against the fp32 plain path, per leaf:
# e = ‖g − g_fp32‖ / ‖g_fp32‖. bf16 rounding by itself gives e up to ~0.11
# (measured: the bf16 PLAIN path — cuBLAS, cuDNN and PyTorch's own bf16
# ops — in the same run), so an absolute bound says little; the kernel
# path must stay within GRAD_RATIO times that path's e of the same leaf
# plus GRAD_FLOOR. Right kernels differ from it only in summation order
# and rounding places. Each run also plants two wiring faults in the
# shifted conv's backward (Sᵀ left out of dx; dW over x, not shift(x)) and
# fails unless the same limit catches both (grad_check).
GRAD_RATIO = 2.0
GRAD_FLOOR = 0.01

# TSM-R50 224² launch sites, per forward: (H, W, C, O or (F, O, ds), count)
SHIFT_MATMUL_SITES = [  # (h, w, c, o, count) — conv1 outside fused stages
    (56, 56, 256, 128, 1),   # layer2_0
    (28, 28, 512, 256, 1),   # layer3_0
    (14, 14, 1024, 256, 5),  # layer3_1..5
    (14, 14, 1024, 512, 1),  # layer4_0
    (7, 7, 2048, 512, 2),    # layer4_1..2
]
FUSED_SITES = [  # (h, w, c, f, o, ds, count) — stride-1 blocks of stages 0-1
    (56, 56, 64, 64, 256, True, 1),     # layer1_0
    (56, 56, 256, 64, 256, False, 2),   # layer1_1..2
    (28, 28, 512, 128, 512, False, 3),  # layer2_1..3
]
SHIFT_SITES = [  # (h, w, c, count) — block inputs under shift_place='block'
    (56, 56, 64, 1), (56, 56, 256, 3), (28, 28, 512, 4),
    (14, 14, 1024, 6), (7, 7, 2048, 2),
]
# TSM-R50 224² backward sites of the 1×1 kernels, per train step:
# (h, c, o, shifted, count) with c the conv's input and o its output width
BWD_SITES = [
    (56, 64, 64, True, 1),      # layer1_0 conv1
    (56, 256, 64, True, 2),     # layer1_1..2 conv1
    (56, 256, 128, True, 1),    # layer2_0 conv1
    (28, 512, 128, True, 3),    # layer2_1..3 conv1
    (28, 512, 256, True, 1),    # layer3_0 conv1
    (14, 1024, 256, True, 5),   # layer3_1..5 conv1
    (14, 1024, 512, True, 1),   # layer4_0 conv1
    (7, 2048, 512, True, 2),    # layer4_1..2 conv1
    (56, 64, 256, False, 4),    # layer1 conv3 x3 + layer1_0 downsample
    (28, 128, 512, False, 4),   # layer2 conv3
    (14, 256, 1024, False, 6),  # layer3 conv3
    (7, 512, 2048, False, 3),   # layer4 conv3
]


# the hand kernels' __global__ functions, as ptxas and the profiler name them
HAND_KERNELS = ("shift_matmul_kernel", "shift_kernel", "fused_bottleneck_kernel",
                "fused_bottleneck_wmma_kernel", "conv1x1_dx_kernel",
                "conv1x1_dw_kernel", "dw_reduce_kernel",
                "attention_bwd_short_kernel", "attention_dkv_kernel",
                "attention_dq_kernel", "attention_fwd_kernel", "attention_kernel")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(text: str) -> list:
    """One line per compiled kernel (its template arguments, e.g. the head
    width <dh> or the dW kernel's <warpgroups,N>, where templated):
    its registers and its spills, from the build's ``ptxas -v`` report."""
    import re
    out, name, spill = [], None, ""
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            mangled = entry.group(1)
            name = next((k for k in HAND_KERNELS if k in mangled), mangled)
            args = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
            if args:
                name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            row = f"{name}: {line.split('Used ', 1)[1].strip()}; {spill}"
            if row not in out:
                out.append(row)
            name = None
    return out


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return t_bytes, t_ops


def check_close(torch, name, got, want, exact=False, of_max=False) -> float:
    """Max |kernel - plain|, checked against 0 (exact), DW_TOL * max|plain|
    (of_max) or TOL * (1 + |plain|) elementwise."""
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    if exact:
        ok, bound = err == 0.0, "0"
    elif of_max:
        top = float(want.float().abs().max())
        ok, bound = err <= DW_TOL * top, f"{DW_TOL} max|plain| = {DW_TOL * top}"
    else:
        ok = bool(((got.float() - want.float()).abs()
                   <= TOL * (1 + want.float().abs())).all())
        bound = f"{TOL} (1 + |plain|)"
    if not ok:
        raise AssertionError(f"{name}: max |kernel - plain| = {err} beyond "
                             f"{bound}")
    return err


def kernel_phase(torch, kernels, g) -> dict:
    """Phase 3: every kernel vs its plain version at the main-path shapes."""
    bf = torch.bfloat16
    dev = "cuda"
    bt = WINDOW_BATCH * FRAMES
    rows = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def sb(n):
        s = torch.rand(n, generator=g, device=dev) * 0.5 + 0.5
        b = torch.randn(n, generator=g, device=dev) * 0.1
        return torch.stack([s, b]).contiguous()

    def add(name, err, ms, plain_ms, tb, to, count, lib_ms=None):
        r = rows.setdefault(name, dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0,
                                       bound=0.0, t_bytes=0.0, t_ops=0.0,
                                       library_ms=None))
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms * count
        r["plain_ms"] += plain_ms * count
        r["bound"] += max(tb, to) * count  # each site at its own bound
        r["t_bytes"] += tb * count
        r["t_ops"] += to * count
        if lib_ms is not None:
            r["library_ms"] = (r["library_ms"] or 0.0) + lib_ms * count

    # kernel 1 at the block-placement sites (BLOCK_BATCH clips)
    bt_block = BLOCK_BATCH * FRAMES
    for h, w, c, count in SHIFT_SITES:
        x = randn(bt_block, h, w, c)
        got = kernels.temporal_shift(x, FRAMES, 8)
        want = kernels.temporal_shift_plain(x, FRAMES, 8)
        torch.cuda.synchronize()
        err = check_close(torch, f"temporal_shift {tuple(x.shape)}", got,
                          want, exact=True)
        ms = time_ms(torch, lambda: kernels.temporal_shift(x, FRAMES, 8), 20)
        pms = time_ms(torch, lambda: kernels.temporal_shift_plain(x, FRAMES, 8), 20)
        tb, to = bound_ms(2 * x.numel() * 2, 0)
        add("temporal_shift", err, ms, pms, tb, to, count)
        log(f"  temporal_shift x{tuple(x.shape)} err={err} kernel={ms:.4f} ms "
            f"plain={pms:.4f} ms bound={max(tb, to):.4f} ms")

    for h, w, c, o, count in SHIFT_MATMUL_SITES:
        x = randn(bt, h, w, c)
        wt = randn(c, o, scale=1 / math.sqrt(c)).contiguous()
        got = kernels.shift_matmul(x, wt, FRAMES, 8)
        want = kernels.shift_matmul_plain(x, wt, FRAMES, 8)
        torch.cuda.synchronize()
        err = check_close(torch, f"shift_matmul {tuple(x.shape)}x{o}", got, want)
        ms = time_ms(torch, lambda: kernels.shift_matmul(x, wt, FRAMES, 8), 10)
        pms = time_ms(torch, lambda: kernels.shift_matmul_plain(x, wt, FRAMES, 8), 5)
        rows_x = x.view(-1, c)
        lms = time_ms(torch, lambda: torch.matmul(rows_x, wt), 10)
        m = bt * h * w
        tb, to = bound_ms((m * c + c * o + m * o) * 2, 2.0 * m * c * o)
        add("shift_matmul", err, ms, pms, tb, to, count, lms)
        log(f"  shift_matmul x{tuple(x.shape)} -> {o} err={err} kernel={ms:.4f} ms "
            f"plain={pms:.4f} ms library (unshifted x @ W)={lms:.4f} ms "
            f"bound={max(tb, to):.4f} ms")

    def fused_params(c, f, o, ds):
        return kernels.FusedBlockParams(
            w1=randn(c, f, scale=math.sqrt(2 / c)).contiguous(), sb1=sb(f),
            w2=randn(3, 3, f, f, scale=math.sqrt(2 / (9 * f))).contiguous(),
            sb2=sb(f),
            w3=randn(f, o, scale=math.sqrt(2 / f)).contiguous(), sb3=sb(o),
            wd=randn(c, o, scale=math.sqrt(2 / c)).contiguous() if ds else None,
            sbd=sb(o) if ds else None)

    def fused_bound(m, c, f, o, ds):
        wbytes = (c * f + 9 * f * f + f * o + (c * o if ds else 0)) * 2
        sbytes = (2 * f * 2 + 2 * o * (2 if ds else 1)) * 4
        flops = 2.0 * m * (c * f + 9 * f * f + f * o + (c * o if ds else 0))
        return bound_ms((m * c + m * o) * 2 + wbytes + sbytes, flops)

    for h, w, c, f, o, ds, count in FUSED_SITES:
        x = randn(bt, h, w, c)
        p = fused_params(c, f, o, ds)
        fold = c // 8
        if not kernels.wgmma_route(c, f, o, ds):
            raise AssertionError(f"fused site C={c} F={f} leaves the wgmma route")
        got = kernels.fused_bottleneck(x, p, n_segment=FRAMES, fold=fold)
        want = kernels.fused_bottleneck_plain(x, p, n_segment=FRAMES, fold=fold)
        torch.cuda.synchronize()
        err = check_close(torch, f"fused_bottleneck {tuple(x.shape)} F={f} O={o}",
                          got, want)
        del got, want
        ms = time_ms(torch, lambda: kernels.fused_bottleneck(
            x, p, n_segment=FRAMES, fold=fold), 10)
        pms = time_ms(torch, lambda: kernels.fused_bottleneck_plain(
            x, p, n_segment=FRAMES, fold=fold), 3)
        # the WMMA route at the same site, for the record (not the model's)
        ms_wmma = time_ms(torch, lambda: kernels.fused_bottleneck_wmma(
            x, p, n_segment=FRAMES, fold=fold), 5)
        tb, to = fused_bound(bt * h * w, c, f, o, ds)
        add("fused_bottleneck", err, ms, pms, tb, to, count)
        # each tile pair reads every weight once from L2
        wbytes = kernels.wgmma_tiles(bt, h, w)[1] * 2 * (
            c * f + 9 * f * f + f * o + (c * o if ds else 0))
        log(f"  fused_bottleneck x{tuple(x.shape)} F={f} O={o} ds={ds} err={err} "
            f"kernel={ms:.4f} ms plain={pms:.4f} ms bound={max(tb, to):.4f} ms "
            f"weights from L2 {wbytes / 1e6:.1f} MB "
            f"(WMMA route at this site {ms_wmma:.4f} ms)")
        del x, p
    # the WMMA route where the rule sends a shape to it: F = 256 (a layer3
    # bottleneck, which TSM-R50's fused path does not reach)
    h, w, c, f, o = 14, 14, 1024, 256, 1024
    if kernels.wgmma_route(c, f, o, False):
        raise AssertionError(f"F={f} takes the wgmma route")
    x = randn(bt, h, w, c)
    p = fused_params(c, f, o, False)
    before = kernels.launch_counts()
    got = kernels.fused_bottleneck(x, p, n_segment=FRAMES, fold=c // 8)
    torch.cuda.synchronize()
    ran = {k: n - before[k] for k, n in kernels.launch_counts().items()
           if n != before[k]}
    if ran != {"fused_bottleneck_wmma": 1}:
        raise AssertionError(f"fused_bottleneck at F={f} launched {ran}")
    err = check_close(torch, f"fused_bottleneck_wmma {tuple(x.shape)} F={f}", got,
                      kernels.fused_bottleneck_plain(x, p, n_segment=FRAMES,
                                                     fold=c // 8))
    ms = time_ms(torch, lambda: kernels.fused_bottleneck(
        x, p, n_segment=FRAMES, fold=c // 8), 5)
    pms = time_ms(torch, lambda: kernels.fused_bottleneck_plain(
        x, p, n_segment=FRAMES, fold=c // 8), 3)
    tb, to = fused_bound(bt * h * w, c, f, o, False)
    log(f"  fused_bottleneck_wmma (WMMA route) x{tuple(x.shape)} F={f} O={o} "
        f"err={err} kernel={ms:.4f} ms plain={pms:.4f} ms "
        f"bound={max(tb, to):.4f} ms")
    del x, p, got
    attention_row(torch, kernels, randn, add)
    attention_bwd_rows(torch, kernels, randn, add)
    backward_rows(torch, kernels, randn, add)
    return rows


def attention_row(torch, kernels, randn, add) -> None:
    """The attention forward as the model runs it (``Attention.apply``
    writes the log-sum-exp in inference too, so ``attention_lse``): q, k, v
    the strided thirds of a packed (frames, l, 3·768) projection. At
    TimeSformer-B/16's l = 197 the one-block kernel (``attention``), with
    the tiled kernel at the same shape printed beside it; at the 288²
    step's l = 325 the tiled route (``attention_tiled``), which the rule
    sends there."""
    import torch.nn.functional as F
    n, h, dh = WINDOW_BATCH * FRAMES, TS_HEADS, TS_DH
    d = h * dh
    scale = dh ** -0.5
    for l, name in ((TS_TOKENS, "attention"), (TILED_L, "attention_tiled")):
        qkv = randn(n, l, 3 * d)
        q, k, v = kernels.split_heads(qkv, h)
        before = kernels.launch_counts()
        got, lse = kernels.attention_lse(q, k, v, scale)
        want, lse_want = kernels.attention_lse_plain(q, k, v, scale)
        torch.cuda.synchronize()
        ran = {c: m - before[c] for c, m in kernels.launch_counts().items()
               if m != before[c]}
        if ran != {name: 1}:
            raise AssertionError(f"attention_lse at l = {l} launched {ran}, "
                                 f"not {{{name!r}: 1}}")
        err = check_close(torch, f"{name} {(n, h, l, dh)}", got, want)
        lse_err = check_close(torch, f"{name} lse {(n, h, l, dh)}", lse, lse_want)
        del got, want, lse, lse_want
        ms = time_ms(torch, lambda: kernels.attention_lse(q, k, v, scale), 20)
        pms = time_ms(torch, lambda: kernels.attention_lse_plain(q, k, v, scale), 5)
        lms = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), 20)
        # q, k, v read once, o written once, lse written once; two products
        # of 2·l·l·dh each
        tb, to = bound_ms(4 * n * h * l * dh * 2 + n * h * l * 4,
                          4.0 * n * h * l * l * dh)
        add(name, max(err, lse_err), ms, pms, tb, to, TS_LAYERS, lms)
        beside = ""
        if name == "attention":
            tms = time_ms(torch, lambda: kernels.attention_tiled(
                q, k, v, scale, with_lse=True), 20)
            beside = f" (tiled route at this l {tms:.4f} ms)"
        log(f"  {name} (n, h, l, dh)={(n, h, l, dh)} packed qkv, with lse: "
            f"err={err} lse err={lse_err} kernel={ms:.4f} ms{beside} plain="
            f"{pms:.4f} ms library={lms:.4f} ms bound={max(tb, to):.4f} ms "
            f"(bytes {tb:.4f}, ops {to:.4f})")
        del qkv, q, k, v
        torch.cuda.empty_cache()


def attention_bwd_rows(torch, kernels, randn, add) -> None:
    """The attention backward at TimeSformer-B/16's spatial attention
    (the one-launch kernel) and at l = TILED_L (the tiled dK/dV and dQ
    kernels, with D formed beside them): q, k, v the strided thirds of a
    packed (frames, l, 3·768) projection, o and lse from the forward
    kernel, the gradients written into the thirds of a packed gradient, as
    the model's backward does. The plain version (attention_bwd_plain) and
    the library yardstick (the backward of scaled_dot_product_attention
    alone) each compute dQ, dK and dV (and D) in one call."""
    from workoutdetector_tpu_torch.ops.kernels.attention import attention_delta
    n, h, dh = WINDOW_BATCH * FRAMES, TS_HEADS, TS_DH
    d = h * dh
    scale = dh ** -0.5
    for l in (TS_TOKENS, TILED_L):
        qkv = randn(n, l, 3 * d)
        q, k, v = kernels.split_heads(qkv, h)
        o, lse = kernels.attention_lse(q, k, v, scale)
        (do,) = kernels.split_heads(randn(n, l, d), h, parts=1)
        grads = kernels.split_heads(torch.empty_like(qkv), h)
        before = kernels.launch_counts()
        kernels.attention_bwd(q, k, v, o, lse, do, scale, *grads)
        want = kernels.attention_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        ran = {name: c - before[name] for name, c in kernels.launch_counts().items()
               if c != before[name]}
        route = {"attention_bwd": 1} if kernels.short_route(l, dh) else \
            {"attention_dkv": 1, "attention_dq": 1}
        if ran != route:
            raise AssertionError(f"attention_bwd at l = {l} launched {ran}, "
                                 f"not {route}")
        errs = [check_close(torch, f"attention_bwd {name} {(n, h, l, dh)}",
                            got, ref)
                for name, got, ref in zip(("dq", "dk", "dv"), grads, want)]
        del want
        pms = time_ms(torch, lambda: kernels.attention_bwd_plain(
            q, k, v, o, lse, do, scale), 5)
        lms, backend = library_attention_bwd(torch, q, k, v, do, scale)
        elems, vec = n * h * l * dh * 2, n * h * l * 4
        if "attention_bwd" in route:
            # q, k, v, dO, o read once, dq, dk, dv written once, lse read
            # once; five products of 2·l·l·dh (S, dP, dV, dK, dQ)
            ms = time_ms(torch, lambda: kernels.attention_bwd(
                q, k, v, o, lse, do, scale, *grads), 20)
            tb, to = bound_ms(8 * elems + vec, 10.0 * n * h * l * l * dh)
            add("attention_bwd", max(errs), ms, pms, tb, to, TS_LAYERS, lms)
            log(f"  attention_bwd (n, h, l, dh)={(n, h, l, dh)} packed, one "
                f"launch: err={max(errs)} kernel={ms:.4f} ms plain (dq, dk, "
                f"dv)={pms:.4f} ms library (sdpa backward, {backend}, D "
                f"included)={lms:.4f} ms bound={max(tb, to):.4f} ms (bytes "
                f"{tb:.4f}, ops {to:.4f})")
            continue
        dq, dk, dv = grads
        delta = attention_delta(o, do)
        ms_dkv = time_ms(torch, lambda: kernels.attention_dkv(
            q, k, v, do, lse, delta, scale, dk, dv), 20)
        ms_dq = time_ms(torch, lambda: kernels.attention_dq(
            q, k, v, do, lse, delta, scale, dq), 20)
        dms = time_ms(torch, lambda: attention_delta(o, do), 20)
        # each (n, h, l, dh) bf16 tensor read or written once, lse and D read
        # once; dK/dV: four products of 2·l·l·dh (S, dP, dV, dK), dQ: three
        tb, to = bound_ms(6 * elems + 2 * vec, 8.0 * n * h * l * l * dh)
        add("attention_dkv", max(errs[1:]), ms_dkv, pms, tb, to, TS_LAYERS, lms)
        log(f"  attention_dkv (n, h, l, dh)={(n, h, l, dh)} packed, tiled "
            f"route: err={max(errs[1:])} kernel={ms_dkv:.4f} ms plain (dq, "
            f"dk, dv)={pms:.4f} ms library (sdpa backward, {backend}, D "
            f"included)={lms:.4f} ms bound={max(tb, to):.4f} ms (bytes "
            f"{tb:.4f}, ops {to:.4f})")
        tb, to = bound_ms(5 * elems + 2 * vec, 6.0 * n * h * l * l * dh)
        add("attention_dq", errs[0], ms_dq, pms, tb, to, TS_LAYERS, lms)
        log(f"  attention_dq (n, h, l, dh)={(n, h, l, dh)} packed, tiled "
            f"route: err={errs[0]} kernel={ms_dq:.4f} ms bound="
            f"{max(tb, to):.4f} ms (bytes {tb:.4f}, ops {to:.4f})")
        log(f"  tiled route per launch: D = rowsum(dO o O) {dms:.4f} ms, "
            f"dK/dV + dQ + D {ms_dkv + ms_dq + dms:.4f} ms against the "
            f"library's {lms:.4f} ms")
        del qkv, q, k, v, o, lse, do, grads, dq, dk, dv, delta
        torch.cuda.empty_cache()


def library_attention_bwd(torch, q, k, v, do, scale):
    """The backward of ``scaled_dot_product_attention`` alone: autograd
    from its output to contiguous (n, h, l, dh) q, k, v leaves with a
    contiguous dO, the forward run once outside the timing. Each backend
    that takes the shape is timed; returns (the fastest's ms, its name).
    Every backend computes D = rowsum(dO ∘ O) inside its backward."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    leaves = [t.detach().contiguous().requires_grad_(True) for t in (q, k, v)]
    do = do.contiguous()
    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        try:
            with sdpa_kernel([backend]):
                out = F.scaled_dot_product_attention(*leaves, scale=scale)
            times[backend.name] = time_ms(torch, lambda: torch.autograd.grad(
                out, leaves, do, retain_graph=True), 20)
        except RuntimeError as exc:  # the backend does not take the shape
            log(f"    sdpa backend {backend.name}: {str(exc)[:120]}")
        out = None
    log("    sdpa backward alone: " + ", ".join(
        f"{name} {ms:.4f} ms" for name, ms in times.items()))
    name = min(times, key=times.get)
    return times[name], name


def backward_rows(torch, kernels, randn, add) -> None:
    """dx and dW at every TSM-R50 224² backward site of one train step
    (batch 32 clips = 256 frames), and the shift-matmul forward at its
    shifted sites (``shift_matmul_train``)."""
    frames = TRAIN_BATCH * FRAMES
    for h, c, o, shifted, count in BWD_SITES:
        r = frames * h * h
        spec = (FRAMES, c // 8, h * h) if shifted else (1, 0, 1)
        x = randn(r, c)
        g = randn(r, o)
        w = randn(c, o, scale=1 / math.sqrt(o))
        wt = w.t()  # the weight as the model's backward passes it
        site = f"R={r} C={c} O={o}{' shifted' if shifted else ''}"
        if shifted:  # the forward of ShiftConv1x1 at this site
            x4 = x.view(frames, h, h, c)
            got = kernels.shift_matmul(x4, w, FRAMES, 8)
            want = kernels.shift_matmul_plain(x4, w, FRAMES, 8)
            torch.cuda.synchronize()
            err = check_close(torch, f"shift_matmul_train {site}", got, want)
            del got, want
            ms = time_ms(torch, lambda: kernels.shift_matmul(x4, w, FRAMES, 8), 10)
            pms = time_ms(torch, lambda: kernels.shift_matmul_plain(x4, w, FRAMES, 8), 3)
            lms = time_ms(torch, lambda: torch.matmul(x, w), 10)
            tb, to = bound_ms((r * c + c * o + r * o) * 2, 2.0 * r * c * o)
            add("shift_matmul_train", err, ms, pms, tb, to, count, lms)
            log(f"  shift_matmul_train {site} err={err} kernel={ms:.4f} ms "
                f"plain={pms:.4f} ms library (unshifted x @ W)={lms:.4f} ms "
                f"bound={max(tb, to):.4f} ms")
        got = kernels.conv1x1_dx(g, wt, *spec)
        want = kernels.conv1x1_dx_plain(g, wt, *spec)
        torch.cuda.synchronize()
        err = check_close(torch, f"conv1x1_dx {site}", got, want)
        del got, want
        ms = time_ms(torch, lambda: kernels.conv1x1_dx(g, wt, *spec), 10)
        pms = time_ms(torch, lambda: kernels.conv1x1_dx_plain(g, wt, *spec), 3)
        lms = time_ms(torch, lambda: torch.matmul(g, wt), 10)
        tb, to = bound_ms((r * o + o * c + r * c) * 2, 2.0 * r * o * c)
        add("conv1x1_dx", err, ms, pms, tb, to, count, lms)
        log(f"  conv1x1_dx {site} err={err} kernel={ms:.4f} ms plain={pms:.4f}"
            f" ms library={lms:.4f} ms bound={max(tb, to):.4f} ms")
        got = kernels.conv1x1_dw(x, g, *spec)
        want = kernels.conv1x1_dw_plain(x, g, *spec)
        torch.cuda.synchronize()
        err = check_close(torch, f"conv1x1_dw {site}", got, want, of_max=True)
        del got, want
        ms = time_ms(torch, lambda: kernels.conv1x1_dw(x, g, *spec), 10)
        pms = time_ms(torch, lambda: kernels.conv1x1_dw_plain(x, g, *spec), 3)
        lms = time_ms(torch, lambda: torch.matmul(x.t(), g), 10)
        tb, to = bound_ms((r * c + r * o) * 2 + c * o * 4, 2.0 * r * c * o)
        add("conv1x1_dw", err, ms, pms, tb, to, count, lms)
        log(f"  conv1x1_dw {site} err={err} kernel={ms:.4f} ms plain={pms:.4f}"
            f" ms library={lms:.4f} ms bound={max(tb, to):.4f} ms")
        del x, g, w, wt
        torch.cuda.empty_cache()


def train_config(Config, steps: int, dataset_size: int, root: str):
    """The flagship configuration (repcount_12_tsm.yaml) built in code, on a
    DebugDataset at 224² with 12 classes."""
    cfg = Config()
    m, o, d, t = cfg.model, cfg.optimizer, cfg.data, cfg.trainer
    m.model_type, m.base_model, m.num_class = "tsm", "resnet50", NUM_CLASS
    m.num_segments, m.dtype, m.dropout = FRAMES, "bfloat16", 0.5
    m.partial_bn = m.fc_lr5 = True
    o.method, o.lr, o.momentum, o.weight_decay = "sgd", 0.005, 0.9, 5e-4
    o.grad_clip, o.use_tsn_policies = 20.0, True
    cfg.lr_scheduler.policy, cfg.lr_scheduler.step = "steplr", 8
    d.dataset_type, d.image_size, d.num_segments = "DebugDataset", SIZE, FRAMES
    d.debug_num_class, d.debug_size, d.batch_size = NUM_CLASS, dataset_size, \
        TRAIN_BATCH
    t.max_steps, t.max_epochs, t.log_every_n_steps = steps, 50, 1
    t.default_root_dir = root
    cfg.log.tensorboard_enable = False
    cfg.callbacks.modelcheckpoint.dirpath = root + "/ckpt"
    return cfg


def train_phase(np, torch, kernels, variables, repo: Path, card: str):
    """Phase 6: the training path at full width. Returns (the fit's launch
    counts, the shift-matmul launches of its train steps, train clips/s)."""
    import csv
    import tempfile

    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.models import build_model, load_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer, cross_entropy

    # 4 train batches (tail dropped) and 5 val batches, the last one 8 real
    # clips and 24 pad rows
    size = TRAIN_STEPS * TRAIN_BATCH + 8
    val_forwards = -(-size // TRAIN_BATCH)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".smoke-train-") as root:
        cfg = train_config(Config, TRAIN_STEPS, size, root)
        trainer = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, history = trainer.fit(variables=variables)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {"conv1x1_dx": 33 * TRAIN_STEPS, "conv1x1_dw": 33 * TRAIN_STEPS,
                "shift_matmul": 16 * TRAIN_STEPS + 10 * val_forwards,
                "fused_bottleneck": 6 * val_forwards, "temporal_shift": 0,
                "fused_bottleneck_wmma": 0, "attention": 0,
                "attention_tiled": 0, "attention_bwd": 0, "attention_dkv": 0,
                "attention_dq": 0}
        log(f"    fit: {state.step} steps + {val_forwards} val forwards in "
            f"{seconds:.2f} s, launches={launches}")
        if launches != want:
            raise AssertionError(f"training launch counts {launches} != {want}")
        runs = [p for p in Path(root).iterdir() if p.name != "ckpt"]
        with open(runs[0] / "csv" / "metrics.csv") as f:
            losses = [float(r["train/loss"]) for r in csv.DictReader(f)
                      if r.get("train/loss")]
        log(f"    train losses {losses}; val {history}")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or \
                not math.isfinite(history["val/loss"]):
            raise AssertionError("training gave a non-finite or missing loss")
        if not (Path(root) / "ckpt" / "last").exists():
            raise AssertionError("fit wrote no 'last' checkpoint")
        batches = iter(trainer._loader("train", shuffle=True))
        x_u8, y = next(batches)
        batches.close()  # stops the loader's thread
        del trainer, state
        torch.cuda.empty_cache()

    from workoutdetector_tpu_torch.ops.kernels import conv1x1 as c1

    def drop_shift(real):  # the wrapper without its shift arguments
        def fault(a, b, *shift):
            return real(a, b)
        fault.launches = 0  # the real wrapper counts on its module's name
        return fault

    # ShiftConv1x1.backward calls the module's wrappers, so swapping one for
    # a version that drops the shift miswires all 16 sites
    grad_check(np, torch, build_model, load_flax_variables, cross_entropy,
               cfg, variables, TRAIN_BATCH,
               {"dx without S^T": (c1, "conv1x1_dx", drop_shift),
                "dW over unshifted x": (c1, "conv1x1_dw", drop_shift)})

    def two_steps():
        c = train_config(Config, 2, 2 * TRAIN_BATCH, "unused")
        c.trainer.enable_checkpointing = False
        c.trainer.check_val_every_n_epoch = 1000
        c.log.csv_enable = False
        with tempfile.TemporaryDirectory(dir=repo, prefix=".smoke-det-") as r:
            c.trainer.default_root_dir = r
            st, _ = Trainer(c, device="cuda").fit(variables=variables)
        torch.cuda.synchronize()
        return {k: v.clone() for k, v in st.model.state_dict().items()}

    a, b = two_steps(), two_steps()
    same = all(torch.equal(a[k], b[k]) for k in a)
    log(f"    two identical 2-step runs: {len(a)} tensors, bit-identical: {same}")
    if not same:
        raise AssertionError("repeated training runs differ")
    del a, b

    trainer = Trainer(train_config(Config, 0, 0, "unused"), device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, x_u8, y)  # first step: cuDNN plans, allocator
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.train_step(state, x_u8, y)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    clips_s = TRAIN_BATCH / step_s
    log(f"    train step {step_s * 1e3:.2f} ms = {clips_s:.2f} clips/s at batch "
        f"{TRAIN_BATCH} on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(torch, lambda: trainer.train_step(state, x_u8, y), top=20)
    return launches, launches["shift_matmul"] - 10 * val_forwards, clips_s


def grad_check(np, torch, build_model, load_flax_variables, cross_entropy,
               cfg, variables, batch: int, faults: dict) -> None:
    """One batch's gradients of the main path (bf16, kernels) against the
    port's plain path in fp32 on the card, per leaf, with the bf16 plain
    path's own error beside; the three runs draw the same dropout and
    drop-path masks (one generator seed, masks drawn in fp32). The batch
    is numpy-seeded noise, different in every frame (a DebugDataset clip
    repeats one colour, so a fault in a temporal direction would barely
    show). Then the same check with each planted fault, which it must
    catch: ``faults`` maps a label to (module, attribute, make), and the
    attribute is replaced by ``make(real)`` for that run."""
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip

    rng = np.random.default_rng(5)
    x = normalize_clip(torch.from_numpy(rng.integers(
        0, 256, (batch, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)).cuda())
    yt = torch.from_numpy(rng.integers(0, NUM_CLASS, batch)).cuda()

    def grads(dtype, use_kernels):
        c = cfg.clone()
        c.model.dtype = dtype
        model = build_model(c.model, use_kernels=use_kernels).cuda()
        load_flax_variables(model, variables)
        model.train()
        g = torch.Generator(device="cuda").manual_seed(7)
        loss = cross_entropy(model(x, dropout_generator=g), yt).mean()
        loss.backward()
        out = {n: p.grad.float().clone() for n, p in model.named_parameters()}
        del model, loss
        torch.cuda.empty_cache()
        return out

    torch.cuda.reset_peak_memory_stats()
    ref = grads("float32", False)
    peak = torch.cuda.max_memory_allocated() / 2**30
    plain16 = grads("bfloat16", False)
    got = grads("bfloat16", True)

    def rel(a):
        return {n: float((a[n] - ref[n]).norm() / ref[n].norm().clamp(min=1e-30))
                for n in ref}

    err, err16 = rel(got), rel(plain16)

    def beyond(e):
        return [n for n in e if not math.isfinite(e[n])
                or e[n] > GRAD_RATIO * err16[n] + GRAD_FLOOR]

    def ratio(e):
        return max(e[n] / max(err16[n], 1e-12) for n in e)

    worst = sorted(err, key=err.get, reverse=True)[:3]
    log(f"    grads vs fp32 plain path ({len(ref)} leaves, fp32 peak "
        f"{peak:.2f} GiB): max rel err {max(err.values()):.5f} "
        f"(bf16 plain path {max(err16.values()):.5f}); worst "
        + ", ".join(f"{n} {err[n]:.5f}/{err16[n]:.5f}" for n in worst)
        + f"; largest kernel/plain-bf16 ratio {ratio(err):.3f}")
    bad = beyond(err)
    if bad:
        raise AssertionError(f"gradients of {bad[:5]} beyond {GRAD_RATIO} x "
                             f"the bf16 plain path's error + {GRAD_FLOOR}")

    for label, (module, name, make) in faults.items():
        real = getattr(module, name)
        setattr(module, name, make(real))
        try:
            e = rel(grads("bfloat16", True))
        finally:
            setattr(module, name, real)
        caught = beyond(e)
        log(f"    planted fault '{label}': max rel err {max(e.values()):.5f}, "
            f"largest ratio {ratio(e):.3f}, {len(caught)}/{len(e)} leaves "
            f"beyond the limit")
        if not caught:
            raise AssertionError(f"the gradient check misses the planted "
                                 f"fault '{label}'")


def profile_call(torch, fn, top: int = 10):
    """One call under torch.profiler: device time by kernel (copies
    included), hand kernels apart, and the device's idle share of the span
    from its first to its last recorded activity, which it returns (None
    when the profiler recorded no device time)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name, calls, skipped, starts, ends = {}, {}, {}, [], []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        # device work only: kernels and copies, not the ranges of user
        # annotations (e.g. the optimizer's step) nor the profiler's own
        # buffer requests, which overlap or are not device work
        if getattr(e, "is_user_annotation", False) or \
                e.name == "Activity Buffer Request" or \
                e.name.startswith("Optimizer."):
            skipped[e.name] = skipped.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            continue
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        calls[e.name] = calls.get(e.name, 0) + 1
        starts.append(e.time_range.start)
        ends.append(e.time_range.end)
    if not by_name:
        log("    profiler: no device time recorded")
        return None
    wall_ms = (max(ends) - min(starts)) / 1e3
    device_ms = sum(by_name.values())
    hand = {k: v for k, v in by_name.items()
            if any(n in k for n in HAND_KERNELS)}
    log(f"    profile: device span {wall_ms:.3f} ms, busy {device_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - device_ms / wall_ms):.3f}) in "
        f"{sum(calls.values())} device activities, hand kernels "
        f"{sum(hand.values()):.3f} ms, other {device_ms - sum(hand.values()):.3f} ms")
    if skipped:
        log("    not device work (left out): " + ", ".join(
            f"{n[:40]} {ms:.3f} ms" for n, ms in sorted(skipped.items())))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"      {ms:9.3f} ms {calls[name]:4d}x  {name[:160]}")
    return max(0.0, 1 - device_ms / wall_ms)


def timesformer_phase(np, torch, kernels, video, card: str):
    """Phase 7: TimeSformer-B/16 inference on the card. Returns (the
    attention kernel's launches, clips/s)."""
    from workoutdetector_tpu_torch.config import Config
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_video_model)
    from workoutdetector_tpu_torch.models import (build_model,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables

    # workoutdetector_tpu/configs/timesformer.yaml's model, built in code
    cfg = Config().model
    cfg.model_type, cfg.base_model = "timesformer", "vit_base_patch16_224"
    cfg.num_class, cfg.num_segments, cfg.image_size = NUM_CLASS, FRAMES, SIZE
    cfg.attention_type, cfg.dtype = "divided_space_time", "bfloat16"
    model = build_model(cfg)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    engine = InferenceEngine(model, FRAMES, WINDOW_BATCH, device="cuda")
    if not engine.model.fold_temporal_fc:
        raise AssertionError("the engine did not fold t_fc")
    engine.score_video(video[:24], step=8, stride=2)  # warm-up
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    starts, logits = engine.score_video(video, step=8, stride=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    count, reps = count_by_video_model(engine, video)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    forwards = math.ceil(len(starts) / WINDOW_BATCH) + \
        math.ceil((len(video) // 8) / WINDOW_BATCH)
    log(f"    windows={len(starts)} forwards={forwards} launches={launches}")
    want = {name: 0 for name in launches}
    want["attention"] = TS_LAYERS * forwards
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if logits.shape != (len(starts), NUM_CLASS) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}")
    clips_per_s = len(starts) / seconds
    log(f"    score_video: {len(starts)} windows in {seconds:.4f} s = "
        f"{clips_per_s:.2f} clips/s on {card}")
    log(f"    count_by_video_model: count={count} reps={reps}")
    batch = engine.gather_windows(video, starts[:WINDOW_BATCH], stride=2)
    profile_call(torch, lambda: engine.score_windows(batch))

    ref_cfg = cfg.clone()
    ref_cfg.dtype = "float32"
    ref_model = build_model(ref_cfg, use_kernels=False)
    load_flax_variables(ref_model, variables)
    ref_engine = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH,
                                 device="cuda", optimize=False)
    _, ref = ref_engine.score_video(video, step=8, stride=2)
    logit_rule(np, logits, ref, "TimeSformer main path")
    count_check(np, torch, engine, ref_engine, video, "TimeSformer main path")
    return launches["attention"], clips_per_s


def ts_train_config(repo: Path, steps: int, dataset_size: int, root: str):
    """workoutdetector_tpu/configs/timesformer.yaml as the CLI loads it
    (ViT-B/16 224², 8 segments, 12 classes, divided attention, drop_path
    0.1, bf16; SGD Nesterov, wd 1e-4 with the embeddings exempt, clip 40,
    multistep; batch 16) with a DebugDataset of 12 classes in place of its
    FrameDataset, which needs data the repo lacks, and the run's step
    count and paths."""
    from workoutdetector_tpu_torch.config import load_config
    cfg = load_config(str(repo / "workoutdetector_tpu" / "configs"
                          / "timesformer.yaml"))
    d, t = cfg.data, cfg.trainer
    d.dataset_type, d.debug_num_class, d.debug_size = "DebugDataset", \
        cfg.model.num_class, dataset_size
    t.max_steps, t.log_every_n_steps, t.default_root_dir = steps, 1, root
    cfg.log.tensorboard_enable = False
    cfg.callbacks.modelcheckpoint.dirpath = root + "/ckpt"
    return cfg


def timesformer_train_phase(np, torch, kernels, repo: Path, card: str):
    """Phase 8: TimeSformer-B/16 training at full width. Returns (the fit's
    launch counts, train clips/s)."""
    import csv
    import tempfile

    from workoutdetector_tpu_torch.models import build_model, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer, cross_entropy

    # 4 train batches (tail dropped) and 5 val batches, the last one 8 real
    # clips and 8 pad rows; the weights from the port's flax initializers
    size = TRAIN_STEPS * TS_TRAIN_BATCH + 8
    val_forwards = -(-size // TS_TRAIN_BATCH)
    with tempfile.TemporaryDirectory(dir=repo, prefix=".smoke-ts-train-") as root:
        cfg = ts_train_config(repo, TRAIN_STEPS, size, root)
        if cfg.data.batch_size != TS_TRAIN_BATCH:
            raise AssertionError(f"timesformer.yaml's batch is "
                                 f"{cfg.data.batch_size}, not {TS_TRAIN_BATCH}")
        trainer = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        state, history = trainer.fit()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {name: 0 for name in launches}
        want.update(attention=TS_LAYERS * (TRAIN_STEPS + val_forwards),
                    attention_bwd=TS_LAYERS * TRAIN_STEPS)
        log(f"    fit: {state.step} steps + {val_forwards} val forwards in "
            f"{seconds:.2f} s, launches={launches}")
        if launches != want:
            raise AssertionError(f"training launch counts {launches} != {want}")
        runs = [p for p in Path(root).iterdir() if p.name != "ckpt"]
        with open(runs[0] / "csv" / "metrics.csv") as f:
            losses = [float(r["train/loss"]) for r in csv.DictReader(f)
                      if r.get("train/loss")]
        log(f"    train losses {losses}; val {history}")
        if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all() or \
                not math.isfinite(history["val/loss"]):
            raise AssertionError("training gave a non-finite or missing loss")
        if not (Path(root) / "ckpt" / "last").exists():
            raise AssertionError("fit wrote no 'last' checkpoint")
        batches = iter(trainer._loader("train", shuffle=True))
        x_u8, y = next(batches)
        batches.close()  # stops the loader's thread
        del trainer, state
        torch.cuda.empty_cache()

    # random weights give t_fc non-zero values (its init is zero, which
    # would hide the temporal branch's gradients)
    variables = random_flax_variables(build_model(cfg.model), seed=0)

    def neighbour_head(real):  # the kernel reads the next head's dO
        def fault(q, k, v, o, lse, do, *rest, **kw):
            return real(q, k, v, o, lse, do.roll(1, dims=1), *rest, **kw)
        fault.launches = 0  # the wrapper counts on its module's name
        return fault

    # the module (the package's name ``attention`` is its wrapper function)
    ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")

    grad_check(np, torch, build_model, load_flax_variables, cross_entropy,
               cfg, variables, TS_TRAIN_BATCH,
               {"dO of the neighbouring head":
                (ka, "attention_bwd", neighbour_head)})

    trainer = Trainer(ts_train_config(repo, 0, 0, "unused"), device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, x_u8, y)  # first step: cuDNN plans, allocator
    torch.cuda.synchronize()
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.train_step(state, x_u8, y)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    clips_s = TS_TRAIN_BATCH / step_s
    log(f"    train step {step_s * 1e3:.2f} ms = {clips_s:.2f} clips/s at batch "
        f"{TS_TRAIN_BATCH} on {card}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    profile_call(torch, lambda: trainer.train_step(state, x_u8, y), top=20)
    del trainer, state
    torch.cuda.empty_cache()
    return launches, clips_s


def tiled_route_phase(np, torch, kernels, repo: Path) -> dict:
    """Phase 8, tiled route: one train step of TimeSformer-B/16 on
    TS_LONG_SIZE² frames (TILED_L = 18² + 1 = 325 tokens, more than the
    one-launch backward's shared memory takes), so each attention backward
    runs the tiled dK/dV and dQ kernels at the shape phase 3 checks them
    at. Returns the step's launch counts."""
    from workoutdetector_tpu_torch.models import build_model
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer

    cfg = ts_train_config(repo, 0, 0, "unused")
    cfg.data.image_size = cfg.model.image_size = TS_LONG_SIZE
    l = TILED_L
    if kernels.short_route(l, TS_DH):
        raise AssertionError(f"l = {l} takes the one-launch route")
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=random_flax_variables(
        build_model(cfg.model), seed=0))
    rng = np.random.default_rng(6)
    x_u8 = rng.integers(0, 256, (TS_TRAIN_BATCH, FRAMES, TS_LONG_SIZE,
                                 TS_LONG_SIZE, 3), dtype=np.uint8)
    y = rng.integers(0, NUM_CLASS, TS_TRAIN_BATCH)
    torch.cuda.synchronize()
    kernels.reset_launches()
    loss = float(trainer.train_step(state, x_u8, y)["loss"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    want = {name: 0 for name in launches}
    want.update(attention_tiled=TS_LAYERS, attention_dkv=TS_LAYERS,
                attention_dq=TS_LAYERS)
    log(f"    {TS_LONG_SIZE}² frames (l = {l}): one train step, loss {loss:.4f}, "
        f"launches={launches}")
    if launches != want:
        raise AssertionError(f"tiled-route launch counts {launches} != {want}")
    if not math.isfinite(loss):
        raise AssertionError("the tiled-route train step gave a non-finite loss")
    del trainer, state
    torch.cuda.empty_cache()
    return launches


def logit_rule(np, logits, ref, what: str) -> None:
    """bf16 logits against the fp32 plain path: max |diff| within
    0.05·(1 + max|logit|), argmax equal on every window whose fp32 top-2
    margin exceeds twice that diff."""
    err = float(np.abs(logits - ref).max())
    scale = float(np.abs(ref).max())
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * err
    agree = logits.argmax(1) == ref.argmax(1)
    log(f"    vs plain fp32 path: max |logit diff| {err:.5f} "
        f"(max |logit| {scale:.4f}); argmax agrees on {int(agree.sum())}/"
        f"{len(agree)} windows, required on the {int(decided.sum())} whose "
        "fp32 top-2 margin exceeds 2x that diff")
    if err > 0.05 * (1 + scale) or not agree[decided].all():
        raise AssertionError(f"{what} disagrees with the fp32 plain path")


COUNT_BLOCK = 4  # windows per head-bias block of the count check


def count_check(np, torch, engine, ref_engine, video, what: str) -> None:
    """Counts on the card. Random weights give every window one argmax, so
    the count check moves the head bias: count_by_video_model's windows
    (consecutive 8-frame chunks) are scored in blocks of COUNT_BLOCK by the
    bf16 kernel path and the fp32 plain path, the head bias of both set per
    block to take the fp32 path's mean logit off every class and add 2 x
    its largest deviation + 1 to the block's target class, block k's target
    being k mod 12 (so the states run 0, 1, 2, ... and every even-to-odd
    step is a rep). Both argmax sequences go through pred_to_count; they
    must agree (``count_rule``) and count at least 2 reps. A planted swap
    of two windows' kernel-path logits (blocks 0 and 1) must fail the same
    rule."""
    from workoutdetector_tpu_torch.counting import pred_to_count

    n = len(video) // 8
    windows = engine.gather_windows(video, np.arange(0, n * 8, 8), stride=1)
    base = ref_engine.score_windows(windows)
    center = base.mean(0)
    boost = 2 * float(np.abs(base - center).max()) + 1.0

    def scored(eng):
        fc = eng.model.fc
        orig = fc.bias.detach().clone()
        out = []
        try:
            for k in range(0, n, COUNT_BLOCK):
                shift = -center.copy()
                shift[(k // COUNT_BLOCK) % len(shift)] += boost
                fc.bias.data = orig + torch.from_numpy(shift).to(orig)
                out.append(eng.score_windows(windows[k:k + COUNT_BLOCK]))
        finally:
            fc.bias.data = orig
        return np.concatenate(out)

    got, ref = scored(engine), scored(ref_engine)
    err = float(np.abs(got - ref).max())
    counts = count_rule(np, pred_to_count, got, ref, err, what)
    log(f"    count check ({n} windows, blocks of {COUNT_BLOCK}, boost "
        f"{boost:.3f}): kernel path count {counts[0]}, fp32 plain path "
        f"{counts[1]}, max |logit diff| {err:.5f}")
    planted = got.copy()
    planted[[1, 1 + COUNT_BLOCK]] = planted[[1 + COUNT_BLOCK, 1]]
    try:
        count_rule(np, pred_to_count, planted, ref, err, what)
    except AssertionError as exc:
        log(f"    planted swap of windows 1 and {1 + COUNT_BLOCK}: caught ({exc})")
    else:
        raise AssertionError(f"{what}: the count check misses a planted swap "
                             "of two windows' logits")


def count_rule(np, pred_to_count, logits, ref, err: float, what: str):
    """The argmax of ``logits`` equals the fp32 path's on every window whose
    fp32 top-2 margin exceeds 2 x err (logit_rule's limit), the two counts
    are equal, and the fp32 path counts at least 2 reps. Returns the two
    counts."""
    top2 = np.sort(ref, axis=1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * err
    seq, ref_seq = logits.argmax(1), ref.argmax(1)
    count, _ = pred_to_count([int(a) for a in seq], step=8)
    ref_count, _ = pred_to_count([int(a) for a in ref_seq], step=8)
    wrong = np.flatnonzero(decided & (seq != ref_seq))
    if len(wrong) or count != ref_count or ref_count < 2:
        raise AssertionError(
            f"{what} counts: argmax differs on decided windows "
            f"{wrong.tolist()[:8]} ({int(decided.sum())}/{len(decided)} "
            f"decided), count {count} vs the fp32 path's {ref_count}")
    return count, ref_count


def synthetic_video(np, frames: int, seed: int):
    """uint8 (frames, 224, 224, 3): a bright square moving up and down
    (a slow periodic 'exercise') over a noisy background."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 60, (frames, SIZE, SIZE, 3), dtype=np.uint8)
    for t in range(frames):
        y = int(80 + 60 * math.sin(2 * math.pi * t / 48))
        video[t, y:y + 48, 88:136] = (220, 200, 180)
    return video


# ---------------------------------------------------------------- phase 9
# The sweep's corpus: 6 test-split videos at 320×240, each a known number
# of reps of dark/bright half-states (≈ 300 frames), drawn as the JAX
# package's data/synthetic.py:repcount_video_frames draws them.
SWEEP_REPS = (7, 8, 6, 8, 7, 7)
SWEEP_H, SWEEP_W = 240, 320
SWEEP_ACTIONS = ("situp", "push_up", "pull_up", "jump_jack", "squat",
                 "front_raise")
ACTION_TINT = {
    "situp": (1.0, 0.9, 0.8), "push_up": (0.8, 1.0, 0.9),
    "pull_up": (0.9, 0.8, 1.0), "jump_jack": (1.0, 1.0, 0.8),
    "squat": (0.8, 1.0, 1.0), "front_raise": (1.0, 0.8, 1.0),
}
TSM_YAML = "workoutdetector_tpu/configs/repcount_12_tsm.yaml"
TS_YAML = "workoutdetector_tpu/configs/timesformer.yaml"


def sweep_frames(np, rng, action: str, n_reps: int):
    """One synthetic exercise video (T, 240, 320, 3) uint8 and its reps
    [s1, e1, s2, e2, ...]: a dark lead-in, n_reps of (dark 'start',
    bright 'end') half-states of 12-26 frames each, a dark lead-out,
    tinted per action, with N(0, 6) pixel noise."""
    tint = np.asarray(ACTION_TINT[action], np.float32)
    segs, reps, t = [], [], 0

    def emit(n: int, level: float):
        nonlocal t
        base = np.full((n, SWEEP_H, SWEEP_W, 3), level, np.float32) * tint
        noise = rng.normal(0, 6, size=base.shape).astype(np.float32)
        segs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
        t += n

    emit(int(rng.integers(4, 16)), 40.0)
    for _ in range(n_reps):
        start = t
        emit(int(rng.integers(12, 27)), 40.0)
        emit(int(rng.integers(12, 27)), 220.0)
        reps.extend([start, t - 1])
    emit(int(rng.integers(4, 16)), 40.0)
    return np.concatenate(segs), reps


def write_y4m(np, path: str, frames, fps: int = 30) -> None:
    """(T, H, W, 3) RGB uint8 → a YUV4MPEG2 file (4:4:4, BT.601 limited
    range), which libavformat demuxes without a codec."""
    f = frames.astype(np.float32) / 255.0
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    planes = np.stack([16 + 65.481 * r + 128.553 * g + 24.966 * b,
                       128 - 37.797 * r - 74.203 * g + 112.0 * b,
                       128 + 112.0 * r - 93.786 * g - 18.214 * b], axis=1)
    planes = np.clip(np.round(planes), 0, 255).astype(np.uint8)
    h, w = frames.shape[1:3]
    with open(path, "wb") as out:
        out.write(f"YUV4MPEG2 W{w} H{h} F{fps}:1 Ip A1:1 C444\n".encode())
        for p in planes:
            out.write(b"FRAME\n")
            out.write(p.tobytes())


def write_sweep_corpus(np, root: Path):
    """A RepCount-shaped corpus under ``root``: ``annotation.csv`` in the
    reference's schema and the 6 test videos, as mp4 through the port's
    ``write_video`` where cv2 imports, else as y4m. Returns ({path: frames},
    the container's name)."""
    import csv
    try:
        import cv2  # noqa: F401
    except ImportError:
        ext = ".y4m"
    else:
        ext = ".mp4"
    from workoutdetector_tpu_torch.data.video import write_video

    rng = np.random.default_rng(0)
    (root / "videos" / "test").mkdir(parents=True)
    rows = [["", "class_", "split", "name", "vid", "start", "end", "count",
             "reps"]]
    frames_by_path = {}
    for k, n_reps in enumerate(SWEEP_REPS):
        action = SWEEP_ACTIONS[k % len(SWEEP_ACTIONS)]
        frames, reps = sweep_frames(np, rng, action, n_reps)
        name = f"test{k}{ext}"
        path = str(root / "videos" / "test" / name)
        if ext == ".mp4":
            write_video(path, frames, 30.0)
        else:
            write_y4m(np, path, frames)
        frames_by_path[path] = frames
        rows.append([str(k), action, "test", name, f"syn{k:08d}", "0",
                     str(len(frames)), f"{float(n_reps)}",
                     " ".join(map(str, reps))])
    with open(root / "annotation.csv", "w", newline="") as f:
        csv.writer(f).writerows(rows)
    return frames_by_path, ext


def frames_reader(torch, frames_by_path):
    """A stand-in for the port's VideoReader over the frames the phase
    generated, for a machine where neither decoder backend loads: the
    same resize (short side → scale, bilinear with antialiasing) and
    center crop; a path that is not one of the corpus's raises as a
    failed decode does."""
    import os
    import torch.nn.functional as F

    class FramesReader:
        def __init__(self, path, prefer_native=True):
            if not os.path.exists(path):
                raise FileNotFoundError(path)
            if path not in frames_by_path:
                raise IOError(f"Failed to open {path}")
            self.frames = frames_by_path[path]

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def read_prepped(self, scale=256, crop=224, max_frames=None):
            x = torch.from_numpy(self.frames[:max_frames]).permute(0, 3, 1, 2)
            h, w = x.shape[2:]
            scale = max(scale, crop)
            size = (scale, max(1, round(w * scale / h))) if h <= w else \
                (max(1, round(h * scale / w)), scale)
            x = F.interpolate(x.float(), size=size, mode="bilinear",
                              antialias=True, align_corners=False)
            y0, x0 = (size[0] - crop) // 2, (size[1] - crop) // 2
            x = x[:, :, y0:y0 + crop, x0:x0 + crop].round().clamp(0, 255)
            return x.to(torch.uint8).permute(0, 2, 3, 1).contiguous().numpy()

        def iter_prepped(self, scale=256, crop=224, chunk=1024):
            video = self.read_prepped(scale, crop)
            for i in range(0, len(video), chunk):
                yield video[i:i + chunk]

    return FramesReader


def read_scores(np, directory: Path):
    """{video name: (total_frames, (N, num_class) logits)} of a sweep."""
    out = {}
    for p in sorted(directory.glob("*.score.json")):
        with open(p) as f:
            d = json.load(f)
        out[d["video_name"]] = (d["total_frames"], np.array(
            [list(row.values()) for row in d["scores"].values()], np.float64))
    return out


def same_files(a: Path, b: Path) -> bool:
    names = sorted(p.name for p in a.glob("*.score.json"))
    return names == sorted(p.name for p in b.glob("*.score.json")) and all(
        (a / n).read_bytes() == (b / n).read_bytes() for n in names)


def brightness_head(np, torch, model, ref_model, frames):
    """Set the TSM head so that its state follows the frame brightness: of
    a decoded corpus video ``frames``, a dark window (its 8 darkest frames)
    and a bright one (its 8 brightest) go through the fp32 plain path; the
    two classes whose logits differ most between them go to rows 0 and 1,
    their biases tie halfway between the two windows (mid-grey in logit
    space), and the other rows get weight 0 and bias −1e3. Applied to both
    models; returns the two classes."""
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    order = np.argsort(frames.reshape(len(frames), -1).mean(1))
    windows = np.stack([frames[np.sort(order[:FRAMES])],
                        frames[np.sort(order[-FRAMES:])]])
    x = torch.from_numpy(windows).to("cuda")
    with torch.no_grad():
        dark, bright = ref_model.to("cuda").eval()(normalize_clip(x)) \
            .double().cpu().numpy()
    diff = bright - dark
    a, b = int(np.argmin(diff)), int(np.argmax(diff))
    tie = ((dark[a] - dark[b]) + (bright[a] - bright[b])) / 2
    for m in (model, ref_model):
        w, bias = m.fc.weight.data, m.fc.bias.data
        rows, biases = w[[a, b]].clone(), bias[[a, b]].clone()
        biases[0] -= float(tie)
        w.zero_()
        bias.fill_(-1e3)
        w[:2], bias[:2] = rows, biases
    return a, b


def sweep_phase(np, torch, kernels, repo: Path, card: str) -> dict:
    """Phase 9: the decode → score → count sweep of a RepCount-shaped
    corpus through the port's entry points (``engine_from_checkpoint``,
    ``inference_dataset``, ``eval_dataset``, ``eval_count_shards``, the
    CLI), TSM-R50 from ``repcount_12_tsm.yaml`` at full width. Returns the
    phase's numbers."""
    import contextlib
    import csv
    import io
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_video_model,
                                                 engine_from_checkpoint,
                                                 eval_count_shards,
                                                 eval_dataset,
                                                 inference_dataset)
    from workoutdetector_tpu_torch.infer import engine as engine_mod
    from workoutdetector_tpu_torch.infer import inference_count as ic_mod
    from workoutdetector_tpu_torch.models import build_model
    from workoutdetector_tpu_torch.models.convert import (load_flax_variables,
                                                          random_flax_variables)
    from workoutdetector_tpu_torch.scripts.compare_scores import compare_dirs
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager

    tmp = Path(tempfile.mkdtemp(prefix=".smoke-sweep-", dir=repo))
    readers = (ic_mod.VideoReader, engine_mod.VideoReader)
    try:
        root = tmp / "RepCount"
        frames_by_path, ext = write_sweep_corpus(np, root)
        first = next(iter(frames_by_path))
        lengths = [len(v) for v in frames_by_path.values()]
        log(f"    corpus: {len(lengths)} test videos, {SWEEP_W}x{SWEEP_H}, "
            f"{lengths} frames, reps {list(SWEEP_REPS)}, written as {ext} "
            f"({'cv2 write_video' if ext == '.mp4' else 'YUV4MPEG2 from numpy'})")
        try:
            with readers[0](first) as r:
                r.read_prepped(256, SIZE, max_frames=1)
            log(f"    decoder: the port's VideoReader ({ext})")
        except RuntimeError as exc:  # no backend: the reader names both
            log(f"    decoder: NONE LOADS ({exc}); the phase replaces the "
                "port's VideoReader in infer.inference_count and "
                "infer.engine by a reader of the frames it generated")
            ic_mod.VideoReader = engine_mod.VideoReader = frames_reader(
                torch, frames_by_path)
        reader = ic_mod.VideoReader

        cfg = load_config(str(repo / TSM_YAML))
        model = build_model(cfg.model)
        variables = random_flax_variables(model, seed=0)
        load_flax_variables(model, variables)
        ref_cfg = load_config(str(repo / TSM_YAML), ["model.dtype=float32"])
        ref_model = build_model(ref_cfg.model, use_kernels=False)
        load_flax_variables(ref_model, variables)
        with reader(first) as r:
            a, b = brightness_head(np, torch, model, ref_model,
                                   r.read_prepped(256, SIZE))
        ckpt = CheckpointManager(str(tmp / "ckpt")).save(
            {"model": model.state_dict()}, name="tsm_r50")
        log(f"    head: classes {a} (dark) and {b} (bright) -> rows 0, 1, "
            f"tied halfway between a dark and a bright window of "
            f"{Path(first).name}; the other rows -1e3; checkpoint "
            f"{Path(ckpt).name}")
        engine = engine_from_checkpoint(cfg, ckpt,
                                        image_size=cfg.data.image_size)
        ref_engine = InferenceEngine(ref_model, cfg.model.num_segments,
                                     engine.window_batch,
                                     image_size=cfg.data.image_size,
                                     device="cuda")
        del model
        warm = np.zeros((24, SIZE, SIZE, 3), np.uint8)
        engine.score_video(warm)
        ref_engine.score_video(warm)
        torch.cuda.synchronize()

        def sweep(eng, name, **kw):
            out = tmp / name
            summary = inference_dataset(eng, ["test"], str(out), ckpt,
                                        data_root=str(root), **kw)
            torch.cuda.synchronize()
            return out, summary

        kernels.reset_launches()
        t0 = time.perf_counter()
        staged_dir, summary = sweep(engine, "staged", decode_workers=2)
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        scores = read_scores(np, staged_dir)
        names = sorted(Path(p).name for p in frames_by_path)
        if sorted(summary["scored"]) != names or summary["failed"]:
            raise AssertionError(f"sweep summary {summary}")
        windows = sum(len(l) for _, l in scores.values())
        forwards = sum(math.ceil(len(l) / engine.window_batch)
                       for _, l in scores.values())
        log(f"    inference_dataset (2 decode workers, staged): "
            f"{len(scores)} videos, {windows} windows, {forwards} forwards "
            f"in {wall:.4f} s = {windows / wall:.2f} windows/s on {card}; "
            f"launches={launches}")
        want = {name: 0 for name in launches}
        want.update(shift_matmul=10 * forwards, fused_bottleneck=6 * forwards)
        if launches != want:
            raise AssertionError(f"sweep launch counts {launches} != {want}")

        # every score JSON against the JAX package's schema
        with open(root / "annotation.csv") as f:
            gt = {r[3]: [int(x) for x in r[8].split()]
                  for r in list(csv.reader(f))[1:]}
        for p in sorted(staged_dir.glob("*.score.json")):
            with open(p) as f:
                d = json.load(f)
            keys = ["video_name", "model", "input_shape", "checkpoint",
                    "total_frames", "ground_truth", "action", "scores"]
            n = lengths[names.index(d["video_name"])]
            if list(d) != keys or d["model"] != "video_model" or \
                    d["input_shape"] != [1, FRAMES, 3, SIZE, SIZE] or \
                    d["checkpoint"] != ckpt or d["total_frames"] != n or \
                    d["ground_truth"] != gt[d["video_name"]] or \
                    list(d["scores"]) != [str(s) for s in range(0, n, 8)] or \
                    any(list(row) != [str(c) for c in range(NUM_CLASS)]
                        for row in d["scores"].values()):
                raise AssertionError(f"{p.name}: not the JAX score-JSON schema")
        log(f"    score JSONs: the JAX schema (keys {keys}; windows every 8 "
            "frames; 12 classes)")

        # timing: the same videos decoded serially, then score_video alone
        t0 = time.perf_counter()
        decoded = []
        for p in frames_by_path:
            with reader(p) as r:
                decoded.append(r.read_prepped(256, SIZE))
        decode_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n_windows = sum(len(engine.score_video(v, step=8, stride=2)[0])
                        for v in decoded)
        torch.cuda.synchronize()
        score_s = time.perf_counter() - t0
        del decoded
        log(f"    windows/s: sweep {windows / wall:.2f} (wall {wall:.4f} s); "
            f"decode share {decode_s / wall:.4f} (serial decode of the same "
            f"videos {decode_s:.4f} s over the sweep's wall); score_video "
            f"alone {n_windows / score_s:.2f} ({score_s:.4f} s) on {card}")

        # the staged copies against synchronous copies, one decode worker
        stage = engine.stage_video
        engine.stage_video = lambda v: stage(v, pin_memory=False)
        sync_dir, _ = sweep(engine, "unstaged", decode_workers=1)
        del engine.stage_video
        if not same_files(staged_dir, sync_dir):
            raise AssertionError("the staged sweep's JSONs differ from the "
                                 "unstaged one-worker sweep's")
        log("    staged (2 workers, pinned copies on the copy stream) vs "
            "unstaged (1 worker, synchronous pageable copies): identical "
            "JSONs")

        # the fp32 plain path on the card, by phase 4's logit rule
        ref_dir, _ = sweep(ref_engine, "plain")
        ref_scores = read_scores(np, ref_dir)
        got = np.concatenate([scores[k][1] for k in sorted(scores)])
        ref = np.concatenate([ref_scores[k][1] for k in sorted(scores)])
        cmp = compare_dirs(str(staged_dir), str(ref_dir))
        log(f"    compare_dirs(kernel path, fp32 plain path): {cmp}")
        if not (got.argmax(1) < 2).all() or not (ref.argmax(1) < 2).all():
            raise AssertionError("a class other than rows 0, 1 won a window")
        logit_rule(np, got[:, :2], ref[:, :2], "sweep (rows 0, 1)")

        # chunked decode + scoring against the whole-video sweep
        chunk_dir, _ = sweep(engine, "chunked", chunk_frames=64)
        chunked = read_scores(np, chunk_dir)
        ch = np.concatenate([chunked[k][1] for k in sorted(scores)])
        bitwise = same_files(staged_dir, chunk_dir)
        log(f"    chunk_frames=64 vs whole videos: "
            f"{'bit-identical JSONs' if bitwise else 'max |diff| %g' % float(np.abs(ch - got).max())}, "
            f"argmax identical on {int((ch.argmax(1) == got.argmax(1)).sum())}"
            f"/{len(got)} windows")
        if not (ch.argmax(1) == got.argmax(1)).all():
            raise AssertionError("chunked scoring changed an argmax")
        logit_rule(np, ch[:, :2], ref[:, :2], "chunked sweep (rows 0, 1)")

        # counts and MAE/OBO: one shard, two shards merged, the plain path
        counts = {}
        mae, obo = eval_dataset(engine, ["all"], "test", str(root),
                                counts_out=str(tmp / "counts_full.json"))
        files = [str(tmp / f"counts_{i}of2.json") for i in range(2)]
        for i in range(2):
            eval_dataset(engine, ["all"], "test", str(root), shard=(i, 2),
                         counts_out=files[i])
        mae_m, obo_m, merged = eval_count_shards(files, str(root),
                                                 action=["all"],
                                                 split=["test"])
        eval_dataset(ref_engine, ["all"], "test", str(root),
                     counts_out=str(tmp / "counts_plain.json"))
        for tag in ("full", "plain"):
            with open(tmp / f"counts_{tag}.json") as f:
                counts[tag] = json.load(f)
        log(f"    eval_dataset: counts {counts['full']} (ground truth "
            f"{list(SWEEP_REPS)}), MAE {mae:.6f} OBO {obo:.6f}; two shards "
            f"merged: MAE {mae_m:.6f} OBO {obo_m:.6f}; fp32 plain path "
            f"counts {counts['plain']}")
        if not (math.isclose(mae, mae_m, rel_tol=1e-12, abs_tol=1e-12) and
                math.isclose(obo, obo_m, rel_tol=1e-12, abs_tol=1e-12)):
            raise AssertionError("merged shards' MAE/OBO differ from one shard's")
        if counts["full"] != counts["plain"] or \
                {k: v.pred_count for k, v in merged.items()} != counts["full"]:
            raise AssertionError("counts differ between the kernel path, the "
                                 "merged shards and the fp32 plain path")
        if not any(counts["full"].values()):
            raise AssertionError("every count is 0")

        # the CLI: --score and --merge-shards
        base = ["--cfg", str(repo / TSM_YAML), "-ckpt", ckpt,
                "--data-root", str(root), "--split", "test"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            ic_mod.main(["--score", str(tmp / "cli")] + base)
            ic_mod.main(["--merge-shards"] + files + base)
        printed = [json.loads(line) for line in out.getvalue().splitlines()]
        log(f"    CLI --score: {printed[0]}; --merge-shards: {printed[1]}")
        if printed[0] != {"scored": len(names), "skipped": 0, "failed": [],
                          "shard": [0, 1]} or \
                printed[1] != {"mae": mae_m, "obo_acc": obo_m,
                               "n_pred": len(names)} or \
                not same_files(staged_dir, tmp / "cli"):
            raise AssertionError("the CLI's output differs from the sweep's")

        # a planted fault: one video renamed, so that it fails to decode
        bad = names[2]
        bad_path = root / "videos" / "test" / bad
        bad_path.rename(bad_path.with_name(bad + ".moved"))
        summary = inference_dataset(engine, ["test"], str(tmp / "fault"), ckpt,
                                    data_root=str(root), on_error="skip")
        with open(tmp / "fault" / "failures" / "shard_0of1.json") as f:
            manifest = json.load(f)
        log(f"    planted fault ({bad} renamed): scored "
            f"{len(summary['scored'])}, manifest {manifest}")
        if sorted(summary["scored"]) != [n for n in names if n != bad] or \
                list(manifest) != [bad] or manifest[bad]["stage"] != "decode":
            raise AssertionError("the planted bad video was not caught")
        with open(root / "annotation.csv") as f:
            rows = list(csv.reader(f))
        with open(tmp / "bad_only.csv", "w", newline="") as f:
            csv.writer(f).writerows(
                [rows[0]] + [r for r in rows[1:] if r[3] == bad])
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            try:
                ic_mod.main(["--score", str(tmp / "fault_cli"), "--anno",
                             str(tmp / "bad_only.csv")] + base)
            except SystemExit as exc:
                code = exc.code
            else:
                code = 0
        log(f"    CLI --score on a shard whose one video fails: exit {code}")
        if not code:
            raise AssertionError("the CLI exited 0 though it scored nothing")

        # the second family through the loader: TimeSformer-B/16
        del engine, ref_engine, ref_model
        torch.cuda.empty_cache()
        ts_cfg = load_config(str(repo / TS_YAML))
        ts_engine = engine_from_checkpoint(ts_cfg, None,
                                           image_size=ts_cfg.data.image_size)
        ts_engine.score_video(warm)
        torch.cuda.synchronize()
        kernels.reset_launches()
        ts_count, _ = count_by_video_model(ts_engine, first)
        torch.cuda.synchronize()
        ts_launches = kernels.launch_counts()
        ts_forwards = math.ceil((lengths[0] // 8) / ts_engine.window_batch)
        log(f"    TimeSformer-B/16 (engine_from_checkpoint({TS_YAML}), "
            f"initializers from seed 0): count {ts_count} on {Path(first).name}, "
            f"{ts_forwards} forwards, launches={ts_launches}")
        want = {name: 0 for name in ts_launches}
        want["attention"] = TS_LAYERS * ts_forwards
        if ts_launches != want:
            raise AssertionError(f"TimeSformer launch counts {ts_launches} "
                                 f"!= {want}")
        del ts_engine
        return {"windows": windows, "forwards": forwards,
                "launches": {"shift_matmul": launches["shift_matmul"],
                             "fused_bottleneck": launches["fused_bottleneck"]},
                "windows_per_s": windows / wall, "wall_s": wall,
                "decode_share": decode_s / wall,
                "score_video_windows_per_s": n_windows / score_s}
    finally:
        ic_mod.VideoReader, engine_mod.VideoReader = readers
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 10
# Training on rawframe files: a RepCount-shaped corpus of JPEG frame
# folders at 320×240, 6 train and 2 val videos per action, 2 reps each
# (the lists' default max_reps), every rep's halves 8-12 frames. Each
# action draws its own figure (colour and width); the figure stands high
# in a rep's first half and low in its second, so the 12 classes of
# all-{split}.txt differ in what they show.
FILE_W, FILE_H = 320, 240
FILE_TRAIN_VIDEOS, FILE_VAL_VIDEOS = 6, 2  # per action
FILE_REPS = 2
# 4 steps an epoch at batch 32: 60 steps for the fit whose validation
# accuracy is reported, 12 for the device_augment fit
FILE_EPOCHS, AUGMENT_EPOCHS = 15, 3
FILE_FIGURE = {  # action → (BGR colour, figure width)
    "situp": ((40, 40, 230), 60), "push_up": ((40, 200, 40), 80),
    "pull_up": ((230, 60, 40), 100), "jump_jack": ((40, 220, 230), 70),
    "squat": ((220, 40, 220), 90), "front_raise": ((230, 230, 230), 110),
}
AUGMENT_TOL = 1e-3  # card vs CPU crop_flip, absolute on [0, 255]


def file_video(np, rng, action: str, noise):
    """One video's BGR frames (T, 240, 320, 3) uint8 and its reps
    [s1, e1, s2, e2]: a lead-in and lead-out with the figure low, and per
    rep n frames high then n low (n 8-12), over a per-video background
    and horizontal position, with noise from ``noise`` (int16 frames)."""
    colour, width = FILE_FIGURE[action]
    x0 = int(rng.integers(8, FILE_W - width - 8))
    bg = rng.integers(40, 110, size=3)
    high, low = (np.empty((FILE_H, FILE_W, 3), np.int16) for _ in range(2))
    for img, top in ((high, 20), (low, 130)):
        img[:] = bg
        img[top:top + 90, x0:x0 + width] = colour
    states, reps = [low] * int(rng.integers(2, 6)), []
    for _ in range(FILE_REPS):
        n = int(rng.integers(8, 13))
        reps.extend([len(states), len(states) + 2 * n - 1])
        states += [high] * n + [low] * n
    states += [low] * int(rng.integers(2, 6))
    frames = [np.clip(s + noise[t % len(noise)], 0, 255).astype(np.uint8)
              for t, s in enumerate(states)]
    return frames, reps


def write_file_corpus(np, root: Path):
    """annotation.csv in RepcountHelper's schema, the frame folders
    (``rawframes/{split}/{name}/img_{:05}.jpg`` through cv2.imwrite, 8
    writer threads) and the lists, written by the port's
    build_video_label_list into ``Binary/``. Returns (videos, frames)."""
    import csv
    from concurrent.futures import ThreadPoolExecutor

    import cv2

    from workoutdetector_tpu_torch.data.repcount import (
        ACTIONS, build_video_label_list)

    rng = np.random.default_rng(0)
    noise = rng.integers(-12, 13, size=(5, FILE_H, FILE_W, 3)).astype(np.int16)
    rows = [["", "class_", "split", "name", "vid", "start", "end", "count",
             "reps"]]
    writes = []
    for split, per_action in (("train", FILE_TRAIN_VIDEOS),
                              ("val", FILE_VAL_VIDEOS)):
        for action in ACTIONS:
            for _ in range(per_action):
                k = len(rows) - 1
                frames, reps = file_video(np, rng, action, noise)
                name = f"{split}{k:03d}"
                d = root / "rawframes" / split / name
                d.mkdir(parents=True)
                writes += [(str(d / f"img_{t + 1:05}.jpg"), f)
                           for t, f in enumerate(frames)]
                rows.append([str(k), action, split, f"{name}.mp4",
                             f"syn{k:08d}", "0", str(len(frames)),
                             f"{float(FILE_REPS)}", " ".join(map(str, reps))])
    with ThreadPoolExecutor(8) as pool:
        ok = list(pool.map(lambda pf: cv2.imwrite(*pf), writes))
    if not all(ok):
        raise AssertionError("cv2.imwrite failed on the file corpus")
    anno = root / "annotation.csv"
    with open(anno, "w", newline="") as f:
        csv.writer(f).writerows(rows)
    build_video_label_list(str(root), str(anno), list(ACTIONS),
                           str(root / "Binary"))
    return len(rows) - 1, len(writes)


def file_fit(np, torch, kernels, Trainer, cfg, variables, what: str):
    """Trainer.fit from ``variables`` with the launches of the fit checked
    (per step 33 dx, 33 dW, 16 shift-matmul; per validation forward 10
    shift-matmul, 6 fused-bottleneck) and finite losses. Returns (trainer,
    state, history, train steps, seconds)."""
    import csv
    trainer = Trainer(cfg, device="cuda")
    steps = len(trainer._loader("train", shuffle=True)) * cfg.trainer.max_epochs
    val_forwards = len(trainer._loader("val", shuffle=False))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    state, history = trainer.fit(variables=variables)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {name: 0 for name in launches}
    want.update(conv1x1_dx=33 * steps, conv1x1_dw=33 * steps,
                shift_matmul=16 * steps + 10 * val_forwards,
                fused_bottleneck=6 * val_forwards)
    runs = [p for p in Path(cfg.trainer.default_root_dir).iterdir()
            if p.is_dir()]
    with open(runs[0] / "csv" / "metrics.csv") as f:
        losses = [float(r["train/loss"]) for r in csv.DictReader(f)
                  if r.get("train/loss")]
    log(f"    fit ({what}): {state.step} steps + {val_forwards} val forwards "
        f"in {seconds:.2f} s, launches={launches}")
    shown = [round(v, 4) for v in losses]
    log(f"    train losses {shown[:4]} ... {shown[-4:]} (mean of the last "
        f"{min(4, steps)}: {sum(losses[-4:]) / len(losses[-4:]):.4f}); "
        f"val {history}")
    if launches != want:
        raise AssertionError(f"{what}: launch counts {launches} != {want}")
    if state.step != steps or len(losses) != steps or \
            not np.isfinite(losses).all() or \
            not math.isfinite(history["val/loss"]):
        raise AssertionError(f"{what}: a non-finite or missing loss")
    return trainer, state, history, steps, seconds


def files_phase(np, torch, kernels, repo: Path, card: str,
                debug_clips_s: float) -> dict:
    """Phase 10: repcount_12_tsm.yaml trained on rawframe files through
    the port's FrameDataset, with and without data.device_augment.
    Returns the phase's numbers."""
    import ctypes
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data import datasets
    from workoutdetector_tpu_torch.models.convert import init_flax_variables
    from workoutdetector_tpu_torch.ops.augment import crop_flip
    from workoutdetector_tpu_torch.train.trainer import Trainer

    lib = repo / "native" / "libwdjpeg.so"
    try:
        ctypes.CDLL(str(lib))
        log(f"    JPEG probe: ctypes.CDLL({lib.relative_to(repo)}): loaded")
    except OSError as exc:
        log(f"    JPEG probe: ctypes.CDLL({lib.relative_to(repo)}): OSError: "
            f"{exc}")
    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-files-", dir=repo))
    try:
        t0 = time.perf_counter()
        videos, jpegs = write_file_corpus(np, tmp)
        binary = tmp / "Binary"
        lines = {s: len((binary / f"all-{s}.txt").read_text().splitlines())
                 for s in ("train", "val")}
        log(f"    corpus: {videos} videos ({FILE_TRAIN_VIDEOS} train, "
            f"{FILE_VAL_VIDEOS} val per action), {jpegs} JPEGs at "
            f"{FILE_W}x{FILE_H} in {time.perf_counter() - t0:.2f} s; "
            f"all-train.txt {lines['train']} clips, all-val.txt "
            f"{lines['val']} clips (build_video_label_list)")

        def config(epochs: int, *extra):
            return load_config(str(repo / TSM_YAML), [
                f"data.data_root={tmp}",
                f"data.train.anno={binary / 'all-train.txt'}",
                f"data.val.anno={binary / 'all-val.txt'}",
                f"data.test.anno={binary / 'all-val.txt'}",
                f"trainer.max_epochs={epochs}",
                f"trainer.check_val_every_n_epoch={epochs}",
                "trainer.log_every_n_steps=1",
                f"trainer.default_root_dir={tmp / f'runs{epochs}'}",
                f"callbacks.modelcheckpoint.dirpath={tmp / 'ckpt'}",
                "log.tensorboard_enable=false", *extra])

        cfg = config(FILE_EPOCHS)
        trainer = Trainer(cfg, device="cuda")
        loader = trainer._loader("train", shuffle=True)
        path = {s: datasets.decoder_path(trainer._loader(s, False).dataset
                                         .transform) for s in ("train", "val")}
        log(f"    FrameDataset decoder: train {path['train']}, val "
            f"{path['val']}")
        clips, t0 = 0, time.perf_counter()
        for epoch in range(2):
            loader.set_epoch(epoch)
            for bx, by in loader:
                clips += len(by)
        load_s = time.perf_counter() - t0
        loader_clips_s = clips / load_s
        log(f"    loader alone (DataLoader(FrameDataset), "
            f"{cfg.data.num_workers} workers, batch {cfg.data.batch_size}, "
            f"{path['train']}, TrainTransform): {clips} clips in "
            f"{load_s:.3f} s = {loader_clips_s:.2f} clips/s = "
            f"{loader_clips_s * FRAMES:.1f} JPEGs/s")

        variables = init_flax_variables(trainer.model, cfg.seed)
        state = trainer.init_state(1, variables)
        before = trainer.evaluate(state, trainer._loader("val", shuffle=False))
        del trainer, state
        torch.cuda.empty_cache()
        trainer, state, history, steps, fit_s = file_fit(
            np, torch, kernels, Trainer, cfg, variables, "host transforms")
        if not (tmp / "ckpt" / "last").exists():
            raise AssertionError("fit wrote no 'last' checkpoint")
        after = history["val/acc"]
        log(f"    val accuracy before {before['acc']:.4f} (n {before['n']}), "
            f"after {steps} steps {after:.4f}: "
            f"{'rose' if after > before['acc'] else 'did not rise'} "
            f"(chance {1 / NUM_CLASS:.4f})")

        # train clips/s fed from the files, the loader included
        n, t0 = 0, time.perf_counter()
        for epoch in range(FILE_EPOCHS, FILE_EPOCHS + 2):
            loader.set_epoch(epoch)
            for bx, by in loader:
                trainer.train_step(state, bx, by)
                n += 1
        torch.cuda.synchronize()
        files_s = time.perf_counter() - t0
        files_clips_s = n * cfg.data.batch_size / files_s
        log(f"    train from files: {n} steps in {files_s:.3f} s = "
            f"{files_clips_s:.2f} clips/s at batch {cfg.data.batch_size} on "
            f"{card} (phase 6, one DebugDataset batch in memory: "
            f"{debug_clips_s:.2f})")
        def epochs(first: int):  # the loader's batches, epoch after epoch
            while True:
                loader.set_epoch(first)
                first += 1
                yield from loader

        batches = epochs(FILE_EPOCHS + 2)

        def three_steps():  # the profiled call spans an epoch's start
            for _ in range(3):
                trainer.train_step(state, *next(batches))

        idle = profile_call(torch, three_steps, top=8)
        batches.close()
        del trainer, state, loader
        torch.cuda.empty_cache()

        aug_cfg = config(AUGMENT_EPOCHS, "data.device_augment=true",
                         "trainer.enable_checkpointing=false")
        trainer, state, aug_history, _, aug_s = file_fit(
            np, torch, kernels, Trainer, aug_cfg, variables, "device_augment")
        batches = iter(trainer._loader("train", shuffle=True))
        x_u8, _ = next(batches)
        batches.close()
        params = trainer.augment_params(0, len(x_u8), x_u8.shape[2])
        x = torch.from_numpy(x_u8)
        got = crop_flip(x.cuda(), params, cfg.data.image_size).cpu()
        torch.cuda.synchronize()
        want = crop_flip(x, params, cfg.data.image_size)
        aug_err = float((got - want).abs().max())
        log(f"    device_augment: canvases {tuple(x_u8.shape)} -> "
            f"{tuple(got.shape)}; crop_flip on the card vs the CPU copy: "
            f"max |diff| {aug_err:.6f} (limit {AUGMENT_TOL}), "
            f"{int(params[:, 4].sum())}/{len(params)} flipped")
        if not aug_err <= AUGMENT_TOL:
            raise AssertionError(f"device_augment on the card differs from "
                                 f"the CPU by {aug_err}")
        del trainer, state
        log(f"    phase [10]: {time.perf_counter() - phase_t0:.1f} s")
        return {"videos": videos, "jpegs": jpegs, "decoder": path["train"],
                "loader_clips_per_s": loader_clips_s,
                "loader_jpegs_per_s": loader_clips_s * FRAMES,
                "train_clips_per_s": files_clips_s, "idle_share": idle,
                "val_acc_before": before["acc"], "val_acc_after": after,
                "val_acc_after_device_augment": aug_history["val/acc"],
                "fit_s": fit_s, "device_augment_fit_s": aug_s,
                "augment_max_abs_err": aug_err}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


def main() -> int:
    start = time.perf_counter()
    repo = Path(__file__).resolve().parent
    if not (repo / "workoutdetector_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the workoutdetector_tpu_torch package is not next "
              "to this script", file=sys.stderr)
        return 2
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_video_model)
    from workoutdetector_tpu_torch.models import TSM, load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.ops import kernels
    from workoutdetector_tpu_torch.ops.kernels import _build

    # fp32 comparisons below are full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log(f"[1] card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = _build.load()
    log(f"[2] kernels built in {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> {lib.path.name}")
    for line in ptxas_summary(lib.ptxas_log):
        log("    " + line)

    log("[3] kernels vs plain versions (bf16, TSM-R50 224 main-path shapes)")
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = kernel_phase(torch, kernels, g)

    log("[4] main path: TSM-R50 224, 8 segments, 12 classes, bf16, "
        f"window_batch {WINDOW_BATCH}")
    model = TSM(NUM_CLASS, FRAMES, "resnet50", dtype=torch.bfloat16)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    engine = InferenceEngine(model, FRAMES, WINDOW_BATCH, device="cuda")
    video = synthetic_video(np, 299, seed=1)
    engine.score_video(video[:24], step=8, stride=2)  # warm-up (cuDNN plans)
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    starts, logits = engine.score_video(video, step=8, stride=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    count, reps = count_by_video_model(engine, video)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    forwards = math.ceil(len(starts) / WINDOW_BATCH) + \
        math.ceil((len(video) // 8) / WINDOW_BATCH)
    log(f"    windows={len(starts)} forwards={forwards} launches={launches}")
    want = {name: 0 for name in launches}
    want.update(shift_matmul=10 * forwards, fused_bottleneck=6 * forwards)
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if logits.shape != (len(starts), NUM_CLASS) or not np.isfinite(logits).all():
        raise AssertionError(f"bad logits: shape {logits.shape}")
    clips_per_s = len(starts) / seconds
    log(f"    score_video: {len(starts)} windows in {seconds:.4f} s = "
        f"{clips_per_s:.2f} clips/s on {card}")
    log(f"    count_by_video_model: count={count} reps={reps}")
    batch = engine.gather_windows(video, starts[:WINDOW_BATCH], stride=2)
    profile_call(torch, lambda: engine.score_windows(batch))

    ref_model = TSM(NUM_CLASS, FRAMES, "resnet50", dtype=torch.float32,
                    use_kernels=False)
    load_flax_variables(ref_model, variables)
    ref_engine = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH,
                                 device="cuda")
    _, ref = ref_engine.score_video(video, step=8, stride=2)
    logit_rule(np, logits, ref, "main path")
    count_check(np, torch, engine, ref_engine, video, "main path")

    log(f"[5] shift_place='block' TSM-R50, {BLOCK_BATCH} clips")
    block = TSM(NUM_CLASS, FRAMES, "resnet50", shift_place="block",
                dtype=torch.bfloat16)
    load_flax_variables(block, variables)
    block_engine = InferenceEngine(block, FRAMES, BLOCK_BATCH, device="cuda")
    clips = engine.gather_windows(video, np.arange(0, 4 * 64, 64), stride=2)
    block_engine.score_windows(clips)  # warm-up
    kernels.reset_launches()
    blk = block_engine.score_windows(clips)
    torch.cuda.synchronize()
    blk_launches = kernels.launch_counts()
    log(f"    launches={blk_launches}")
    if blk_launches != dict({name: 0 for name in blk_launches},
                            temporal_shift=16, fused_bottleneck=6):
        raise AssertionError(f"block path launch counts {blk_launches}")
    block_ref = TSM(NUM_CLASS, FRAMES, "resnet50", shift_place="block",
                    dtype=torch.float32, use_kernels=False)
    load_flax_variables(block_ref, variables)
    blk_ref = InferenceEngine(block_ref, FRAMES, BLOCK_BATCH,
                              device="cuda").score_windows(clips)
    blk_err = float(np.abs(blk - blk_ref).max())
    log(f"    vs plain fp32 path: max |logit diff| {blk_err:.5f}")
    if not np.isfinite(blk).all() or \
            blk_err > 0.05 * (1 + float(np.abs(blk_ref).max())):
        raise AssertionError("block path disagrees with the fp32 plain path")

    del block, block_ref, block_engine, ref_model, ref_engine, model, engine
    torch.cuda.empty_cache()
    log(f"[6] training: TSM-R50 224, {FRAMES} segments, {NUM_CLASS} classes, "
        f"bf16, batch {TRAIN_BATCH}, {TRAIN_STEPS} steps")
    train_launches, train_shift_matmul, clips_s = train_phase(
        np, torch, kernels, variables, repo, card)

    torch.cuda.empty_cache()
    log(f"[7] TimeSformer-B/16 224, {FRAMES} segments, {NUM_CLASS} classes, "
        f"bf16, window_batch {WINDOW_BATCH}")
    attention_launches, ts_clips_s = timesformer_phase(np, torch, kernels,
                                                       video, card)

    torch.cuda.empty_cache()
    log(f"[8] TimeSformer-B/16 training: 224, {FRAMES} segments, {NUM_CLASS} "
        f"classes, bf16, batch {TS_TRAIN_BATCH}, {TRAIN_STEPS} steps")
    ts_train_launches, ts_train_clips_s = timesformer_train_phase(
        np, torch, kernels, repo, card)
    torch.cuda.empty_cache()
    tiled_launches = tiled_route_phase(np, torch, kernels, repo)

    torch.cuda.empty_cache()
    log(f"[9] the sweep: decode -> inference_dataset -> counts and MAE/OBO, "
        f"TSM-R50 {SIZE} ({TSM_YAML}), bf16, window_batch {WINDOW_BATCH}")
    sweep = sweep_phase(np, torch, kernels, repo, card)

    torch.cuda.empty_cache()
    log(f"[10] training on rawframe files: {TSM_YAML} (TSM-R50 {SIZE}, "
        f"bf16, batch {TRAIN_BATCH}) through FrameDataset, then with "
        f"data.device_augment")
    files = files_phase(np, torch, kernels, repo, card, clips_s)

    replaces = {
        "temporal_shift": ("workoutdetector_tpu_torch/csrc/shift.cu",
                           "workoutdetector_tpu/ops/pallas/shift.py:36"),
        "shift_matmul": ("workoutdetector_tpu_torch/csrc/shift_matmul.cu",
                         "workoutdetector_tpu/ops/pallas/shift_matmul.py:49"),
        # the same kernel at the 16 shifted conv1 sites of a train step
        "shift_matmul_train": ("workoutdetector_tpu_torch/csrc/shift_matmul.cu",
                               "workoutdetector_tpu/ops/pallas/shift_matmul.py:49"),
        "fused_bottleneck": ("workoutdetector_tpu_torch/csrc/fused_block.cu",
                             "workoutdetector_tpu/ops/pallas/fused_block.py:192"),
        "conv1x1_dx": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                       "workoutdetector_tpu/ops/pallas/conv1x1.py:52"),
        "conv1x1_dw": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                       "workoutdetector_tpu/ops/pallas/conv1x1.py:92"),
        "attention": ("workoutdetector_tpu_torch/csrc/attention_fwd.cu",
                      "workoutdetector_tpu/models/timesformer.py:73"),
        # the forward's route for l > 256 (or dh other than 64)
        "attention_tiled": ("workoutdetector_tpu_torch/csrc/attention.cu",
                            "workoutdetector_tpu/models/timesformer.py:73"),
        # the library Pallas flash attention's backward kernels, which
        # _flash_mha (timesformer.py:73) reaches under jax.grad: both in one
        # launch, and as the tiled route for longer sequences
        "attention_bwd": ("workoutdetector_tpu_torch/csrc/attention_bwd_short.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:941,1287"),
        "attention_dkv": ("workoutdetector_tpu_torch/csrc/attention_bwd.cu",
                          "jax/experimental/pallas/ops/tpu/flash_attention.py:941"),
        "attention_dq": ("workoutdetector_tpu_torch/csrc/attention_bwd.cu",
                         "jax/experimental/pallas/ops/tpu/flash_attention.py:1287"),
    }
    # each kernel's launches on its main path: inference (phase 4) for the
    # forward kernels, the block path (5) for the shift, training (6) for
    # the 1x1 backward kernels and the train steps' shift-matmul forwards, TimeSformer inference (7) for the attention,
    # TimeSformer training (8) for its backward kernel, the 288² train step
    # (8, tiled route) for the tiled dK/dV and dQ kernels
    main_launches = dict(launches, temporal_shift=blk_launches["temporal_shift"],
                         shift_matmul_train=train_shift_matmul,
                         conv1x1_dx=train_launches["conv1x1_dx"],
                         conv1x1_dw=train_launches["conv1x1_dw"],
                         attention=attention_launches,
                         attention_tiled=tiled_launches["attention_tiled"],
                         attention_bwd=ts_train_launches["attention_bwd"],
                         attention_dkv=tiled_launches["attention_dkv"],
                         attention_dq=tiled_launches["attention_dq"])
    out = []
    for name, (source, tpu) in replaces.items():
        r = rows[name]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": tpu,
            "launches": main_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"],
            "bound_by": "bytes" if r["t_bytes"] >= r["t_ops"] else "operations",
            "library_ms": r["library_ms"]})
    log(json.dumps({"kernels": out, "clips_per_s": clips_per_s,
                    "train_clips_per_s": clips_s,
                    "timesformer_clips_per_s": ts_clips_s,
                    "timesformer_train_clips_per_s": ts_train_clips_s,
                    "sweep": sweep, "files": files, "card": card}))
    log(f"card: {card_line()}")
    log(f"chip_smoke: {time.perf_counter() - start:.1f} s wall")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: no result line, exit 1
        import traceback
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
