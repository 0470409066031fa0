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
 11. serving and export: a probe of ``websockets`` and Pillow (where
     websockets is missing, the clients drive the server's ``_ws_handler``
     in-process through a stand-in socket); a TSM-R50 ``WorkoutServer``
     built by ``server.build_server`` as ``server.main`` builds it
     (``repcount_12_tsm.yaml``, ``--num-class 11``, bf16, 224², window
     batch 16) over a port checkpoint of random weights with the
     brightness head, run by ``run()`` on free localhost ports: the launch
     counts when the HTTP port first accepts (warmup's one forward, before
     the listener bound) and /healthz ``warm``; POST /video of a written
     mp4 (320×240, 7 reps) held to the fp32 plain engine on the same
     sampled window by phase 4's logit rule; 8 concurrent WebSocket
     clients (half through the HTTP port's Upgrade splice), each streaming
     64 JPEG data-URL frames at 320×240 in recognize mode, a window at a
     time, each getting 8 replies, with the batcher's flushes fewer than
     its requests and 10 shift-matmul and 6 fused-bottleneck launches per
     flush (windows/s, p50/p95 reply latency, coalescing, the frame
     decoder); one count-mode client over the whole video, whose final
     count must be its reps; ``begin_drain`` with a client connected
     (/healthz 503, the draining notice). Then ``scripts.export_model`` on
     the card: ``.pt2`` artifacts of that checkpoint and of
     TimeSformer-B/16 (initializers from seed 0; export seconds and MB),
     each loaded by ``engine_from_checkpoint``: per forward the live
     engine's launches (10 shift-matmul and 6 fused-bottleneck; 12
     attention), logits by the logit rule with equal argmax on phase 4's
     38 windows (16 for TimeSformer), clips/s of both; and a server over
     the TSM artifact, whose POST /video payload must be the live
     server's;
 12. TPN-R50 (``workoutdetector_tpu/configs/tpn.yaml``: TSM-R50 backbone
     tapped at stages 3 and 4, the pyramid neck 1024 → 2048, 12 classes,
     bf16), random numpy-seeded flax weights: ``score_video`` and
     ``count_by_video_model`` on the phase-4 video (6 fused-bottleneck and
     10 shift-matmul launches a forward), the logits by phase 4's rule
     against the fp32 plain model, phase 4's count check; a ``.pt2``
     export on the card, its launches and logits equal to the live
     engine's; 4 train steps at batch 32 on a DebugDataset batch with the
     yaml's optimizer (nesterov SGD, multistep, clip 20, partial BN, aux
     weight 0.5): 16 shift-matmul, 33 dx and 33 dW launches a step, finite
     losses with the aux head's term in them, train clips/s and one
     profiled step (device busy time); ``grad_check`` with the aux loss
     and its two planted faults;
 13. TDN-R50 (``workoutdetector_tpu/configs/tdn.yaml``: 8 segments of
     5-frame bursts, 12 classes, bf16), random numpy-seeded flax weights:
     ``score_windows`` of a rank-6 engine on 16 burst windows cut from the
     phase-4 video (no hand-kernel launch: TDN has none), the logits by
     phase 4's rule against the fp32 model, ``score_video`` refused; a
     rank-6 ``.pt2`` export on the card whose logits equal the live
     engine's; 6 train steps at batch 16 from ``TDNDataset`` over phase
     10's rawframe corpus (written anew), finite losses, train clips/s;
 14. the image models (``workoutdetector_tpu/configs/lit_img.yaml``: a
     ResNet-50 image classifier, 224², bf16, 2 classes, AdamW, batch 64),
     random numpy-seeded flax weights with the brightness head, from a
     port checkpoint through ``engine_from_checkpoint`` (rank 4):
     ``score_images`` on phase 11's 291-frame video (6 fused-bottleneck
     launches a forward, at fold 0 and n_segment 1; the logit rule against
     the fp32 plain path; images/s; one profiled batch) and
     ``count_by_image_model`` on its mp4 (the kernel path's count and reps
     equal to the fp32 plain engine's; a planted swap of two frames caught);
     its ``.pt2`` through ``scripts/export_model`` (launches, logits and
     count as the live engine's); ``Trainer.fit`` for 3 steps from
     ``ImageDataset`` over 224 written JPEGs (33 dx + 33 dW launches a
     step, finite losses), ``backward_order_check`` at batch 64 (the
     kernels' gradients against their plain versions under one fixed
     forward: a random ResNet-50 with every BN on batch statistics is too
     chaotic for grad_check's fp32 comparison) with two planted faults of
     the unshifted backward, train images/s; ConvNeXt-B and
     ViT-B/16 at 224² (logits against fp32 plain, images/s, one finite
     train step each, no hand-kernel launch); and the counters over phase
     9's corpus, card against CPU: ``eval_dataset`` in ``motion``,
     ``similarity`` (the CLI's headless ResNet-18 at 48²) and ``image``
     mode (the fp32 model at 48² on the card and on the CPU, the kernel
     path's counts beside), and the similarity's lag profile with TF32
     matmuls allowed;
 15. RepNet-base (``workoutdetector_tpu/configs/repnet.yaml``: 64-frame
     windows at 64², bf16, the port's initializers from seed 0; no hand
     kernel) and TimeSformer-B/16 with MoE MLPs (``timesformer.yaml`` with
     ``model.moe_experts=8``: capacity 1.25, load-balance weight 0.01):
     RepNet's per-frame logits on windows of a written periodic video
     (``synth_periodic_clip``, period 8, 60 reps) by phase 4's rule
     against the fp32 model, windows/s and a profiled batch;
     ``count_by_repnet`` with the grid under a head that leaves no frame
     near the 0.5 threshold (``periodic_head``): the bf16 count, the fp32
     path's and the video's reps equal; its ``.pt2`` through
     ``scripts/export_model`` (frame logits and count as live);
     ``StreamingPeriodicCounter`` card against CPU; a server with
     ``--repnet-checkpoint`` and 3 WebSocket clients in
     ``mode:count-periodic``, their statuses the direct counter's, the
     periodic batcher's coalescing; ``Trainer.fit`` from
     ``SyntheticPeriodic`` at batch 32 (losses, loader-fed and in-memory
     clips/s, idle shares). The MoE model: 12 attention launches a
     forward on phase 4's video, logits by the rule against the fp32
     plain model routed as the kernel path (``RouteTape``), each block's
     dropped share and the share of tokens the two paths route apart;
     train steps at batch 16 (12 + 12 launches, clips/s beside phase
     8's), ``grad_check`` on one routing with phase 8's planted fault;
     ``MoEMlp`` alone, card against CPU on identical inputs: equal
     routing;
 16. the person detector, the person crop and pose (``models/detector.py``,
     ``data/person.py``, ``models/pose.py``, their scripts): the tiny
     detector at its defaults (TinyFCN width 32, head 64, input 128,
     fp32) trained by ``train_detector`` on ``person_dataset`` at 128²
     (steps/s, a profiled 20-step call, held-out mean IoU > 0.5, the JAX
     test's bar); ``LearnedDetectorBackend`` on a 40-frame 240×320 clip,
     card against the CPU on the same weights (maps within 1e-4 and boxes
     within 1e-2 px with TF32 off, the TF32 gap printed beside);
     ``Detector(backend="learned")`` on its saved file, ``PersonCrop``
     card = CPU, ``build_dataset`` on a test split with ``person_crop``
     over 3 written JPEG clips (items equal to the CPU backend's), and
     ``scripts/bbox.py json`` on a written video; the ResNet-50 detector
     and pose model at 128² in bf16 (6 fused-bottleneck launches a
     forward, maps by phase 4's rule against the fp32 plain models, peak
     cells equal where the fp32 margin exceeds twice the error, and there
     the detector's decoded top boxes within stride·(max|Δoffset| +
     max|Δwh|/2)); the tiny
     pose model trained by ``train_pose`` at 128² to a mean keypoint error
     under 0.1·128, ``estimate_clip`` card = CPU, and ``scripts/pose.py``'s
     ``inference_one_video`` with the learned crop (card = CPU) and
     ``render_pose_video``;
 17. one JSON line of per-kernel numbers (and the sweep's, the file
     training's, the serving phase's, TPN's, TDN's, the image phase's,
     RepNet's, the MoE model's and phase 16's numbers), the card line
     again, the script's wall time, and the contract line ``{"ok": true,
     "device": {...}}`` last.

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
dK/dV + dQ + D beside it. The ``*_image`` rows are the same kernels at the
image ResNet-50's sites: the fused bottleneck per forward of 16 images at
fold 0, dx and dW per train step of 64 unshifted images (33 sites); the
``fused_bottleneck_person`` row is the fused bottleneck at the detector's
and pose's ResNet-50 sites at 128² (16 images, fold 0), its launches
those of phase 16's two 40-frame runs.
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
# the same stride-1 blocks in the detector's and pose's ResNet-50 backbone
# at their 128² input (phase 16): layer1 at 32², layer2 at 16²
PERSON_SIZE = 128
PERSON_FUSED_SITES = [(h * PERSON_SIZE // SIZE, w * PERSON_SIZE // SIZE, c, f,
                       o, ds, n) for h, w, c, f, o, ds, n in FUSED_SITES]
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
    # the image ResNet-50's fused sites: the same blocks on WINDOW_BATCH
    # single images, n_segment 1, fold 0 (lit_img.yaml's inference, [14a])
    for h, w, c, f, o, ds, count in FUSED_SITES:
        x = randn(WINDOW_BATCH, h, w, c)
        p = fused_params(c, f, o, ds)
        got = kernels.fused_bottleneck(x, p, n_segment=1, fold=0)
        want = kernels.fused_bottleneck_plain(x, p, n_segment=1, fold=0)
        torch.cuda.synchronize()
        err = check_close(torch, f"fused_bottleneck_image {tuple(x.shape)} "
                          f"F={f} O={o}", got, want)
        del got, want
        ms = time_ms(torch, lambda: kernels.fused_bottleneck(
            x, p, n_segment=1, fold=0), 20)
        pms = time_ms(torch, lambda: kernels.fused_bottleneck_plain(
            x, p, n_segment=1, fold=0), 5)
        tb, to = fused_bound(WINDOW_BATCH * h * w, c, f, o, ds)
        add("fused_bottleneck_image", err, ms, pms, tb, to, count)
        log(f"  fused_bottleneck_image x{tuple(x.shape)} F={f} O={o} ds={ds} "
            f"err={err} kernel={ms:.4f} ms plain={pms:.4f} ms "
            f"bound={max(tb, to):.4f} ms")
        del x, p
    # the detector's and pose's ResNet-50 sites: WINDOW_BATCH images at
    # 128² (the learned backend's batch of 16), fold 0 ([16b])
    for h, w, c, f, o, ds, count in PERSON_FUSED_SITES:
        x = randn(WINDOW_BATCH, h, w, c)
        p = fused_params(c, f, o, ds)
        got = kernels.fused_bottleneck(x, p, n_segment=1, fold=0)
        want = kernels.fused_bottleneck_plain(x, p, n_segment=1, fold=0)
        torch.cuda.synchronize()
        err = check_close(torch, f"fused_bottleneck_person {tuple(x.shape)} "
                          f"F={f} O={o}", got, want)
        del got, want
        ms = time_ms(torch, lambda: kernels.fused_bottleneck(
            x, p, n_segment=1, fold=0), 20)
        pms = time_ms(torch, lambda: kernels.fused_bottleneck_plain(
            x, p, n_segment=1, fold=0), 5)
        tb, to = fused_bound(WINDOW_BATCH * h * w, c, f, o, ds)
        add("fused_bottleneck_person", err, ms, pms, tb, to, count)
        log(f"  fused_bottleneck_person x{tuple(x.shape)} F={f} O={o} ds={ds} "
            f"err={err} kernel={ms:.4f} ms plain={pms:.4f} ms "
            f"bound={max(tb, to):.4f} ms")
        del x, p
    attention_row(torch, kernels, randn, add)
    attention_bwd_rows(torch, kernels, randn, add)
    backward_rows(torch, kernels, randn, add)
    backward_rows(torch, kernels, randn, add, frames=IMAGE_BATCH, image=True)
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


def backward_rows(torch, kernels, randn, add, frames: int = TRAIN_BATCH * FRAMES,
                  image: bool = False) -> None:
    """dx and dW at every TSM-R50 224² backward site of one train step
    (batch 32 clips = 256 frames), and the shift-matmul forward at its
    shifted sites (``shift_matmul_train``); with ``image``, the image
    ResNet-50's sites (``frames`` images, every site unshifted) in the rows
    ``conv1x1_dx_image`` and ``conv1x1_dw_image``."""
    tag = "_image" if image else ""
    for h, c, o, shifted, count in BWD_SITES:
        shifted = shifted and not image
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
        add("conv1x1_dx" + tag, err, ms, pms, tb, to, count, lms)
        log(f"  conv1x1_dx{tag} {site} err={err} kernel={ms:.4f} ms plain={pms:.4f}"
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
        add("conv1x1_dw" + tag, err, ms, pms, tb, to, count, lms)
        log(f"  conv1x1_dw{tag} {site} err={err} kernel={ms:.4f} ms plain={pms:.4f}"
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
    from workoutdetector_tpu_torch.train.trainer import Trainer

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

    grad_check(np, torch, build_model, load_flax_variables, cfg, variables,
               TRAIN_BATCH, shift_faults())

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


def shift_faults() -> dict:
    """grad_check's planted faults of the shifted conv's backward:
    ShiftConv1x1.backward calls the conv1x1 module's wrappers, so swapping
    one for a version that drops the shift arguments miswires every
    shifted site (Sᵀ left out of dx; dW over x, not shift(x))."""
    from workoutdetector_tpu_torch.ops.kernels import conv1x1 as c1

    def drop_shift(real):  # the wrapper without its shift arguments
        def fault(a, b, *shift):
            return real(a, b)
        fault.launches = 0  # the real wrapper counts on its module's name
        return fault

    return {"dx without S^T": (c1, "conv1x1_dx", drop_shift),
            "dW over unshifted x": (c1, "conv1x1_dw", drop_shift)}


def grad_check(np, torch, build_model, load_flax_variables, cfg, variables,
               batch: int, faults: dict, shared_routes: bool = False) -> None:
    """One batch's gradients of the main path (bf16, kernels) against the
    port's plain path in fp32 on the card, per leaf, with the bf16 plain
    path's own error beside; the loss is the train step's (``train_loss``:
    with the aux head's term where the model has one, at the config's
    weight); the three runs draw the same dropout and
    drop-path masks (one generator seed, masks drawn in fp32). The batch
    is numpy-seeded noise, different in every frame (a DebugDataset clip
    repeats one colour, so a fault in a temporal direction would barely
    show). Then the same check with each planted fault, which it must
    catch: ``faults`` maps a label to (module, attribute, make), and the
    attribute is replaced by ``make(real)`` for that run.
    ``shared_routes``: a MoE model's every run takes the fp32 run's
    routing (``RouteTape``), so a token routed apart by rounding does not
    pass for a gradient fault."""
    import contextlib
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    from workoutdetector_tpu_torch.train.trainer import train_loss

    rng = np.random.default_rng(5)
    x = normalize_clip(torch.from_numpy(rng.integers(
        0, 256, (batch, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)).cuda())
    yt = torch.from_numpy(rng.integers(0, NUM_CLASS, batch)).cuda()

    routes = []

    def grads(dtype, use_kernels):
        c = cfg.clone()
        c.model.dtype = dtype
        model = build_model(c.model, use_kernels=use_kernels).cuda()
        load_flax_variables(model, variables)
        model.train()
        g = torch.Generator(device="cuda").manual_seed(7)
        tape = RouteTape(routes or None) if shared_routes \
            else contextlib.nullcontext()
        with tape:
            loss, _ = train_loss(model(x, dropout_generator=g), yt,
                                 c.model.aux_loss_weight,
                                 c.model.moe_aux_weight)
        if shared_routes and not routes:
            routes.extend(tape.calls)
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
    from its first to its last recorded activity. Returns (idle share,
    busy ms), both None when the profiler recorded no device time."""
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
        return None, None
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
    return max(0.0, 1 - device_ms / wall_ms), device_ms


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


def ts_train_config(repo: Path, steps: int, dataset_size: int, root: str,
                    opts=()):
    """workoutdetector_tpu/configs/timesformer.yaml as the CLI loads it
    (ViT-B/16 224², 8 segments, 12 classes, divided attention, drop_path
    0.1, bf16; SGD Nesterov, wd 1e-4 with the embeddings exempt, clip 40,
    multistep; batch 16) with a DebugDataset of 12 classes in place of its
    FrameDataset, which needs data the repo lacks, and the run's step
    count and paths; ``opts``: dotted overrides."""
    from workoutdetector_tpu_torch.config import load_config
    cfg = load_config(str(repo / "workoutdetector_tpu" / "configs"
                          / "timesformer.yaml"), list(opts))
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
    from workoutdetector_tpu_torch.train.trainer import Trainer

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

    grad_check(np, torch, build_model, load_flax_variables,
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


def brightness_head(np, torch, model, ref_model, frames, head=None):
    """Set the TSM head so that its state follows the frame brightness: of
    a decoded corpus video ``frames``, a dark window (its 8 darkest frames)
    and a bright one (its 8 brightest) go through the fp32 plain path (for
    an image model, ``head`` given: its darkest and its brightest frame, and
    ``head(model)`` is the head); the
    two classes whose logits differ most between them go to rows 0 and 1,
    their biases tie halfway between the two windows (mid-grey in logit
    space), and the other rows get weight 0 and bias −1e3. Applied to both
    models; returns the two classes."""
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    order = np.argsort(frames.reshape(len(frames), -1).mean(1))
    if head is None:
        windows = np.stack([frames[np.sort(order[:FRAMES])],
                            frames[np.sort(order[-FRAMES:])]])
    else:
        windows = frames[[order[0], order[-1]]]
    x = torch.from_numpy(windows).to("cuda")
    with torch.no_grad():
        dark, bright = ref_model.to("cuda").eval()(normalize_clip(x)) \
            .double().cpu().numpy()
    diff = bright - dark
    a, b = int(np.argmin(diff)), int(np.argmax(diff))
    tie = ((dark[a] - dark[b]) + (bright[a] - bright[b])) / 2
    for m in (model, ref_model):
        fc = m.fc if head is None else head(m)
        w, bias = fc.weight.data, fc.bias.data
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

        idle, _ = profile_call(torch, three_steps, top=8)
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


# ---------------------------------------------------------------- phase 11
SERVE_CLIENTS = 8
SERVE_WINDOWS = 8  # replies per recognize client: 64 frames
SERVE_CLASSES = 11  # server.main's --num-class
SERVE_REPS = 7  # reps of the count-mode client's video


class LocalSocket:
    """A stand-in for a websockets connection, where the package is
    missing: the handler iterates over the client's messages and ``send``s
    its replies; the client side ``put``s and ``recv``s."""

    def __init__(self, asyncio):
        self.inbox, self.outbox = asyncio.Queue(), asyncio.Queue()

    def __aiter__(self):
        return self

    async def __anext__(self):
        message = await self.inbox.get()
        if message is None:
            raise StopAsyncIteration
        return message

    async def send(self, text):
        await self.outbox.put(text)

    async def recv(self):
        return await self.outbox.get()


def ws_connect(asyncio, srv, port, have_ws: bool):
    """An async context manager: a client connection to ``srv``, through
    the websockets client on ``port`` where the package imports, else a
    ``LocalSocket`` handed to ``srv._ws_handler`` on this event loop."""
    import contextlib

    @contextlib.asynccontextmanager
    async def connect():
        if have_ws:
            import websockets
            async with websockets.connect(
                    f"ws://127.0.0.1:{port}/ws/smoke", max_size=None) as ws:
                yield ws
            return
        sock = LocalSocket(asyncio)
        handler = asyncio.create_task(srv._ws_handler(sock))

        class Client:
            send = sock.inbox.put
            recv = sock.recv

        try:
            yield Client()
        finally:
            await sock.inbox.put(None)
            await handler

    return connect()


def http_json(url: str, data: bytes = None):
    """(status, JSON body) of a GET, or of a POST of ``data``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=data,
                                 method="POST" if data is not None else "GET")
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def payload_scores(np, payload, labels):
    """A POST /video payload → its scores in class order, checking that it
    is sorted by score."""
    values = list(payload["data"].values())
    if values != sorted(values, reverse=True) or len(values) != len(labels):
        raise AssertionError(f"payload not sorted or not {len(labels)} labels")
    return np.array([payload["data"][name] for name in labels], np.float64)


def start_server(srv, threading, have_ws: bool):
    """Run ``srv`` as ``server.main`` does (``run``: warmup, then the HTTP
    listener, then the WS loop) in a thread; without websockets, warmup and
    the HTTP listener only. Returns the thread (None without websockets)
    once the HTTP port accepts."""
    import socket
    if have_ws:
        thread = threading.Thread(target=srv.run, daemon=True)
        thread.start()
    else:
        thread = None
        srv.warmup()
        srv.start_http()
    deadline = time.time() + 300
    while time.time() < deadline:
        try:
            socket.create_connection(("127.0.0.1", srv.http_port),
                                     timeout=1).close()
            return thread
        except OSError:
            if thread is not None and not thread.is_alive():
                raise AssertionError("the server thread ended before listening")
            time.sleep(0.005)
    raise AssertionError("the server did not start listening")


def stop_server(srv, thread) -> None:
    srv.begin_drain()
    if thread is not None:
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("the server did not stop after the drain")
    else:
        srv.shutdown()


def serve_phase(np, torch, kernels, repo: Path, card: str) -> dict:
    """Phase 11: serving and export through the port's entry points. A
    TSM-R50 ``WorkoutServer`` as ``server.main`` builds it, over a port
    checkpoint of random weights with the brightness head; 8 WebSocket
    clients, one count-mode client, POST /video and the drain; then
    ``.pt2`` artifacts of TSM-R50 and TimeSformer-B/16 exported on the
    card, their engines and a server over the TSM one. Returns the phase's
    numbers."""
    import asyncio
    import base64
    import io
    import os
    import shutil
    import tempfile
    import threading

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data.sampling import sample_frames
    from workoutdetector_tpu_torch.data.video import VideoReader, write_video
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 engine_from_checkpoint)
    from workoutdetector_tpu_torch.models import build_model
    from workoutdetector_tpu_torch.models.convert import (load_flax_variables,
                                                          random_flax_variables)
    from workoutdetector_tpu_torch.scripts import export_model as export_cli
    from workoutdetector_tpu_torch.serve import server
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager

    phase_t0 = time.perf_counter()
    found = {}
    for mod in ("websockets", "PIL"):
        try:
            found[mod] = importlib.import_module(mod).__version__
        except ImportError as exc:
            found[mod] = f"missing ({exc})"
    have_ws = not found["websockets"].startswith("missing")
    log(f"    probe: websockets {found['websockets']}, PIL {found['PIL']}"
        + ("" if have_ws else "; the WS clients drive _ws_handler in-process "
           "through a stand-in socket"))

    tmp = Path(tempfile.mkdtemp(prefix=".smoke-serve-", dir=repo))
    srv = thread = art_srv = art_thread = None
    try:
        rng = np.random.default_rng(11)
        frames, reps = sweep_frames(np, rng, "squat", SERVE_REPS)
        mp4 = str(tmp / "squat.mp4")
        write_video(mp4, frames, 30.0)

        def jpeg(frame):
            if not found["PIL"].startswith("missing"):
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(frame).save(buf, format="JPEG")
                return buf.getvalue()
            import cv2
            return cv2.imencode(".jpg", frame[..., ::-1])[1].tobytes()

        jpegs = [jpeg(f) for f in frames]
        urls = ["data:image/jpeg;base64," + base64.b64encode(j).decode()
                for j in jpegs]
        backend = server.decode_image_bytes(jpegs[0])[1]
        log(f"    video: {len(frames)} frames {SWEEP_W}x{SWEEP_H}, "
            f"{SERVE_REPS} reps ({mp4.rsplit('/', 1)[1]}, cv2 write_video); "
            f"frames as JPEG data URLs, decoded by the server with {backend}")

        # the checkpoint server.main serves: repcount_12_tsm.yaml with
        # --num-class 11, random weights, the brightness head
        cfg = load_config(str(repo / TSM_YAML),
                          [f"model.num_class={SERVE_CLASSES}"])
        model = build_model(cfg.model)
        variables = random_flax_variables(model, seed=0)
        load_flax_variables(model, variables)
        ref_model = build_model(load_config(
            str(repo / TSM_YAML), [f"model.num_class={SERVE_CLASSES}",
                                   "model.dtype=float32"]).model,
            use_kernels=False)
        load_flax_variables(ref_model, variables)
        a, b = brightness_head(np, torch, model, ref_model,
                               server.prep_frames(list(frames), SIZE))
        ckpt = CheckpointManager(str(tmp / "ckpt")).save(
            {"model": model.state_dict()}, name="tsm_r50")
        del model
        ref_engine = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH,
                                     device="cuda")
        log(f"    head: classes {a} (dark), {b} (bright) -> rows 0, 1")

        port = free_port()
        argv = ["--cfg", str(repo / TSM_YAML), "--checkpoint", ckpt,
                "--num-class", str(SERVE_CLASSES), "--port", str(port)]
        srv = server.build_server(argv)
        srv.host, srv.ws_port = "127.0.0.1", free_port()
        eng = srv.engine
        log(f"    server.build_server({' '.join(argv[2:])}): TSM-R50 "
            f"{eng.image_size}, window_batch {eng.window_batch}, "
            f"{eng.model.dtype}")
        kernels.reset_launches()
        t0 = time.perf_counter()
        thread = start_server(srv, threading, have_ws)
        listen_s = time.perf_counter() - t0
        warm = kernels.launch_counts()
        code, health = http_json(f"http://127.0.0.1:{port}/healthz")
        log(f"    run(): the HTTP port accepted {listen_s:.3f} s after start; "
            f"launches before it bound (warmup) {warm}; /healthz {code} "
            f"{health}")
        if {k: v for k, v in warm.items() if v} != \
                {"shift_matmul": 10, "fused_bottleneck": 6} or \
                code != 200 or health.get("warm") is not True:
            raise AssertionError("warmup did not launch the serving kernels "
                                 "before the listener bound")

        # POST /video: the sampled window against the fp32 plain engine
        code, posted = http_json(f"http://127.0.0.1:{port}/video",
                                 Path(mp4).read_bytes())
        with VideoReader(mp4) as r:
            clip = r.read_prepped(256, SIZE)
        window = clip[sample_frames(len(clip), FRAMES, random=False)]
        ref = ref_engine.score_windows(window[None])
        got = payload_scores(np, posted, srv.labels)[None]
        log(f"    POST /video: {code}, top {list(posted['data'].items())[:2]}")
        logit_rule(np, got[:, :2], ref[:, :2], "POST /video (rows 0, 1)")

        # 8 concurrent recognize clients, 64 frames each, paced per window
        async def recognize(k, results, lat):
            offset = (k * 29) % (len(urls) - 8 * SERVE_WINDOWS)
            use = port if k % 2 else srv.ws_port  # half through the splice
            async with ws_connect(asyncio, srv, use, have_ws) as ws:
                for i in range(8 * SERVE_WINDOWS):
                    await ws.send(urls[offset + i])
                    if i % 8 == 7:
                        t = time.perf_counter()
                        reply = json.loads(await asyncio.wait_for(
                            ws.recv(), 120))
                        lat.append(time.perf_counter() - t)
                        results[k].append(reply)
                await ws.send("stop")

        async def recognize_all():
            results = {k: [] for k in range(SERVE_CLIENTS)}
            lat = []
            await asyncio.gather(*[recognize(k, results, lat)
                                   for k in range(SERVE_CLIENTS)])
            return results, lat

        before = (srv.batcher.n_requests, srv.batcher.n_flushes)
        kernels.reset_launches()
        t0 = time.perf_counter()
        results, lat = asyncio.run(recognize_all())
        wall = time.perf_counter() - t0
        launches = kernels.launch_counts()
        requests = srv.batcher.n_requests - before[0]
        flushes = srv.batcher.n_flushes - before[1]
        code, stats = http_json(f"http://127.0.0.1:{port}/stats")
        windows = SERVE_CLIENTS * SERVE_WINDOWS
        p50, p95 = (float(np.percentile(lat, q) * 1e3) for q in (50, 95))
        via = f"{SERVE_CLIENTS // 2} through the HTTP port's splice" \
            if have_ws else "in-process stand-in sockets"
        log(f"    {SERVE_CLIENTS} WS clients x {8 * SERVE_WINDOWS} frames "
            f"({via}): "
            f"{windows} windows in {wall:.4f} s = {windows / wall:.2f} "
            f"windows/s, reply latency p50 {p50:.2f} ms p95 {p95:.2f} ms on "
            f"{card}; {requests} requests in {flushes} flushes "
            f"(coalescing {requests / max(flushes, 1):.2f}); /stats "
            f"{stats['batcher']}; launches={launches}")
        if any(len(r) != SERVE_WINDOWS or not all(x.get("success") for x in r)
               for r in results.values()):
            raise AssertionError("a client did not get its 8 replies")
        if requests != windows or not flushes < requests:
            raise AssertionError(f"the batcher did not coalesce: {requests} "
                                 f"requests, {flushes} flushes")
        want = {name: 0 for name in launches}
        want.update(shift_matmul=10 * flushes, fused_bottleneck=6 * flushes)
        if launches != want:
            raise AssertionError(f"serving launch counts {launches} != {want}")
        # the host's work of one round, serially on one thread: 64 frame
        # decodes, 8 window preps, and one 8-window score_windows
        t0 = time.perf_counter()
        decoded = [server.decode_data_url(u) for u in urls[:64]]
        decode_ms = (time.perf_counter() - t0) * 1e3 / 64
        t0 = time.perf_counter()
        prepped = [server.prep_frames(decoded[i:i + 8], SIZE)
                   for i in range(0, 64, 8)]
        prep_ms = (time.perf_counter() - t0) * 1e3 / 8
        flush = []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.score_windows(np.stack(prepped))
            torch.cuda.synchronize()
            flush.append((time.perf_counter() - t0) * 1e3)
        flush_ms = float(np.mean(flush[1:]))
        log(f"    one round's host work, serial: decode {decode_ms:.3f} ms a "
            f"frame ({backend}), prep {prep_ms:.3f} ms a window, "
            f"score_windows of 8 windows {flush_ms:.3f} ms (the mean of 3 "
            f"after a first {flush[0]:.3f}); the server's "
            f"prep pool has {srv._prep_pool._max_workers} threads, the "
            f"host {os.cpu_count()} cores")

        # one count-mode client over the whole video, paced per window
        async def count_client():
            replies = []
            async with ws_connect(asyncio, srv, srv.ws_port, have_ws) as ws:
                await ws.send("mode:count")
                for i, url in enumerate(urls):
                    await ws.send(url)
                    if i % 8 == 7:
                        replies.append(json.loads(await asyncio.wait_for(
                            ws.recv(), 120)))
                await ws.send("stop")
            return replies

        shed = srv._frames_shed
        replies = asyncio.run(count_client())
        final = replies[-1]["count"]
        log(f"    count mode: {len(replies)} replies, final count {final} "
            f"(the video's reps: {SERVE_REPS}), states "
            f"{''.join(str(r['state']) for r in replies)}, frames shed "
            f"{srv._frames_shed - shed}")
        if final != SERVE_REPS or srv._frames_shed != shed:
            raise AssertionError("the count-mode count is not the video's reps")

        # the drain, with a client connected
        async def drain():
            async with ws_connect(asyncio, srv, srv.ws_port, have_ws) as ws:
                srv.begin_drain()
                loop = asyncio.get_running_loop()
                status = await loop.run_in_executor(
                    None, http_json, f"http://127.0.0.1:{port}/healthz")
                await ws.send(urls[0])
                notice = json.loads(await asyncio.wait_for(ws.recv(), 30))
            return status, notice

        (code, health), notice = asyncio.run(drain())
        log(f"    begin_drain: /healthz {code} {health['status']}; the "
            f"connected client: {notice}")
        if code != 503 or notice.get("draining") is not True:
            raise AssertionError("the drain did not turn /healthz to 503")
        stop_server(srv, thread)
        srv = thread = None

        # export: TSM-R50 from the same checkpoint, on the card
        out = {}
        arts = {}
        for name, yaml, extra in (
                ("tsm", TSM_YAML, ["--checkpoint", ckpt,
                                   f"model.num_class={SERVE_CLASSES}"]),
                ("timesformer", TS_YAML, [])):
            path = str(tmp / f"{name}.pt2")
            t0 = time.perf_counter()
            export_cli.main(["--cfg", str(repo / yaml), "-o", path,
                             "--batch", str(WINDOW_BATCH)] + extra)
            torch.cuda.synchronize()
            export_s = time.perf_counter() - t0
            mb = Path(path).stat().st_size / 2 ** 20
            arts[name] = path
            out[f"{name}_export_s"], out[f"{name}_artifact_mb"] = export_s, mb
            log(f"    export_model ({yaml.rsplit('/', 1)[1]}): {export_s:.2f} s, "
                f"{mb:.1f} MB artifact")

        video = synthetic_video(np, 299, seed=1)
        starts = np.arange(0, len(video), 8)
        batch = eng.gather_windows(video, starts, stride=2)  # phase 4's 38
        for name, yaml, live_cfg in (
                ("tsm", TSM_YAML, [f"model.num_class={SERVE_CLASSES}"]),
                ("timesformer", TS_YAML, [])):
            cfg = load_config(str(repo / yaml), live_cfg)
            art = engine_from_checkpoint(cfg, arts[name])
            live = eng if name == "tsm" else engine_from_checkpoint(
                cfg, None, image_size=cfg.data.image_size)
            x = batch if name == "tsm" else batch[:WINDOW_BATCH]
            scored, counts, times = [], [], []
            for e in (live, art):
                e.score_windows(x)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                scored.append(e.score_windows(x))
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                counts.append({k: v for k, v in kernels.launch_counts().items()
                               if v})
            forwards = math.ceil(len(x) / WINDOW_BATCH)
            want = {"shift_matmul": 10 * forwards,
                    "fused_bottleneck": 6 * forwards} if name == "tsm" \
                else {"attention": TS_LAYERS * forwards}
            err = float(np.abs(scored[1] - scored[0]).max())
            same = bool((scored[1].argmax(1) == scored[0].argmax(1)).all())
            log(f"    {name} artifact (engine_from_checkpoint, window_batch "
                f"{art.window_batch}, device gather {art.supports_device_gather}"
                f"): {len(x)} windows, {forwards} forwards; launches live "
                f"{counts[0]}, artifact {counts[1]}; max |logit diff| vs the "
                f"live engine {err:.6f}, argmax equal {same}; "
                f"{len(x) / times[0]:.2f} clips/s live, "
                f"{len(x) / times[1]:.2f} artifact on {card}")
            if counts[0] != want or counts[1] != want:
                raise AssertionError(f"{name} artifact launches {counts[1]} "
                                     f"(live {counts[0]}) != {want}")
            live_rows = 2 if name == "tsm" else scored[0].shape[1]
            logit_rule(np, scored[1][:, :live_rows], scored[0][:, :live_rows],
                       f"{name} artifact vs the live engine")
            if not same:
                raise AssertionError(f"{name} artifact changed an argmax")
            out[f"{name}_artifact_clips_per_s"] = len(x) / times[1]
            out[f"{name}_live_clips_per_s"] = len(x) / times[0]
            out[f"{name}_artifact_max_abs_diff"] = err
            del art, live
            torch.cuda.empty_cache()

        # a server over the TSM artifact: the same POST /video payload
        art_port = free_port()
        art_srv = server.build_server(["--checkpoint", arts["tsm"],
                                       "--num-class", str(SERVE_CLASSES),
                                       "--port", str(art_port)])
        art_srv.host, art_srv.ws_port = "127.0.0.1", free_port()
        art_thread = start_server(art_srv, threading, have_ws)
        code, art_posted = http_json(f"http://127.0.0.1:{art_port}/video",
                                     Path(mp4).read_bytes())
        art_got = payload_scores(np, art_posted, art_srv.labels)
        diff = float(np.abs(art_got - got[0]).max())
        log(f"    server over the TSM artifact: POST /video {code}, label "
            f"order {'equal' if list(art_posted['data']) == list(posted['data']) else 'DIFFERENT'}, "
            f"max |score diff| vs the live server {diff:.6f}")
        if list(art_posted["data"]) != list(posted["data"]):
            raise AssertionError("the artifact server's payload differs")
        logit_rule(np, art_got[None, :2], got[:, :2],
                   "artifact server vs live server (rows 0, 1)")
        stop_server(art_srv, art_thread)
        art_srv = art_thread = None
        log(f"    phase [11]: {time.perf_counter() - phase_t0:.1f} s")
        return dict(out, windows_per_s=windows / wall, wall_s=wall,
                    latency_p50_ms=p50, latency_p95_ms=p95,
                    requests=requests, flushes=flushes,
                    coalescing=requests / flushes,
                    serve_launches={"shift_matmul": launches["shift_matmul"],
                                    "fused_bottleneck":
                                        launches["fused_bottleneck"]},
                    count=final, decode_backend=backend,
                    decode_ms=decode_ms, prep_ms=prep_ms, flush_ms=flush_ms,
                    websockets=found["websockets"], pil=found["PIL"])
    finally:
        for s, t in ((srv, thread), (art_srv, art_thread)):
            if s is not None:
                try:
                    stop_server(s, t)
                except Exception as exc:  # already failing: report, go on
                    log(f"    (stopping a server: {exc})")
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------- phase 12
# TPN-R50 (tpn.yaml): its backbone is TSM-R50's, so a forward runs TSM's 6
# fused-bottleneck and 10 shift-matmul launches and a train step its 16
# shift-matmul, 33 dx and 33 dW launches; the neck (3-D convs) and TDN
# (phase 13) run cuDNN and cuBLAS only.
TPN_YAML = "workoutdetector_tpu/configs/tpn.yaml"
TDN_YAML = "workoutdetector_tpu/configs/tdn.yaml"
TPN_TRAIN_STEPS = 4
TDN_TRAIN_STEPS = 6
TDN_BATCH = 16  # tdn.yaml's batch
BURST = 5  # TDN's frames per segment


def tpn_phase(np, torch, kernels, video, repo: Path, card: str) -> dict:
    """Phase 12: TPN-R50 inference, training and export on the card.
    Returns the phase's numbers."""
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data.datasets import DebugDataset
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_video_model)
    from workoutdetector_tpu_torch.models import (build_model,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    from workoutdetector_tpu_torch.train.trainer import (Trainer,
                                                         cross_entropy,
                                                         train_loss)
    from workoutdetector_tpu_torch.utils.export import export_model

    phase_t0 = time.perf_counter()
    cfg = load_config(str(repo / TPN_YAML))
    if (cfg.model.model_type, cfg.model.base_model, cfg.model.dtype,
            cfg.model.num_class, cfg.data.batch_size) != \
            ("tpn", "resnet50", "bfloat16", NUM_CLASS, TRAIN_BATCH):
        raise AssertionError(f"{TPN_YAML} is not the TPN-R50 this phase "
                             "drives")
    model = build_model(cfg.model)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    engine = InferenceEngine(model, FRAMES, WINDOW_BATCH, device="cuda")
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
    want.update(shift_matmul=10 * forwards, fused_bottleneck=6 * forwards)
    if launches != want:
        raise AssertionError(f"TPN launch counts {launches} != {want}")
    if logits.shape != (len(starts), NUM_CLASS) or not np.isfinite(logits).all():
        raise AssertionError(f"bad TPN logits: shape {logits.shape}")
    clips_per_s = len(starts) / seconds
    log(f"    score_video: {len(starts)} windows in {seconds:.4f} s = "
        f"{clips_per_s:.2f} clips/s on {card}")
    log(f"    count_by_video_model: count={count} reps={reps}")
    ref_cfg = cfg.model.clone()
    ref_cfg.dtype = "float32"
    ref_model = build_model(ref_cfg, use_kernels=False)
    load_flax_variables(ref_model, variables)
    ref_engine = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH,
                                 device="cuda")
    _, ref = ref_engine.score_video(video, step=8, stride=2)
    logit_rule(np, logits, ref, "TPN-R50")
    count_check(np, torch, engine, ref_engine, video, "TPN-R50")
    del ref_model, ref_engine
    torch.cuda.empty_cache()

    # export: the artifact launches the live engine's kernels, scores as it
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-tpn-", dir=repo))
    try:
        t0 = time.perf_counter()
        path = export_model(model, str(tmp / "tpn"),
                            (WINDOW_BATCH, FRAMES, SIZE, SIZE, 3),
                            device="cuda")
        export_s = time.perf_counter() - t0
        art = InferenceEngine.from_exported(path, device="cuda")
        batch = engine.gather_windows(video, starts, stride=2)
        scored, counts = [], []
        for e in (engine, art):
            e.score_windows(batch)
            torch.cuda.synchronize()
            kernels.reset_launches()
            scored.append(e.score_windows(batch))
            torch.cuda.synchronize()
            counts.append({k: v for k, v in kernels.launch_counts().items()
                           if v})
        art_err = float(np.abs(scored[1] - scored[0]).max())
        same = bool((scored[1].argmax(1) == scored[0].argmax(1)).all())
        n_fwd = math.ceil(len(batch) / WINDOW_BATCH)
        log(f"    export: {export_s:.2f} s, "
            f"{Path(path).stat().st_size / 2**20:.1f} MB; launches live "
            f"{counts[0]}, artifact {counts[1]} on {len(batch)} windows; max "
            f"|logit diff| vs the live engine {art_err:.6f}, argmax equal "
            f"{same}")
        if counts[0] != counts[1] or counts[1] != {
                "shift_matmul": 10 * n_fwd, "fused_bottleneck": 6 * n_fwd}:
            raise AssertionError(f"TPN artifact launches {counts}")
        logit_rule(np, scored[1], scored[0], "TPN artifact vs the live engine")
        if not same:
            raise AssertionError("the TPN artifact changed an argmax")
        del art
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del engine
    torch.cuda.empty_cache()

    # training: tpn.yaml's optimizer at batch 32 on one DebugDataset batch
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    ds = DebugDataset(NUM_CLASS, FRAMES, TRAIN_BATCH, SIZE)
    x_u8 = np.stack([ds[i][0] for i in range(TRAIN_BATCH)])
    y = np.array([ds[i][1] for i in range(TRAIN_BATCH)])
    torch.cuda.synchronize()
    kernels.reset_launches()
    losses = [float(trainer.train_step(state, x_u8, y)["loss"])
              for _ in range(TPN_TRAIN_STEPS)]
    torch.cuda.synchronize()
    train_launches = kernels.launch_counts()
    want = {name: 0 for name in train_launches}
    want.update(conv1x1_dx=33 * TPN_TRAIN_STEPS,
                conv1x1_dw=33 * TPN_TRAIN_STEPS,
                shift_matmul=16 * TPN_TRAIN_STEPS)
    log(f"    {TPN_TRAIN_STEPS} train steps: losses "
        f"{[round(v, 4) for v in losses]}, launches={train_launches}")
    if train_launches != want:
        raise AssertionError(f"TPN training launches {train_launches} != "
                             f"{want}")
    if not np.isfinite(losses).all():
        raise AssertionError("TPN training gave a non-finite loss")
    model = state.model
    with torch.no_grad():  # the aux term: the step's loss less the main CE
        x = normalize_clip(torch.from_numpy(x_u8).cuda())
        yt = torch.from_numpy(y).cuda()
        out = model(x, dropout_generator=trainer.dropout_generator(0))
        total, main_logits = train_loss(out, yt, cfg.model.aux_loss_weight)
        aux_term = float(total - cross_entropy(main_logits, yt).mean())
    log(f"    train-mode forward: (logits, aux logits) "
        f"{isinstance(out, tuple)}; loss {float(total):.4f} of which the aux "
        f"term {aux_term:.4f} (weight {cfg.model.aux_loss_weight})")
    if not isinstance(out, tuple) or not aux_term > 0 or \
            not math.isfinite(float(total)):
        raise AssertionError("the TPN loss lacks a finite aux term")
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        trainer.train_step(state, x_u8, y)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    train_clips_s = TRAIN_BATCH / step_s
    log(f"    train step {step_s * 1e3:.2f} ms = {train_clips_s:.2f} clips/s "
        f"at batch {TRAIN_BATCH} on {card}")
    idle, busy = profile_call(
        torch, lambda: trainer.train_step(state, x_u8, y), top=12)
    del trainer, state, model
    torch.cuda.empty_cache()
    grad_check(np, torch, build_model, load_flax_variables, cfg, variables,
               TRAIN_BATCH, shift_faults())
    log(f"    phase [12]: {time.perf_counter() - phase_t0:.1f} s")
    return {"clips_per_s": clips_per_s, "train_clips_per_s": train_clips_s,
            "train_step_ms": step_s * 1e3, "train_step_busy_ms": busy,
            "train_step_idle_share": idle, "count": count,
            "export_s": export_s, "artifact_max_abs_diff": art_err,
            "forward_launches": {"shift_matmul": 10, "fused_bottleneck": 6},
            "step_launches": {"shift_matmul": 16, "conv1x1_dx": 33,
                              "conv1x1_dw": 33}}


def burst_windows(np, video, n: int):
    """n rank-6 TDN windows (n, 8, 5, H, W, 3) cut from a decoded video:
    window k is the 40 consecutive frames from 16·k, as 8 bursts of 5."""
    return np.stack([video[16 * k:16 * k + FRAMES * BURST]
                     .reshape(FRAMES, BURST, *video.shape[1:])
                     for k in range(n)])


def tdn_phase(np, torch, kernels, video, repo: Path, card: str) -> dict:
    """Phase 13: TDN-R50 inference, export and training from TDNDataset
    on the card. Returns the phase's numbers."""
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data import datasets
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (build_model,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer
    from workoutdetector_tpu_torch.utils.export import export_model

    phase_t0 = time.perf_counter()
    cfg = load_config(str(repo / TDN_YAML))
    if (cfg.model.model_type, cfg.model.base_model, cfg.model.dtype,
            cfg.model.num_class, cfg.data.batch_size) != \
            ("tdn", "resnet50", "bfloat16", NUM_CLASS, TDN_BATCH):
        raise AssertionError(f"{TDN_YAML} is not the TDN-R50 this phase "
                             "drives")
    model = build_model(cfg.model)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    engine = InferenceEngine(model, FRAMES, WINDOW_BATCH, device="cuda",
                             input_rank=6)
    windows = burst_windows(np, video, WINDOW_BATCH)
    engine.score_windows(windows)  # warm-up (cuDNN plans)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    logits = engine.score_windows(windows)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    clips_per_s = len(windows) / seconds
    log(f"    score_windows: {len(windows)} burst windows "
        f"{windows.shape[1:]} in {seconds:.4f} s = {clips_per_s:.2f} clips/s "
        f"on {card}; launches={launches}")
    if any(launches.values()):
        raise AssertionError(f"TDN launched hand kernels: {launches}")
    if logits.shape != (len(windows), NUM_CLASS) or \
            not np.isfinite(logits).all():
        raise AssertionError(f"bad TDN logits: shape {logits.shape}")
    try:
        engine.score_video(video)
    except ValueError as exc:
        log(f"    score_video on the rank-6 engine: ValueError ({exc})")
    else:
        raise AssertionError("a rank-6 engine scored a video")
    ref_cfg = cfg.model.clone()
    ref_cfg.dtype = "float32"
    ref_model = build_model(ref_cfg, use_kernels=False)
    load_flax_variables(ref_model, variables)
    ref = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH, device="cuda",
                          input_rank=6).score_windows(windows)
    logit_rule(np, logits, ref, "TDN-R50")
    del ref_model
    torch.cuda.empty_cache()

    tmp = Path(tempfile.mkdtemp(prefix=".smoke-tdn-", dir=repo))
    try:
        t0 = time.perf_counter()
        path = export_model(model, str(tmp / "tdn"),
                            (WINDOW_BATCH, FRAMES, BURST, SIZE, SIZE, 3),
                            device="cuda")
        export_s = time.perf_counter() - t0
        art = InferenceEngine.from_exported(path, device="cuda")
        art.score_windows(windows)
        torch.cuda.synchronize()
        kernels.reset_launches()
        art_logits = art.score_windows(windows)
        torch.cuda.synchronize()
        art_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        art_err = float(np.abs(art_logits - logits).max())
        same = bool((art_logits.argmax(1) == logits.argmax(1)).all())
        log(f"    export: {export_s:.2f} s, "
            f"{Path(path).stat().st_size / 2**20:.1f} MB, input rank "
            f"{art.input_rank}; launches {art_launches}; max |logit diff| vs "
            f"the live engine {art_err:.6f}, argmax equal {same}")
        if art.input_rank != 6 or art_launches:
            raise AssertionError("the TDN artifact is not a rank-6 graph of "
                                 "plain ops")
        logit_rule(np, art_logits, logits, "TDN artifact vs the live engine")
        if not same:
            raise AssertionError("the TDN artifact changed an argmax")
        del art, engine, model
        torch.cuda.empty_cache()

        # training from TDNDataset bursts over phase 10's rawframe corpus
        t0 = time.perf_counter()
        corpus = tmp / "corpus"
        videos, jpegs = write_file_corpus(np, corpus)
        binary = corpus / "Binary"
        log(f"    corpus: {videos} videos, {jpegs} JPEGs in "
            f"{time.perf_counter() - t0:.2f} s")
        tcfg = load_config(str(repo / TDN_YAML), [
            f"data.data_root={corpus}",
            f"data.train.anno={binary / 'all-train.txt'}",
            f"data.val.anno={binary / 'all-val.txt'}",
            f"data.test.anno={binary / 'all-val.txt'}",
            f"trainer.default_root_dir={tmp / 'runs'}",
            "log.tensorboard_enable=false"])
        trainer = Trainer(tcfg, device="cuda")
        loader = trainer._loader("train", shuffle=True)
        if type(loader.dataset) is not datasets.TDNDataset:
            raise AssertionError("tdn.yaml did not build a TDNDataset")
        state = trainer.init_state(len(loader), variables)
        loader.set_epoch(0)
        batches = iter(loader)
        kernels.reset_launches()
        losses, shapes = [], set()
        t0 = t1 = time.perf_counter()
        for step in range(TDN_TRAIN_STEPS):
            x_u8, y = next(batches)
            shapes.add(x_u8.shape)
            losses.append(float(trainer.train_step(state, x_u8, y)["loss"]))
            if step == 0:
                t1 = time.perf_counter()  # the rest: steady loader and steps
        torch.cuda.synchronize()
        batches.close()
        train_s = time.perf_counter() - t1
        train_clips_s = (TDN_TRAIN_STEPS - 1) * TDN_BATCH / train_s
        train_launches = {k: v for k, v in kernels.launch_counts().items()
                          if v}
        log(f"    {TDN_TRAIN_STEPS} train steps from TDNDataset "
            f"(batches {sorted(shapes)}, {datasets.decoder_path(loader.dataset.transform)}) "
            f"in {time.perf_counter() - t0:.2f} s: losses "
            f"{[round(v, 4) for v in losses]}; launches {train_launches}; "
            f"steps 2-{TDN_TRAIN_STEPS} {train_clips_s:.2f} clips/s at batch "
            f"{TDN_BATCH} on {card}")
        if shapes != {(TDN_BATCH, FRAMES * BURST, SIZE, SIZE, 3)} or \
                not np.isfinite(losses).all() or train_launches:
            raise AssertionError("TDN training from TDNDataset failed")
        del trainer, state, loader
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    log(f"    phase [13]: {time.perf_counter() - phase_t0:.1f} s")
    return {"clips_per_s": clips_per_s, "train_clips_per_s": train_clips_s,
            "losses": losses, "export_s": export_s,
            "artifact_max_abs_diff": art_err, "launches": 0}


# ---------------------------------------------------------------- phase 14
LIT_IMG_YAML = "workoutdetector_tpu/configs/lit_img.yaml"
IMAGE_BATCH = 64        # lit_img.yaml's batch
IMAGE_CLASSES = 2       # lit_img.yaml's num_class
IMAGE_TRAIN_STEPS = 3
IMAGE_VAL = 32          # validation images: one forward
COUNTER_SIZE = 48       # the crop of the counters held to the CPU ([14d])
OTHER_BACKBONES = ("convnext_base", "vit_base_patch16_224")


def image_faults() -> dict:
    """backward_order_check's planted faults of the unshifted 1×1 backward
    (``Conv1x1.backward`` calls the conv1x1 module's wrappers): dx from
    the other half of the batch's output gradient, dW over the other half's
    input rows (image i's rows paired with image j's)."""
    from workoutdetector_tpu_torch.ops.kernels import conv1x1 as c1

    def other_half(real):  # the wrapper on its first operand rolled by R/2
        def fault(a, b, *rest):
            return real(a.roll(a.shape[0] // 2, 0), b, *rest)
        fault.launches = 0  # the real wrapper counts on its module's name
        return fault

    return {"dx from the other half's g": (c1, "conv1x1_dx", other_half),
            "dW over the other half's x": (c1, "conv1x1_dw", other_half)}


def backward_order_check(np, torch, build_model, load_flax_variables, cfg,
                         variables, batch: int, faults: dict) -> dict:
    """The image train step's gradients with the forward held fixed.

    lit_img.yaml trains every BatchNorm on batch statistics, and a
    random ResNet-50 in that regime is chaotic in its forward: a bf16
    rounding anywhere moves the gradients of most leaves by 0.3-1.5
    relative (the bf16 plain path against the fp32 one, a CPU
    measurement at 64-224 px), so grad_check's comparison with the fp32
    path cannot tell a fault from rounding. Here the forward is the same
    in every run (the kernel path's, bf16, one generator seed); what
    changes is the 1×1 backward: the kernels (``got``), their plain
    versions (fp32 sums, one bf16 rounding: ``ref``) and the plain
    versions summed in float64 (``alt``: the spread of summation order
    alone). Per leaf e = ‖g − g_ref‖ / ‖g_ref‖ must stay within
    GRAD_RATIO × e_alt + GRAD_FLOOR; each planted fault (``faults`` as in
    grad_check) must put some leaf beyond it. Returns the largest e and
    e_alt."""
    from workoutdetector_tpu_torch.ops.kernels import conv1x1 as c1
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip
    from workoutdetector_tpu_torch.train.trainer import train_loss

    rng = np.random.default_rng(5)
    x = normalize_clip(torch.from_numpy(rng.integers(
        0, 256, (batch, 1, SIZE, SIZE, 3), dtype=np.uint8)).cuda())
    yt = torch.from_numpy(rng.integers(0, cfg.model.num_class, batch)).cuda()

    def counted(fn):
        def wrapper(*a):
            return fn(*a)
        wrapper.launches = 0
        return wrapper

    plain = {"conv1x1_dx": counted(c1.conv1x1_dx_plain),
             "conv1x1_dw": counted(c1.conv1x1_dw_plain)}
    wide = {"conv1x1_dx": counted(lambda g, wt, *a: (
                g.double() @ wt.double()).to(g.dtype)),
            "conv1x1_dw": counted(lambda a, g, *r: (
                a.double().t() @ g.double()).float())}

    def grads(swap):
        real = {n: getattr(c1, n) for n in swap}
        for n, fn in swap.items():
            setattr(c1, n, fn)
        try:
            model = build_model(cfg.model).cuda()
            load_flax_variables(model, variables)
            model.train()
            loss, _ = train_loss(model(x), yt, cfg.model.aux_loss_weight)
            loss.backward()
            out = {n: p.grad.float().clone()
                   for n, p in model.named_parameters()}
        finally:
            for n, fn in real.items():
                setattr(c1, n, fn)
        del model, loss
        torch.cuda.empty_cache()
        return out

    ref, alt, got = grads(plain), grads(wide), grads({})

    def rel(a):
        return {n: float((a[n] - ref[n]).norm()
                         / ref[n].norm().clamp(min=1e-30)) for n in ref}

    err, spread = rel(got), rel(alt)

    def beyond(e):
        return [n for n in e if not math.isfinite(e[n])
                or e[n] > GRAD_RATIO * spread[n] + GRAD_FLOOR]

    worst = sorted(err, key=err.get, reverse=True)[:3]
    log(f"    backward check, forward fixed ({len(ref)} leaves): kernels vs "
        f"plain max rel err {max(err.values()):.5f}, float64-summed plain "
        f"{max(spread.values()):.5f}; worst "
        + ", ".join(f"{n} {err[n]:.5f}/{spread[n]:.5f}" for n in worst))
    if beyond(err):
        raise AssertionError(f"gradients of {beyond(err)[:5]} beyond "
                             f"{GRAD_RATIO} x the summation-order spread + "
                             f"{GRAD_FLOOR}")
    for label, (module, name, make) in faults.items():
        e = rel(grads({name: make(getattr(module, name))}))
        caught = beyond(e)
        log(f"    planted fault '{label}': max rel err {max(e.values()):.5f}, "
            f"{len(caught)}/{len(e)} leaves beyond the limit")
        if not caught:
            raise AssertionError(f"the backward check misses the planted "
                                 f"fault '{label}'")
    return {"max_rel_err": max(err.values()),
            "order_spread": max(spread.values())}


def image_count_rule(np, logits, ref, err: float, what: str):
    """count_by_image_model's pipeline on per-frame logits (argmax, the
    7-deep majority vote, pred_to_count at step 7): the argmax equals the
    fp32 path's on every frame whose fp32 top-2 margin exceeds 2 x err and
    the counts are equal. Returns the two counts."""
    from workoutdetector_tpu_torch.counting import (majority_vote_states,
                                                    pred_to_count)
    decided = np.abs(ref[:, 1] - ref[:, 0]) > 2 * err
    wrong = np.flatnonzero(decided & (logits.argmax(1) != ref.argmax(1)))
    count = pred_to_count(majority_vote_states(logits.argmax(1)), step=7)[0]
    ref_count = pred_to_count(majority_vote_states(ref.argmax(1)), step=7)[0]
    if len(wrong) or count != ref_count:
        raise AssertionError(
            f"{what}: argmax differs on decided frames {wrong.tolist()[:8]}, "
            f"count {count} vs the fp32 path's {ref_count}")
    return count, ref_count


def write_image_corpus(np, root: Path, n: int):
    """``n`` JPEGs at 320×240 through cv2.imwrite (8 threads) and the
    ImageDataset lists ``train.txt`` (all but IMAGE_VAL) and ``val.txt``:
    a figure high (label 1) or low (label 0) over a per-image background,
    with noise. Returns the two list paths."""
    from concurrent.futures import ThreadPoolExecutor

    import cv2
    rng = np.random.default_rng(3)
    writes, lines = [], []
    for i in range(n):
        label = i % 2
        img = np.empty((FILE_H, FILE_W, 3), np.int16)
        img[:] = rng.integers(40, 110, size=3)
        top, x0 = (20 if label else 130), int(rng.integers(8, FILE_W - 88))
        img[top:top + 90, x0:x0 + 80] = (200, 180, 90)
        img += rng.integers(-12, 13, size=img.shape, dtype=np.int16)
        writes.append((str(root / f"img{i:04d}.jpg"),
                       np.clip(img, 0, 255).astype(np.uint8)))
        lines.append(f"img{i:04d}.jpg {label}")
    with ThreadPoolExecutor(8) as pool:
        if not all(pool.map(lambda pf: cv2.imwrite(*pf), writes)):
            raise AssertionError("cv2.imwrite failed on the image corpus")
    train, val = root / "train.txt", root / "val.txt"
    train.write_text("\n".join(lines[:-IMAGE_VAL]) + "\n")
    val.write_text("\n".join(lines[-IMAGE_VAL:]) + "\n")
    return train, val


def image_phase(np, torch, kernels, repo: Path, card: str) -> dict:
    """Phase 14: the image models through the port's entry points.
    [14a] lit_img.yaml's ResNet-50 image classifier (224², bf16, 2
    classes, the brightness head) from a port checkpoint through
    ``engine_from_checkpoint``: ``score_images`` on phase 11's 291-frame
    video (fused-bottleneck launches, the logit rule against the fp32 plain
    path, images/s, one profiled batch), ``count_by_image_model`` on its
    mp4 against the fp32 plain engine's, a planted swap caught;
    [14e] its ``.pt2`` through ``scripts/export_model`` (launches, logits
    and count as the live engine's); [14b] lit_img.yaml's training from
    ``ImageDataset`` over written JPEGs (``Trainer.fit``, dx/dW launches,
    finite losses, ``backward_order_check`` with two planted faults, train
    images/s);
    [14c] ConvNeXt-B and ViT-B/16 at 224² (logits against fp32 plain,
    images/s, one finite train step each, no hand kernel); [14d] the
    counters on phase 9's corpus, card against CPU: ``eval_dataset`` in
    ``motion``, ``similarity`` and ``image`` mode at COUNTER_SIZE, and the
    similarity's lag profile with TF32 on. Returns the phase's numbers."""
    import copy
    import csv
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data import datasets
    from workoutdetector_tpu_torch.data.video import VideoReader, write_video
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_image_model,
                                                 engine_from_checkpoint,
                                                 eval_dataset)
    from workoutdetector_tpu_torch.infer.inference_count import \
        similarity_engine
    from workoutdetector_tpu_torch.models import (build_model,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.scripts import export_model as export_cli
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager
    from workoutdetector_tpu_torch.train.trainer import Trainer
    from workoutdetector_tpu_torch.utils import similarity

    phase_t0 = time.perf_counter()
    yaml = str(repo / LIT_IMG_YAML)
    cfg = load_config(yaml)
    m = cfg.model
    if (m.model_type, m.base_model, m.dtype, m.num_class,
            cfg.data.batch_size, cfg.optimizer.method) != \
            ("image", "resnet50", "bfloat16", IMAGE_CLASSES, IMAGE_BATCH,
             "adamw"):
        raise AssertionError(f"{LIT_IMG_YAML} is not the image ResNet-50 "
                             "this phase drives")
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-image-", dir=repo))
    try:
        # [14a] inference and the image counter
        model = build_model(cfg.model)
        variables = random_flax_variables(model, seed=0)
        load_flax_variables(model, variables)
        ref_cfg = cfg.model.clone()
        ref_cfg.dtype = "float32"
        ref_model = build_model(ref_cfg, use_kernels=False)
        load_flax_variables(ref_model, variables)
        frames, reps = sweep_frames(np, np.random.default_rng(11), "squat",
                                    SERVE_REPS)  # phase 11's video
        mp4 = str(tmp / "squat.mp4")
        write_video(mp4, frames, 30.0)
        with VideoReader(mp4) as r:
            video = r.read_prepped(256, SIZE)
        brightness_head(np, torch, model, ref_model, video,
                        head=lambda mm: mm.backbone_img.fc)
        ckpt = CheckpointManager(str(tmp / "ckpt")).save(
            {"model": model.state_dict()}, name="best")
        engine = engine_from_checkpoint(cfg, ckpt, image_size=SIZE,
                                        window_batch=WINDOW_BATCH)
        ref_engine = InferenceEngine(ref_model, window_batch=WINDOW_BATCH,
                                     image_size=SIZE, device="cuda",
                                     input_rank=4)
        if engine.input_rank != 4:
            raise AssertionError("an image config gave a rank-"
                                 f"{engine.input_rank} engine")
        engine.score_images(video[:WINDOW_BATCH])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        logits = engine.score_images(video)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = kernels.launch_counts()
        forwards = math.ceil(len(video) / WINDOW_BATCH)
        want = dict({k: 0 for k in launches}, fused_bottleneck=6 * forwards)
        images_s = len(video) / seconds
        log(f"    [14a] score_images: {len(video)} images in {forwards} "
            f"forwards, {seconds:.4f} s = {images_s:.2f} images/s on {card}; "
            f"launches {({k: v for k, v in launches.items() if v})} "
            f"({launches['fused_bottleneck'] / forwards:g} fused_bottleneck "
            "a forward, fold 0, n_segment 1)")
        if launches != want:
            raise AssertionError(f"image launches {launches} != {want}")
        if logits.shape != (len(video), IMAGE_CLASSES) or \
                not np.isfinite(logits).all():
            raise AssertionError(f"bad image logits: shape {logits.shape}")
        idle, busy = profile_call(torch, lambda: engine.score_images(
            video[:WINDOW_BATCH]))
        ref = ref_engine.score_images(video)
        logit_rule(np, logits, ref, "image ResNet-50")
        err = float(np.abs(logits - ref).max())
        counts = image_count_rule(np, logits, ref, err, "image ResNet-50")
        kernels.reset_launches()
        count, got_reps = count_by_image_model(engine, mp4)
        count_launches = kernels.launch_counts()["fused_bottleneck"]
        ref_count, ref_reps = count_by_image_model(ref_engine, mp4)
        log(f"    count_by_image_model: {count} (reps {got_reps[:6]}...), "
            f"fp32 plain {ref_count}, the video's {SERVE_REPS}; "
            f"{count_launches} fused launches; per-frame rule {counts}")
        if (count, got_reps) != (ref_count, ref_reps) or count < 2 or \
                count_launches != 6 * forwards:
            raise AssertionError("the image counter disagrees with the fp32 "
                                 "plain path")
        dark = int(np.flatnonzero(np.abs(ref[:, 1] - ref[:, 0]) > 2 * err)[0])
        other = int(np.flatnonzero((ref.argmax(1) != ref[dark].argmax()) & (
            np.abs(ref[:, 1] - ref[:, 0]) > 2 * err))[0])
        planted = logits.copy()
        planted[[dark, other]] = planted[[other, dark]]
        try:
            image_count_rule(np, planted, ref, err, "planted")
        except AssertionError as exc:
            log(f"    planted swap of frames {dark} and {other}: caught ({exc})")
        else:
            raise AssertionError("the image count rule misses a planted swap")
        out.update(images_per_s=images_s, forwards=forwards,
                   fused_per_forward=launches["fused_bottleneck"] / forwards,
                   fused_launches=launches["fused_bottleneck"],
                   logit_max_abs_diff=err, count=count, ref_count=ref_count,
                   idle_share=idle, busy_ms=busy)

        # [14e] export: the .pt2 of the checkpoint, its launches and logits
        t0 = time.perf_counter()
        export_cli.main(["--cfg", yaml, "--checkpoint", ckpt, "-o",
                         str(tmp / "img"), "--batch", str(WINDOW_BATCH)])
        export_s = time.perf_counter() - t0
        art = engine_from_checkpoint(cfg, str(tmp / "img.pt2"))
        art.score_images(video[:WINDOW_BATCH])
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        art_logits = art.score_images(video)
        torch.cuda.synchronize()
        art_s = len(video) / (time.perf_counter() - t0)
        art_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        art_err = float(np.abs(art_logits - logits).max())
        same = bool((art_logits.argmax(1) == logits.argmax(1)).all())
        art_count = count_by_image_model(art, mp4)
        log(f"    [14e] export {export_s:.2f} s, "
            f"{(tmp / 'img.pt2').stat().st_size / 2**20:.1f} MB, rank "
            f"{art.input_rank}: launches {art_launches}, max |logit diff| vs "
            f"live {art_err:.6f}, argmax equal {same}, count {art_count[0]}; "
            f"{art_s:.2f} images/s")
        if art.input_rank != 4 or \
                art_launches != {"fused_bottleneck": 6 * forwards} or \
                not same or art_count != (count, got_reps):
            raise AssertionError("the image artifact differs from the live "
                                 "engine")
        logit_rule(np, art_logits, logits, "image artifact vs the live engine")
        out.update(export_s=export_s, artifact_images_per_s=art_s,
                   artifact_max_abs_diff=art_err)
        del art, engine
        torch.cuda.empty_cache()

        # [14b] training from ImageDataset
        t0 = time.perf_counter()
        root = tmp / "images"
        root.mkdir()
        train_list, val_list = write_image_corpus(
            np, root, IMAGE_BATCH * IMAGE_TRAIN_STEPS + IMAGE_VAL)
        tcfg = load_config(yaml, [
            f"data.data_root={root}", f"data.train.anno={train_list}",
            f"data.val.anno={val_list}", f"data.test.anno={val_list}",
            f"trainer.max_steps={IMAGE_TRAIN_STEPS}",
            "trainer.log_every_n_steps=1", "log.tensorboard_enable=false",
            f"trainer.default_root_dir={tmp / 'runs'}",
            f"callbacks.modelcheckpoint.dirpath={tmp / 'train_ckpt'}"])
        trainer = Trainer(tcfg, device="cuda")
        if type(trainer._loader("val", False).dataset) is not \
                datasets.ImageDataset:
            raise AssertionError("lit_img.yaml did not build an ImageDataset")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t1 = time.perf_counter()
        state, history = trainer.fit(variables=variables)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t1
        fit_launches = {k: v for k, v in kernels.launch_counts().items() if v}
        want = {"conv1x1_dx": 33 * IMAGE_TRAIN_STEPS,
                "conv1x1_dw": 33 * IMAGE_TRAIN_STEPS, "fused_bottleneck": 6}
        runs = list((tmp / "runs").iterdir())
        with open(runs[0] / "csv" / "metrics.csv") as f:
            losses = [float(r["train/loss"]) for r in csv.DictReader(f)
                      if r.get("train/loss")]
        log(f"    [14b] fit: {state.step} steps at batch {IMAGE_BATCH} + 1 val "
            f"forward from ImageDataset "
            f"({datasets.decoder_path(trainer._loader('val', False).dataset.transform)}; "
            f"corpus written in {t1 - t0:.2f} s) in {fit_s:.2f} s; launches "
            f"{fit_launches} ({fit_launches.get('conv1x1_dx', 0) / max(state.step, 1):g} "
            f"dx + {fit_launches.get('conv1x1_dw', 0) / max(state.step, 1):g} dW a "
            f"step); losses {[round(v, 4) for v in losses]}; val {history}")
        if fit_launches != want or len(losses) != IMAGE_TRAIN_STEPS or \
                not np.isfinite(losses).all() or \
                not math.isfinite(history["val/loss"]):
            raise AssertionError(f"image training: launches {fit_launches} "
                                 f"!= {want} or a non-finite loss")
        batches = iter(trainer._loader("train", shuffle=True))
        x_u8, y = next(batches)
        batches.close()
        del trainer, state
        torch.cuda.empty_cache()
        out["backward_check"] = backward_order_check(
            np, torch, build_model, load_flax_variables, tcfg, variables,
            IMAGE_BATCH, image_faults())
        trainer = Trainer(tcfg, device="cuda")
        state = trainer.init_state(steps_per_epoch=10, variables=variables)
        trainer.train_step(state, x_u8, y)
        torch.cuda.synchronize()
        n = 5
        t1 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(state, x_u8, y)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / n
        train_s = IMAGE_BATCH / step_s
        log(f"    train step {step_s * 1e3:.2f} ms = {train_s:.2f} images/s "
            f"at batch {IMAGE_BATCH} on {card}")
        step_idle, step_busy = profile_call(
            torch, lambda: trainer.train_step(state, x_u8, y), top=8)
        out.update(train_images_per_s=train_s, train_step_ms=step_s * 1e3,
                   dx_per_step=33, dw_per_step=33,
                   dx_launches=fit_launches["conv1x1_dx"],
                   dw_launches=fit_launches["conv1x1_dw"], losses=losses,
                   step_idle_share=step_idle, step_busy_ms=step_busy)
        del trainer, state
        torch.cuda.empty_cache()

        # [14c] the other zoos: no hand kernel
        images = video[:4 * WINDOW_BATCH]
        xb = np.random.default_rng(4).integers(
            0, 256, (IMAGE_BATCH, 1, SIZE, SIZE, 3), dtype=np.uint8)
        yb = np.arange(IMAGE_BATCH) % IMAGE_CLASSES
        for base in OTHER_BACKBONES:
            bcfg = load_config(yaml, [f"model.base_model={base}"])
            bm = build_model(bcfg.model)
            bvars = random_flax_variables(bm, seed=0)
            load_flax_variables(bm, bvars)
            bref_cfg = bcfg.model.clone()
            bref_cfg.dtype = "float32"
            bref = build_model(bref_cfg, use_kernels=False)
            load_flax_variables(bref, bvars)
            beng = InferenceEngine(bm, window_batch=WINDOW_BATCH,
                                   image_size=SIZE, device="cuda",
                                   input_rank=4)
            beng.score_images(images[:WINDOW_BATCH])
            torch.cuda.synchronize()
            kernels.reset_launches()
            t1 = time.perf_counter()
            blogits = beng.score_images(images)
            torch.cuda.synchronize()
            b_s = len(images) / (time.perf_counter() - t1)
            blaunch = {k: v for k, v in kernels.launch_counts().items() if v}
            bref_logits = InferenceEngine(
                bref, window_batch=WINDOW_BATCH, image_size=SIZE,
                device="cuda", input_rank=4).score_images(images)
            log(f"    [14c] {base}: {len(images)} images {b_s:.2f} images/s "
                f"on {card}; launches {blaunch}")
            logit_rule(np, blogits, bref_logits, base)
            del beng, bref
            torch.cuda.empty_cache()
            btrainer = Trainer(bcfg, device="cuda")
            bstate = btrainer.init_state(steps_per_epoch=10, variables=bvars)
            loss = float(btrainer.train_step(bstate, xb, yb)["loss"])
            log(f"        one train step at batch {IMAGE_BATCH}: loss {loss:.4f}")
            if blaunch or not math.isfinite(loss):
                raise AssertionError(f"{base}: hand-kernel launches {blaunch} "
                                     f"or a non-finite loss {loss}")
            out[base] = {"images_per_s": b_s, "train_loss": loss,
                         "logit_max_abs_diff": float(
                             np.abs(blogits - bref_logits).max())}
            del btrainer, bstate, bm
            torch.cuda.empty_cache()

        # [14d] the counters on phase 9's corpus, card against CPU
        corpus = tmp / "sweep"
        write_sweep_corpus(np, corpus)
        kw = dict(action=["all"], split="test", data_root=str(corpus))

        def both(mode, card_engine, cpu_engine):
            res = {}
            for dev, eng in (("cuda", card_engine), ("cpu", cpu_engine)):
                t1 = time.perf_counter()
                counts_out = str(tmp / f"{mode}_{dev}.json")
                metrics = eval_dataset(eng, model_type=mode, device=dev,
                                       counts_out=counts_out, **kw)
                with open(counts_out) as f:
                    res[dev] = (metrics, json.load(f),
                                time.perf_counter() - t1)
            log(f"    [14d] eval_dataset {mode}: card {res['cuda'][0]} "
                f"{res['cuda'][1]} in {res['cuda'][2]:.2f} s; CPU "
                f"{res['cpu'][0]} {res['cpu'][1]} in {res['cpu'][2]:.2f} s")
            if res["cuda"][:2] != res["cpu"][:2]:
                raise AssertionError(f"{mode} counts on the card differ from "
                                     "the CPU's")
            return res["cuda"][1]

        out["motion_counts"] = both("motion", None, None)
        scfg = load_config(yaml, ["model.base_model=resnet18",
                                  f"data.image_size={COUNTER_SIZE}"])
        s_card, s_cpu = similarity_engine(scfg, "cuda"), \
            similarity_engine(scfg, "cpu")
        out["similarity_counts"] = both("similarity", s_card, s_cpu)
        feats = similarity.video_cnn_features(
            s_card, str(corpus / "videos" / "test" / "test0.mp4"))
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True  # the library's choice
        try:
            tf32 = float(np.abs(similarity.lag_profile(feats, "cuda")
                                - similarity.lag_profile(feats, "cpu")).max())
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
        log(f"    lag profile with TF32 matmuls allowed: max |card - CPU| "
            f"{tf32:.3g} (float64 in the function)")
        if tf32 > 1e-9:
            raise AssertionError("the similarity's precision follows the "
                                 "caller's TF32 setting")
        # the image counter at COUNTER_SIZE: the fp32 model on the card and
        # on the CPU (the kernel path's counts beside, as a report: [14a]
        # holds it to the fp32 path frame by frame), the head set anew at
        # that crop from the corpus's darkest and brightest frames
        small = []
        for p in sorted((corpus / "videos" / "test").iterdir()):
            with VideoReader(str(p)) as r:
                small.append(r.read_prepped(
                    round(COUNTER_SIZE * 256 / 224), COUNTER_SIZE))
        brightness_head(np, torch, model, ref_model, np.concatenate(small),
                        head=lambda mm: mm.backbone_img.fc)
        cpu_model = copy.deepcopy(ref_model).cpu()
        out["image_counts"] = both(
            "image",
            InferenceEngine(ref_model, window_batch=WINDOW_BATCH,
                            image_size=COUNTER_SIZE, device="cuda",
                            input_rank=4),
            InferenceEngine(cpu_model, window_batch=WINDOW_BATCH,
                            image_size=COUNTER_SIZE, device="cpu",
                            input_rank=4))
        kernel_engine = InferenceEngine(model, window_batch=WINDOW_BATCH,
                                        image_size=COUNTER_SIZE,
                                        device="cuda", input_rank=4)
        kernels.reset_launches()
        eval_dataset(kernel_engine, model_type="image",
                     counts_out=str(tmp / "image_kernels.json"), **kw)
        with open(tmp / "image_kernels.json") as f:
            out["image_counts_kernel_path"] = json.load(f)
        log(f"    the kernel path (bf16) at {COUNTER_SIZE}²: "
            f"{out['image_counts_kernel_path']}, "
            f"{kernels.launch_counts()['fused_bottleneck']} fused launches")
        out["tf32_lag_profile_max_abs_diff"] = tf32
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - phase_t0
    log(f"    phase [14]: {out['seconds']:.1f} s")
    return out


REPNET_YAML = "workoutdetector_tpu/configs/repnet.yaml"
REPNET_FRAMES = 480     # the periodic video's frames
REPNET_VIDEO = 128      # its side: the grid's 2x decode reads it whole
REPNET_PERIOD = 8       # its period, in frames: 60 reps
REPNET_TRAIN_STEPS = 4
PERIODIC_CLIENTS = 3
MOE_EXPERTS = 8
MOE_TRAIN_STEPS = 3


def periodic_head(np, torch, models, ref_logits, period: int) -> float:
    """The count check's head: RepNet's ``period_fc`` bias moved on every
    model in ``models`` alike. The fp32 path's mean frame logit comes off
    each class; class 0 (aperiodic) goes down by 200 more, so its
    probability underflows to 0 in fp32 and every frame reads periodic
    with probability exactly 1 on both paths (no rounding decides the 0.5
    threshold, nor the winning rate and view); the class of ``period``
    goes up by 2 x the largest deviation + 1 (its argmax decided by a
    margin wider than any bf16 error). Returns that boost."""
    flat = ref_logits.reshape(-1, ref_logits.shape[-1])
    center = flat.mean(0)
    boost = 2 * float(np.abs(flat - center).max()) + 1.0
    shift = -center.astype(np.float64)
    shift[0] -= 200.0
    shift[period - 1] += boost
    for m in models:
        fc = m.period_fc
        fc.bias.data = fc.bias.data + torch.from_numpy(shift).to(fc.bias)
    return boost


def repnet_phase(np, torch, kernels, repo: Path, card: str) -> dict:
    """Phase 15, RepNet-base (``repnet.yaml``: T 64, 64², bf16, the port's
    initializers from seed 0) through the port's entry points: [15a] the
    engine's per-frame logits on windows of a written periodic video
    (``synth_periodic_clip``, period REPNET_PERIOD) by the logit rule
    against the fp32 model, windows/s, one profiled batch; [15b]
    ``count_by_repnet`` with the grid, the bf16 count equal to the fp32
    path's and to the video's reps under ``periodic_head``; [15c] its
    ``.pt2`` through ``scripts/export_model`` (frame logits and count as
    the live engine's); [15d] ``StreamingPeriodicCounter`` over the video,
    card against CPU; [15e] a ``WorkoutServer`` with
    ``--repnet-checkpoint`` and PERIODIC_CLIENTS WebSocket clients in
    ``mode:count-periodic``, statuses equal to the direct streaming
    counter's; [15f] ``Trainer.fit`` from ``SyntheticPeriodic`` at batch
    32, loader-fed and in-memory train clips/s, the idle share. Returns
    the phase's numbers."""
    import asyncio
    import base64
    import csv
    import io
    import os
    import shutil
    import tempfile
    import threading

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data.datasets import synth_periodic_clip
    from workoutdetector_tpu_torch.data.video import VideoReader, write_video
    from workoutdetector_tpu_torch.infer import (InferenceEngine,
                                                 count_by_repnet,
                                                 engine_from_checkpoint)
    from workoutdetector_tpu_torch.infer.inference_count import \
        repnet_frame_logits_batch
    from workoutdetector_tpu_torch.infer.streaming import \
        StreamingPeriodicCounter
    from workoutdetector_tpu_torch.models import (build_model,
                                                  init_flax_variables,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.scripts import export_model as export_cli
    from workoutdetector_tpu_torch.serve import server
    from workoutdetector_tpu_torch.train.checkpoint import CheckpointManager
    from workoutdetector_tpu_torch.train.trainer import Trainer

    phase_t0 = time.perf_counter()
    yaml = str(repo / REPNET_YAML)
    cfg = load_config(yaml)
    m, d = cfg.model, cfg.data
    if (m.model_type, m.base_model, m.num_segments, m.dtype, d.image_size,
            d.batch_size, d.dataset_type) != ("repnet", "base", 64,
                                              "bfloat16", 64, 32,
                                              "SyntheticPeriodic"):
        raise AssertionError(f"{REPNET_YAML} is not the RepNet-base this "
                             "phase drives")
    t_win, size = m.num_segments, d.image_size
    reps = REPNET_FRAMES // REPNET_PERIOD
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-repnet-", dir=repo))
    srv = thread = None
    try:
        # [15a] the engine's per-frame logits
        clip = synth_periodic_clip(np.random.default_rng(15), REPNET_FRAMES,
                                   REPNET_VIDEO, period=REPNET_PERIOD,
                                   kind="translate")
        mp4 = str(tmp / "periodic.mp4")
        write_video(mp4, clip, 30.0)
        model = build_model(cfg.model)
        variables = init_flax_variables(model, seed=0)
        load_flax_variables(model, variables)
        ref_cfg = cfg.model.clone()
        ref_cfg.dtype = "float32"
        ref_model = build_model(ref_cfg, use_kernels=False)
        load_flax_variables(ref_model, variables)
        engine = InferenceEngine(model, t_win, WINDOW_BATCH, image_size=size,
                                 device="cuda")
        ref_engine = InferenceEngine(ref_model, t_win, WINDOW_BATCH,
                                     image_size=size, device="cuda")
        with VideoReader(mp4) as r:
            frames = r.read_prepped(round(size * 256 / 224), size)
        n = len(frames) // t_win
        windows = frames[:n * t_win].reshape(n, t_win, size, size, 3)
        batch = windows[np.arange(4 * WINDOW_BATCH) % n]
        score = repnet_frame_logits_batch(engine)
        score(batch[:WINDOW_BATCH])  # warm-up (cuDNN plans)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        fl = score(batch)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in kernels.launch_counts().items() if v}
        windows_s = len(batch) / seconds
        log(f"    [15a] video: {REPNET_FRAMES} frames {REPNET_VIDEO}², period "
            f"{REPNET_PERIOD} ({reps} reps), read at {size}²: {n} windows of "
            f"{t_win}; frame logits of {len(batch)} windows in {seconds:.4f} s "
            f"= {windows_s:.2f} windows/s at window batch {WINDOW_BATCH} on "
            f"{card}; hand-kernel launches {launches} (RepNet has none)")
        if launches or fl.shape != (len(batch), t_win, t_win // 2) or \
                not np.isfinite(fl).all():
            raise AssertionError(f"RepNet frame logits: shape {fl.shape}, "
                                 f"launches {launches}")
        idle, busy = profile_call(torch, lambda: score(batch[:WINDOW_BATCH]))
        ref_fl = repnet_frame_logits_batch(ref_engine)(windows)
        classes = t_win // 2
        logit_rule(np, fl[:n].reshape(-1, classes),
                   ref_fl.reshape(-1, classes), "RepNet frame logits")
        free = (count_by_repnet(engine, mp4, grid=True),
                count_by_repnet(ref_engine, mp4, grid=True))
        log(f"    the seed-0 model's own counts (a report): kernel path "
            f"{free[0]}, fp32 {free[1]} (count, period, strength)")
        out.update(windows_per_s=windows_s, idle_share=idle, busy_ms=busy,
                   frame_logit_max_abs_diff=float(np.abs(
                       fl[:n] - ref_fl).max()))

        # [15b] count_by_repnet with the grid under the count check's head
        boost = periodic_head(np, torch, [model, ref_model], ref_fl,
                              REPNET_PERIOD)
        got = count_by_repnet(engine, mp4, grid=True)
        want = count_by_repnet(ref_engine, mp4, grid=True)
        log(f"    [15b] count_by_repnet(grid=True) under the count check's "
            f"head (boost {boost:.3f}): kernel path {got}, fp32 {want}, the "
            f"video's ({reps}, {REPNET_PERIOD}, 1.0)")
        if got != want or got != (reps, REPNET_PERIOD, 1.0):
            raise AssertionError("the RepNet count differs from the fp32 "
                                 "path's or the video's reps")
        out.update(count=got[0], period=got[1])

        # [15c] the .pt2 of that model through scripts/export_model
        ckpt = CheckpointManager(str(tmp / "ckpt")).save(
            {"model": model.state_dict()}, name="repnet")
        t0 = time.perf_counter()
        export_cli.main(["--cfg", yaml, "--checkpoint", ckpt, "-o",
                         str(tmp / "repnet"), "--batch", str(WINDOW_BATCH)])
        export_s = time.perf_counter() - t0
        art_path = str(tmp / "repnet.pt2")
        art = engine_from_checkpoint(cfg, art_path)
        art_score = repnet_frame_logits_batch(art)
        art_score(batch[:WINDOW_BATCH])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        art_fl = art_score(batch)
        torch.cuda.synchronize()
        art_s = len(batch) / (time.perf_counter() - t0)
        live_fl = score(batch)
        art_err = float(np.abs(art_fl - live_fl).max())
        art_count = count_by_repnet(art, mp4, grid=True)
        log(f"    [15c] export {export_s:.2f} s, "
            f"{Path(art_path).stat().st_size / 2**20:.1f} MB, sidecar "
            f"model_type {art.meta.get('model_type')} num_class "
            f"{art.num_class}: frame logits {art_fl.shape}, max |diff| vs "
            f"live {art_err:.6f}, count {art_count}; {art_s:.2f} windows/s "
            f"(live {windows_s:.2f})")
        if art.meta.get("model_type") != "repnet" or \
                art.num_class != classes or art_count != got:
            raise AssertionError("the RepNet artifact differs from the live "
                                 "engine")
        logit_rule(np, art_fl.reshape(-1, classes),
                   live_fl.reshape(-1, classes),
                   "RepNet artifact vs the live engine")
        out.update(export_s=export_s, artifact_windows_per_s=art_s,
                   artifact_max_abs_diff=art_err)

        # [15d] the streaming counter, card against CPU
        cpu_cfg = load_config(yaml, ["model.dtype=float32"])
        cpu = engine_from_checkpoint(cpu_cfg, ckpt, image_size=size,
                                     window_batch=1, device="cpu")
        on_card, on_cpu = StreamingPeriodicCounter(engine), \
            StreamingPeriodicCounter(cpu)
        t0 = time.perf_counter()
        card_status = [s for s in map(on_card.push, clip) if s is not None]
        stream_s = time.perf_counter() - t0
        cpu_status = [s for s in map(on_cpu.push, clip) if s is not None]
        log(f"    [15d] StreamingPeriodicCounter (hop {on_card.hop}): "
            f"{len(card_status)} statuses on the card in {stream_s:.3f} s, "
            f"final {card_status[-1]}; CPU (fp32) final {cpu_status[-1]}; "
            f"equal {card_status == cpu_status}")
        if card_status != cpu_status or card_status[-1]["count"] != reps:
            raise AssertionError("the streaming counter on the card differs "
                                 "from the CPU's or the video's reps")

        # [15e] the server's count-periodic mode over the artifact
        found = {}
        for mod in ("websockets", "PIL"):
            try:
                found[mod] = importlib.import_module(mod).__version__
            except ImportError as exc:
                found[mod] = f"missing ({exc})"
        have_ws = not found["websockets"].startswith("missing")

        def jpeg(frame):
            if not found["PIL"].startswith("missing"):
                from PIL import Image
                buf = io.BytesIO()
                Image.fromarray(frame).save(buf, format="JPEG")
                return buf.getvalue()
            import cv2
            return cv2.imencode(".jpg", frame[..., ::-1])[1].tobytes()

        urls = ["data:image/jpeg;base64," + base64.b64encode(
            jpeg(f)).decode() for f in clip]
        direct = StreamingPeriodicCounter(art)
        want_status = [s for s in (direct.push(server.decode_data_url(u))
                                   for u in urls) if s is not None]
        port = free_port()
        srv = server.build_server(["--cfg", str(repo / TSM_YAML), "--port",
                                   str(port), "--repnet-checkpoint",
                                   art_path])
        srv.host, srv.ws_port = "127.0.0.1", free_port()
        thread = start_server(srv, threading, have_ws)
        code, health = http_json(f"http://127.0.0.1:{port}/healthz")

        async def client():
            async with ws_connect(asyncio, srv, srv.ws_port, have_ws) as ws:
                await ws.send("mode:count-periodic")
                for url in urls:
                    await ws.send(url)
                got = [json.loads(await asyncio.wait_for(ws.recv(), 120))
                       for _ in want_status]
                await ws.send("stop")
            return got

        async def clients():
            return await asyncio.gather(*[client() for _ in
                                          range(PERIODIC_CLIENTS)])

        t0 = time.perf_counter()
        served = asyncio.run(clients())
        serve_s = time.perf_counter() - t0
        code, stats = http_json(f"http://127.0.0.1:{port}/stats")
        pb = stats.get("periodic_batcher") or {}
        log(f"    [15e] server.build_server(--repnet-checkpoint): /healthz "
            f"periodic {health.get('periodic')}; {PERIODIC_CLIENTS} "
            f"count-periodic clients x {len(urls)} frames in {serve_s:.3f} s; "
            f"final counts {[r[-1]['count'] for r in served]} (direct "
            f"{want_status[-1]['count']}); /stats periodic_batcher {pb}")
        strip = [[{k: v for k, v in r.items() if k not in ("success",
                                                            "mode")}
                  for r in rs] for rs in served]
        if health.get("periodic") is not True or \
                any(rs != want_status for rs in strip) or \
                pb.get("requests") != PERIODIC_CLIENTS * len(want_status):
            raise AssertionError("the served periodic counts differ from the "
                                 "direct streaming counter's")
        stop_server(srv, thread)
        srv = thread = None
        out.update(served_count=want_status[-1]["count"],
                   periodic_coalescing=pb.get("coalescing"),
                   serve_s=serve_s)
        del art, cpu, engine, ref_engine, model, ref_model
        torch.cuda.empty_cache()

        # [15f] training from SyntheticPeriodic at batch 32
        steps = REPNET_TRAIN_STEPS
        tcfg = load_config(yaml, [
            f"trainer.max_steps={steps}", "trainer.log_every_n_steps=1",
            f"data.debug_size={steps * d.batch_size}",
            "log.tensorboard_enable=false",
            f"trainer.default_root_dir={tmp / 'runs'}",
            f"callbacks.modelcheckpoint.dirpath={tmp / 'train_ckpt'}"])
        trainer = Trainer(tcfg, device="cuda")
        t0 = time.perf_counter()
        state, history = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        runs = [p for p in (tmp / "runs").iterdir()]
        with open(runs[0] / "csv" / "metrics.csv") as f:
            losses = [float(r["train/loss"]) for r in csv.DictReader(f)
                      if r.get("train/loss")]
        if len(losses) != steps or not np.isfinite(losses).all() or \
                not math.isfinite(history["val/loss"]):
            raise AssertionError("RepNet training gave a non-finite or "
                                 "missing loss")
        loader = iter(trainer._loader("train", shuffle=True))
        x_u8, y = next(loader)
        trainer.train_step(state, x_u8, y)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps - 1):
            trainer.train_step(state, *next(loader))
        torch.cuda.synchronize()
        fed_s = (steps - 1) * d.batch_size / (time.perf_counter() - t0)
        loader.close()
        t0 = time.perf_counter()
        for _ in range(5):
            trainer.train_step(state, x_u8, y)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / 5 * 1e3
        mem_s = d.batch_size / step_ms * 1e3

        def fed_steps():
            it = iter(trainer._loader("train", shuffle=True))
            for _ in range(3):
                trainer.train_step(state, *next(it))
            it.close()

        fed_idle, fed_busy = profile_call(torch, fed_steps, top=8)
        step_idle, step_busy = profile_call(
            torch, lambda: trainer.train_step(state, x_u8, y), top=8)
        log(f"    [15f] fit: {steps} steps + validation in {fit_s:.2f} s, "
            f"losses {[round(v, 4) for v in losses]}, val {history}; "
            f"loader-fed {fed_s:.2f} train clips/s (idle {fed_idle}); "
            f"one batch in memory {step_ms:.2f} ms = {mem_s:.2f} clips/s "
            f"(idle {step_idle}) at batch {d.batch_size} on {card}")
        out.update(train_clips_per_s=fed_s, train_idle_share=fed_idle,
                   train_busy_ms=fed_busy, step_ms=step_ms,
                   step_clips_per_s=mem_s, step_idle_share=step_idle,
                   losses=losses, fit_s=fit_s)
        del trainer, state
        torch.cuda.empty_cache()
    finally:
        if srv is not None:
            try:
                stop_server(srv, thread)
            except Exception:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - phase_t0
    return out


class RouteTape:
    """``MoEMlp.route`` recorded or replayed, to hold two paths to one
    routing: recording keeps each call's experts and slots; replaying
    hands each call the recorded ones in order (the gates still from the
    model's own router, so the gradient path is the model's)."""

    def __init__(self, replay=None):
        from workoutdetector_tpu_torch.models import moe
        self.cls = moe.MoEMlp
        self.replay = replay
        self.calls = []

    def __enter__(self):
        real = self.real = self.cls.route
        tape = self

        def route(mod, tokens):
            gates, expert, slot, cap = real(mod, tokens)
            if tape.replay is None:
                tape.calls.append((expert.detach(), slot.detach(), cap))
                return gates, expert, slot, cap
            e, s, c = tape.replay[len(tape.calls)]
            if e.shape != expert.shape:
                raise AssertionError("replayed routing of another shape")
            tape.calls.append((e, s, c))
            return gates, e, s, c

        self.cls.route = route
        return self

    def __exit__(self, *exc):
        self.cls.route = self.real


def moe_phase(np, torch, kernels, video, repo: Path, card: str,
              dense_clips_s: float, dense_train_clips_s: float) -> dict:
    """Phase 15, MoE TimeSformer-B/16 (``timesformer.yaml`` with
    ``model.moe_experts=8``: capacity 1.25, load-balance weight 0.01):
    [15g] inference on phase 4's video (12 attention launches a forward),
    logits by the logit rule against the fp32 plain model routed as the
    kernel path (``RouteTape``; a routing flip is a real difference, not a
    kernel fault), each block's dropped share and the share of tokens the
    two paths route apart when each routes freely; [15h] train steps at
    batch 16 (12 + 12 launches a step, finite losses, clips/s beside phase
    8's) and ``grad_check`` with one routing for its three runs and phase
    8's planted fault; [15i] ``MoEMlp`` alone on the card against the CPU
    on identical inputs: equal routing. Returns the phase's numbers."""
    from workoutdetector_tpu_torch.infer import InferenceEngine
    from workoutdetector_tpu_torch.models import (MoEMlp, build_model,
                                                  load_flax_variables)
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.train.trainer import Trainer

    phase_t0 = time.perf_counter()
    cfg = ts_train_config(repo, 0, 0, "unused",
                          [f"model.moe_experts={MOE_EXPERTS}"])
    m = cfg.model
    if (m.moe_experts, m.moe_capacity_factor, m.moe_aux_weight,
            cfg.data.batch_size) != (MOE_EXPERTS, 1.25, 0.01, TS_TRAIN_BATCH):
        raise AssertionError("the MoE configuration is not timesformer.yaml "
                             f"with {MOE_EXPERTS} experts")
    out = {}
    # [15g] inference
    model = build_model(cfg.model)
    variables = random_flax_variables(model, seed=0)
    load_flax_variables(model, variables)
    engine = InferenceEngine(model, FRAMES, WINDOW_BATCH, device="cuda")
    engine.score_video(video[:24], step=8, stride=2)  # warm-up
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    starts, logits = engine.score_video(video, step=8, stride=2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kernels.launch_counts()
    forwards = math.ceil(len(starts) / WINDOW_BATCH)
    want = dict({k: 0 for k in launches}, attention=TS_LAYERS * forwards)
    clips_s = len(starts) / seconds
    log(f"    [15g] MoE TimeSformer-B/16 ({MOE_EXPERTS} experts, capacity "
        f"{m.moe_capacity_factor}): score_video {len(starts)} windows in "
        f"{forwards} forwards, {seconds:.4f} s = {clips_s:.2f} clips/s on "
        f"{card} (dense, phase 7: {dense_clips_s:.2f}); launches "
        f"{({k: v for k, v in launches.items() if v})}")
    if launches != want or not np.isfinite(logits).all():
        raise AssertionError(f"MoE launches {launches} != {want}")
    idle, busy = profile_call(torch, lambda: engine.score_windows(
        engine.gather_windows(video, starts[:WINDOW_BATCH], stride=2)))
    ref_cfg = cfg.model.clone()
    ref_cfg.dtype = "float32"
    ref_model = build_model(ref_cfg, use_kernels=False)
    load_flax_variables(ref_model, variables)
    ref_engine = InferenceEngine(ref_model, FRAMES, WINDOW_BATCH,
                                 device="cuda", optimize=False)
    with RouteTape() as kernel_routes:
        engine.score_video(video, step=8, stride=2)
    with RouteTape(kernel_routes.calls):
        _, ref = ref_engine.score_video(video, step=8, stride=2)
    logit_rule(np, logits, ref, "MoE TimeSformer (one routing)")
    with RouteTape() as free_routes:
        _, ref_free = ref_engine.score_video(video, step=8, stride=2)
    calls = kernel_routes.calls
    flips = [float((a[0] != b[0]).float().mean())
             for a, b in zip(calls, free_routes.calls)]
    dropped = [float((s > c).float().mean()) for _, s, c in calls]
    per = 2 * TS_LAYERS  # calls a forward: cls tokens, patches per block
    drop_blocks = [float(np.mean(dropped[2 * b + 1::per]))
                   for b in range(TS_LAYERS)]
    flip_blocks = [float(np.mean(flips[2 * b + 1::per]))
                   for b in range(TS_LAYERS)]
    cls_flips = float(np.mean(flips[0::2]))
    free_err = float(np.abs(logits - ref_free).max())
    log(f"    dropped share of the patch tokens by block "
        f"{[round(v, 4) for v in drop_blocks]} (cls groups "
        f"{float(np.mean(dropped[0::2])):.4f}); tokens routed apart by the "
        f"bf16 kernel path and the fp32 path, each routing freely, by block "
        f"{[round(v, 4) for v in flip_blocks]} (cls {cls_flips:.4f}); max "
        f"|logit diff| against the freely routed fp32 path {free_err:.5f}")
    out.update(clips_per_s=clips_s, idle_share=idle, busy_ms=busy,
               forward_launches=TS_LAYERS,
               dropped_share=drop_blocks, routed_apart_share=flip_blocks,
               cls_routed_apart_share=cls_flips,
               free_routing_max_abs_diff=free_err,
               logit_max_abs_diff=float(np.abs(logits - ref).max()))
    del engine, ref_engine, model, ref_model
    torch.cuda.empty_cache()

    # [15h] train steps at batch 16 and the gradient check
    trainer = Trainer(cfg, device="cuda")
    state = trainer.init_state(steps_per_epoch=10, variables=variables)
    rng = np.random.default_rng(7)
    x_u8 = rng.integers(0, 256, (TS_TRAIN_BATCH, FRAMES, SIZE, SIZE, 3),
                        dtype=np.uint8)
    y = rng.integers(0, NUM_CLASS, TS_TRAIN_BATCH)
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, x_u8, y)  # first step: cuDNN plans, allocator
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    losses = [trainer.train_step(state, x_u8, y)["loss"]
              for _ in range(MOE_TRAIN_STEPS)]
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / MOE_TRAIN_STEPS
    launches = kernels.launch_counts()
    want = dict({k: 0 for k in launches},
                attention=TS_LAYERS * MOE_TRAIN_STEPS,
                attention_bwd=TS_LAYERS * MOE_TRAIN_STEPS)
    losses = [float(v) for v in losses]
    train_s = TS_TRAIN_BATCH / step_s
    log(f"    [15h] {MOE_TRAIN_STEPS} train steps at batch "
        f"{TS_TRAIN_BATCH}: {step_s * 1e3:.2f} ms = {train_s:.2f} clips/s on "
        f"{card} (dense, phase 8: {dense_train_clips_s:.2f}); losses "
        f"{[round(v, 4) for v in losses]}; launches "
        f"{({k: v for k, v in launches.items() if v})}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if launches != want or not np.isfinite(losses).all():
        raise AssertionError(f"MoE train launches {launches} != {want}")
    step_idle, step_busy = profile_call(
        torch, lambda: trainer.train_step(state, x_u8, y), top=12)
    out.update(train_clips_per_s=train_s, train_step_ms=step_s * 1e3,
               train_idle_share=step_idle, train_busy_ms=step_busy,
               step_launches={k: v // MOE_TRAIN_STEPS
                              for k, v in launches.items() if v},
               losses=losses)
    del trainer, state
    torch.cuda.empty_cache()

    def neighbour_head(real):  # the kernel reads the next head's dO
        def fault(q, k, v, o, lse, do, *rest, **kw):
            return real(q, k, v, o, lse, do.roll(1, dims=1), *rest, **kw)
        fault.launches = 0  # the wrapper counts on its module's name
        return fault

    ka = importlib.import_module("workoutdetector_tpu_torch.ops.kernels.attention")
    grad_check(np, torch, build_model, load_flax_variables, cfg, variables,
               TS_TRAIN_BATCH, {"dO of the neighbouring head":
                                (ka, "attention_bwd", neighbour_head)},
               shared_routes=True)

    # [15i] MoEMlp alone: the card against the CPU on identical inputs
    mlp = MoEMlp(768, 3072, MOE_EXPERTS, 1.25)
    load_flax_variables(mlp, random_flax_variables(mlp, seed=1))
    tokens = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (4096, 768)).astype(np.float32))
    res = []
    for dev in ("cpu", "cuda"):
        mm = mlp.to(dev)
        with torch.no_grad():
            _, expert, slot, cap = mm.route(tokens.to(dev))
            y_, loss_ = mm(tokens.to(dev))
        res.append((expert.cpu(), slot.cpu(), cap, y_.cpu(), float(loss_)))
    (e0, s0, cap, y0, l0), (e1, s1, _, y1, l1) = res
    mlp_err = float((y1 - y0).abs().max())
    same = bool(torch.equal(e0, e1) and torch.equal(s0, s1))
    xb = torch.randn(TS_TRAIN_BATCH * 196 * FRAMES, 768, device="cuda",
                     dtype=torch.bfloat16)

    def mlp_call():
        with torch.no_grad():
            mlp(xb)

    mlp_ms = time_ms(torch, mlp_call, 10)
    log(f"    [15i] MoEMlp (768 -> 3072, {MOE_EXPERTS} experts) on 4096 "
        f"tokens, fp32: routing on the card equal to the CPU's {same} "
        f"(dropped {float((s0 > cap).float().mean()):.4f}), max |y diff| "
        f"{mlp_err:.2e}, loss {l1:.6f} / {l0:.6f}; one bf16 call on the "
        f"{xb.shape[0]} patch tokens of a batch-16 block {mlp_ms:.3f} ms "
        f"on {card}")
    if not same or mlp_err > 1e-3 or abs(l1 - l0) > 1e-5:
        raise AssertionError("MoEMlp on the card differs from the CPU")
    out.update(mlp_routing_equal=same, mlp_max_abs_diff=mlp_err,
               mlp_ms=mlp_ms)
    del mlp, xb
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - phase_t0
    return out


PERSON_IMAGES = 96       # person_dataset / pose_dataset images at 128²
DETECTOR_STEPS = 150
DETECTOR_BATCH = 8
POSE_STEPS = 1000
POSE_BATCH = 16
PERSON_FRAMES = 40       # the clip the backends run: 3 batches of 16
PERSON_HW = (240, 320)   # its frames, another size than the input's
BOX_TOL = 1e-2           # card vs CPU boxes, px (fp32, TF32 off)
MAP_TOL = 1e-4           # card vs CPU maps (fp32, TF32 off)


def person_clip(np, person_scene, frames: int, seed: int):
    """A drifting synthetic person at 240×320: ``person_scene`` at 240²,
    its edge columns repeated to 320."""
    clip, _ = person_scene(np.random.default_rng(seed), size=PERSON_HW[0],
                           t=frames, drift=2.0)
    pad = (PERSON_HW[1] - PERSON_HW[0]) // 2
    return np.ascontiguousarray(np.pad(clip, ((0, 0), (0, 0), (pad, pad),
                                              (0, 0)), mode="edge"))


def same_boxes(np, got, want, what: str) -> float:
    """Per-frame boxes: the same number, within BOX_TOL px. Returns the
    largest difference."""
    worst = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            raise AssertionError(f"{what}: {len(g)} boxes against {len(w)}")
        if len(g):
            worst = max(worst, float(np.abs(g - w).max()))
    if worst > BOX_TOL:
        raise AssertionError(f"{what}: boxes {worst} px apart")
    return worst


def decided_boxes(np, decode_boxes, maps, ref, frames, stride: int):
    """The top box of each decided frame, the bf16 maps' against the fp32
    plain maps': within stride·(max|Δoffset| + max|Δwh| / 2) px of the
    input (+ 1e-3 for fp32 rounding). Returns (largest difference,
    bound)."""
    got = decode_boxes({k: v[frames] for k, v in maps.items()}, stride,
                       k=1, threshold=0.0)
    want = decode_boxes({k: v[frames] for k, v in ref.items()}, stride,
                        k=1, threshold=0.0)
    bound = stride * (float(np.abs(maps["offset"] - ref["offset"])[frames]
                            .max()) +
                      float(np.abs(maps["wh"] - ref["wh"])[frames].max()) / 2)
    err = max(float(np.abs(g[0, :4] - w[0, :4]).max())
              for g, w in zip(got, want, strict=True))
    if err > bound + 1e-3:
        raise AssertionError(f"decoded boxes {err} px apart, beyond {bound}")
    return err, bound


def person_phase(np, torch, kernels, repo: Path, card: str) -> dict:
    """Phase 16: the person detector, the person crop and pose.
    [16a] the tiny detector at its defaults (TinyFCN width 32, head 64,
    input 128, fp32): ``train_detector`` on ``person_dataset`` at 128²
    (steps/s, a profiled 20-step call, mean IoU on held-out scenes > 0.5);
    ``LearnedDetectorBackend`` on a 40-frame 240×320 clip, card against
    the CPU on the same weights; save, then ``Detector(backend="learned",
    checkpoint=...)``; ``PersonCrop`` card = CPU; ``build_dataset`` on a
    test split with ``person_crop`` over written JPEG clips, card = CPU;
    ``scripts/bbox.py json`` on a written video. [16b] ResNet-50 detector
    and pose at 128², bf16, random weights from seed 0: fused-bottleneck
    launches (6 a forward), maps by phase 4's rule against the fp32 plain
    models, peaks (and the detector's decoded top boxes) compared where the
    fp32 margin exceeds twice the error.
    [16c] tiny pose at 128: ``train_pose`` to a mean keypoint error
    < 0.1·128, ``estimate_clip`` card against CPU, ``scripts/pose.py``'s
    ``inference_one_video`` with the learned detector's crop (card = CPU)
    and ``render_pose_video``."""
    import cv2
    import shutil
    import tempfile

    from workoutdetector_tpu_torch.config import load_config
    from workoutdetector_tpu_torch.data.datasets import build_dataset
    from workoutdetector_tpu_torch.data.person import Detector, PersonCrop
    from workoutdetector_tpu_torch.data.synthetic import (iou,
                                                          person_dataset,
                                                          person_scene,
                                                          pose_dataset,
                                                          pose_scene)
    from workoutdetector_tpu_torch.data.video import write_video
    from workoutdetector_tpu_torch.models import load_flax_variables
    from workoutdetector_tpu_torch.models.convert import random_flax_variables
    from workoutdetector_tpu_torch.models.detector import (
        CenterNetDetector, LearnedDetectorBackend, decode_boxes,
        train_detector)
    from workoutdetector_tpu_torch.models.pose import (PoseEstimator,
                                                       TopDownPose,
                                                       train_pose)
    from workoutdetector_tpu_torch.scripts import bbox as bbox_cli
    from workoutdetector_tpu_torch.scripts import pose as pose_script

    phase_t0 = time.perf_counter()
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-person-", dir=repo))
    try:
        # [16a] the tiny detector
        imgs, boxes = person_dataset(PERSON_IMAGES, size=PERSON_SIZE, seed=0)
        train_detector(imgs, boxes, steps=3, batch=DETECTOR_BATCH)  # warm-up
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        backend = train_detector(imgs, boxes, steps=DETECTOR_STEPS, lr=2e-3,
                                 batch=DETECTOR_BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if any(kernels.launch_counts().values()):
            raise AssertionError("the tiny detector launched a hand kernel")
        steps_s = DETECTOR_STEPS / seconds
        log(f"    [16a] train_detector: {DETECTOR_STEPS} steps at batch "
            f"{DETECTOR_BATCH}, {PERSON_SIZE}², in {seconds:.3f} s = "
            f"{steps_s:.2f} steps/s on {card}")
        idle, busy = profile_call(torch, lambda: train_detector(
            imgs, boxes, steps=20, lr=2e-3, batch=DETECTOR_BATCH), top=6)
        rng = np.random.default_rng(123)
        ious = []
        for _ in range(12):
            scene, gt = person_scene(rng, size=PERSON_SIZE, t=1, drift=0.0)
            det = backend(scene)
            ious.append(iou(det[0][0], gt[0]) if len(det[0]) else 0.0)
        mean_iou = float(np.mean(ious))
        log(f"    held-out mean IoU {mean_iou:.4f} over 12 scenes (bar 0.5)")
        if mean_iou <= 0.5:
            raise AssertionError(f"the trained detector's IoU {mean_iou}")
        clip = person_clip(np, person_scene, PERSON_FRAMES, seed=5)
        det_file = str(tmp / "detector.pt")
        backend.save(det_file)
        cpu_backend = LearnedDetectorBackend.load(det_file, device="cpu")
        maps = backend.heatmaps(clip)
        cpu_maps = cpu_backend.heatmaps(clip)
        map_err = max(float(np.abs(maps[k] - cpu_maps[k]).max()) for k in maps)
        card_boxes, cpu_boxes = backend(clip), cpu_backend(clip)
        box_err = same_boxes(np, card_boxes, cpu_boxes, "card vs CPU")
        torch.backends.cudnn.allow_tf32 = True  # PyTorch's default
        tf32_err = max(float(np.abs(v - cpu_maps[k]).max())
                       for k, v in backend.heatmaps(clip).items())
        torch.backends.cudnn.allow_tf32 = False
        found = sum(len(b) > 0 for b in card_boxes)
        log(f"    backend on a {PERSON_FRAMES}-frame {PERSON_HW} clip: boxes "
            f"in {found} frames; card vs CPU max |map diff| {map_err:.3g} "
            f"(bar {MAP_TOL}), boxes {box_err:.3g} px (bar {BOX_TOL}); with "
            f"cuDNN's TF32 allowed (PyTorch's default) the maps lie "
            f"{tf32_err:.3g} from the CPU's")
        if map_err > MAP_TOL or found < PERSON_FRAMES // 2:
            raise AssertionError("the learned backend's card maps disagree "
                                 "with the CPU's, or it found no person")
        loaded = Detector(backend="learned", checkpoint=det_file)
        for a, b in zip(loaded.detect(clip), card_boxes, strict=True):
            if not np.array_equal(a, b):
                raise AssertionError("Detector(learned) on the saved file "
                                     "gives other boxes than the backend")
        crop = PersonCrop(loaded)(clip)
        cpu_crop = PersonCrop(Detector("learned", det_file, device="cpu"))(clip)
        if not np.array_equal(crop, cpu_crop) or crop.shape == clip.shape:
            raise AssertionError(f"PersonCrop: card {crop.shape} against CPU "
                                 f"{cpu_crop.shape} of {clip.shape}")
        log(f"    save -> Detector(backend='learned'): the backend's boxes; "
            f"PersonCrop {clip.shape[1:3]} -> {crop.shape[1:3]}, card = CPU")
        # build_dataset: a test split's person crop over written JPEG clips
        frames_root = tmp / "frames"
        lines = []
        for k in range(3):
            folder = frames_root / f"clip{k}"
            folder.mkdir(parents=True)
            for i, f in enumerate(person_clip(np, person_scene, 24, seed=k)):
                cv2.imwrite(str(folder / f"img_{i + 1:05}.jpg"), f[..., ::-1])
            lines.append(f"clip{k} 1 24 {k}")
        (frames_root / "test.txt").write_text("\n".join(lines) + "\n")
        opts = [f"data.data_root={frames_root}",
                f"data.test.anno={frames_root / 'test.txt'}",
                "data.test.data_prefix=", "data.test.person_crop=true",
                "data.person_backend=learned",
                f"data.person_checkpoint={det_file}"]
        cfg = load_config(str(repo / TSM_YAML), opts)
        ds = build_dataset(cfg.data, "test")
        cpu_ds = build_dataset(cfg.data, "test", device="cpu")
        plain = load_config(str(repo / TSM_YAML),
                            opts + ["data.test.person_crop=false"])
        plain_ds = build_dataset(plain.data, "test")
        shape = (cfg.data.num_segments, cfg.data.image_size,
                 cfg.data.image_size, 3)
        for k in range(3):
            item, label = ds[k]
            if item.shape != shape or label != k or \
                    not np.array_equal(item, cpu_ds[k][0]) or \
                    np.array_equal(item, plain_ds[k][0]):
                raise AssertionError(f"build_dataset's cropped item {k}: "
                                     f"{item.shape}, label {label}")
        log(f"    build_dataset (test, person_crop, learned backend on the "
            f"card): 3 items of {shape}, equal to the CPU backend's, unlike "
            "the uncropped ones")
        mp4 = str(tmp / "person.mp4")
        write_video(mp4, clip, 30.0)
        bbox_json = str(tmp / "person.json")
        bbox_cli.main(["json", "-i", mp4, "-o", bbox_json, "--backend",
                       "learned", "--checkpoint", det_file])
        with open(bbox_json) as f:
            got = json.load(f)
        want = bbox_cli.bboxes_to_json(mp4, None, Detector(
            "learned", det_file, device="cpu"))
        if got["total_frames"] != want["total_frames"] or \
                got["video"] != want["video"]:
            raise AssertionError("scripts/bbox.py json: another header")
        json_err = same_boxes(np, [np.asarray(b) for b in got["boxes"]],
                              [np.asarray(b) for b in want["boxes"]],
                              "scripts/bbox.py json")
        log(f"    scripts/bbox.py json: {got['total_frames']} frames, "
            f"{sum(1 for b in got['boxes'] if b)} with a box, within "
            f"{json_err:.3g} px of the CPU's")
        out.update(detector_steps_per_s=steps_s, detector_train_idle=idle,
                   detector_train_busy_ms=busy, detector_iou=mean_iou,
                   detector_map_err=map_err, detector_box_err=box_err,
                   detector_tf32_map_err=tf32_err)

        # [16b] ResNet-50 backbones at 128², bf16, against fp32 plain
        fused = 0
        forwards = math.ceil(PERSON_FRAMES / WINDOW_BATCH)
        for name, cls, runner in (("detector", CenterNetDetector,
                                   LearnedDetectorBackend),
                                  ("pose", TopDownPose, PoseEstimator)):
            model = cls("resnet50", dtype=torch.bfloat16)
            variables = random_flax_variables(model, seed=0)
            load_flax_variables(model, variables)
            ref = cls("resnet50", use_kernels=False)
            load_flax_variables(ref, variables)
            run = runner(model, input_size=PERSON_SIZE)
            ref_run = runner(ref, input_size=PERSON_SIZE)
            run.heatmaps(clip[:WINDOW_BATCH])  # warm-up (cuDNN plans)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            maps = run.heatmaps(clip)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = kernels.launch_counts()
            want = dict({k: 0 for k in launches},
                        fused_bottleneck=6 * forwards)
            if launches != want:
                raise AssertionError(f"{name} launches {launches} != {want}")
            fused += launches["fused_bottleneck"]
            ref_maps = ref_run.heatmaps(clip)
            full, ref_full = maps, ref_maps
            if name == "detector":
                maps, ref_maps = maps["heatmap"], ref_maps["heatmap"]
            err = float(np.abs(maps - ref_maps).max())
            scale = float(np.abs(ref_maps).max())
            # the peak cell per frame (detector) or per keypoint (pose)
            flat = maps.reshape(len(clip), -1, maps.shape[-1])
            ref_flat = ref_maps.reshape(len(clip), -1, maps.shape[-1])
            top2 = np.sort(ref_flat, axis=1)[:, -2:]
            decided = (top2[:, 1] - top2[:, 0]) > 2 * err
            agree = flat.argmax(1) == ref_flat.argmax(1)
            log(f"    [16b] {name} ResNet-50 {PERSON_SIZE}² bf16: "
                f"{len(clip)} frames in {forwards} forwards, {seconds:.4f} s "
                f"= {len(clip) / seconds:.2f} frames/s on {card}; launches "
                f"{({k: v for k, v in launches.items() if v})}; vs fp32 "
                f"plain max |map diff| {err:.5f} (max |map| {scale:.4f}); "
                f"peaks agree on {int(agree.sum())}/{agree.size}, required "
                f"on the {int(decided.sum())} whose fp32 margin exceeds 2x "
                "that diff")
            if not np.isfinite(maps).all() or err > 0.05 * (1 + scale) or \
                    not agree[decided].all():
                raise AssertionError(f"the bf16 ResNet-50 {name} disagrees "
                                     "with the fp32 plain model")
            if name == "detector":
                box_err, box_bound = decided_boxes(
                    np, decode_boxes, full, ref_full, decided[:, 0],
                    run.model.stride)
                log(f"    decoded top boxes of the {int(decided.sum())} "
                    f"decided frames: {box_err:.4f} px apart at {PERSON_SIZE}"
                    f"² (bound {box_bound:.4f} from the wh and offset maps)")
                out["r50_detector_box_err"] = box_err
            profile_call(torch, lambda: run.heatmaps(clip[:WINDOW_BATCH]),
                         top=4)
            out[f"r50_{name}_frames_per_s"] = len(clip) / seconds
            out[f"r50_{name}_map_err"] = err
            del model, ref, run, ref_run
        out["fused_launches"] = fused

        # [16c] tiny pose
        pimgs, kps = pose_dataset(PERSON_IMAGES, size=PERSON_SIZE, seed=0)
        train_pose(pimgs, kps, steps=3, batch=POSE_BATCH)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        est = train_pose(pimgs, kps, steps=POSE_STEPS, lr=2e-3,
                         batch=POSE_BATCH)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        rng = np.random.default_rng(42)
        errs = []
        for _ in range(8):
            scene, gt = pose_scene(rng, size=PERSON_SIZE, t=1)
            errs.append(np.abs(est.estimate_clip(scene)[0, :, :2] - gt[0]).mean())
        mean_err = float(np.mean(errs))
        log(f"    [16c] train_pose: {POSE_STEPS} steps at batch {POSE_BATCH}, "
            f"{PERSON_SIZE}², in {seconds:.3f} s = {POSE_STEPS / seconds:.2f} "
            f"steps/s on {card}; held-out mean keypoint error "
            f"{mean_err:.3f} px (bar {0.1 * PERSON_SIZE})")
        if mean_err >= 0.1 * PERSON_SIZE:
            raise AssertionError(f"the trained pose model's error {mean_err}")
        pose_file = str(tmp / "pose.pt")
        est.save(pose_file)
        cpu_est = PoseEstimator.load(pose_file, device="cpu")
        pclip, _ = pose_scene(np.random.default_rng(6), size=160, t=21)
        got, want = est.estimate_clip(pclip), cpu_est.estimate_clip(pclip)
        kp_err = float(np.abs(got[..., 2] - want[..., 2]).max())
        if not np.array_equal(got[..., :2], want[..., :2]) or kp_err > MAP_TOL:
            raise AssertionError("estimate_clip: card against CPU")
        pose_mp4 = str(tmp / "pose.mp4")
        write_video(pose_mp4, pclip, 30.0)
        item = pose_script.inference_one_video(
            pose_mp4, pose_estimator=est,
            detector=Detector("learned", det_file))
        cpu_item = pose_script.inference_one_video(
            pose_mp4, pose_estimator=cpu_est,
            detector=Detector("learned", det_file, device="cpu"))
        if list(item) != list(cpu_item) or \
                item["keypoint"].shape != (1, 21, 17, 2) or \
                not np.array_equal(item["keypoint"], cpu_item["keypoint"]):
            raise AssertionError("inference_one_video: card against CPU")
        render = str(tmp / "render.mp4")
        pose_script.render_pose_video(item, render, video_path=pose_mp4,
                                      thre=0.0)
        log(f"    estimate_clip on 21 frames, card = CPU (scores within "
            f"{kp_err:.3g}); inference_one_video with the learned crop: "
            f"keypoints {item['keypoint'].shape}, card = CPU; "
            f"render_pose_video wrote {Path(render).stat().st_size} bytes")
        out.update(pose_steps_per_s=POSE_STEPS / seconds,
                   pose_error_px=mean_err)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - phase_t0
    return out


# ---------------------------------------------------------------- phase 17
PARALLEL_RANKS = 2   # ranks of the spawned world, all on the one card
PARALLEL_BATCH = 8   # the global batch of its train steps: 4 a rank
PARALLEL_STEPS = 3
PP_CUTS = (0, 3, 6)  # stem + layer1-2 | layer3-4 + head


def nccl_all_reduce(rank: int) -> float:
    """One all-reduce over NCCL (phase 17's probe of two ranks on one
    card)."""
    import torch
    import torch.distributed as dist

    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    torch.cuda.synchronize()
    return float(t)


def update_errors(np, got: dict, want: dict, init: dict) -> dict:
    """Per leaf ‖got − want‖ / ‖want − init‖: a run's gap from another's
    as a share of the other's update (leaves the steps left alone: None,
    where the two must be equal)."""
    out = {}
    for k, w in want.items():
        w = np.asarray(w, np.float64)
        g = np.asarray(got[k], np.float64)
        moved = float(np.linalg.norm(w - init[k]))
        if moved == 0.0:
            if not np.array_equal(g, w):
                raise AssertionError(f"{k}: moved in one run, not the other")
            out[k] = None
        else:
            out[k] = float(np.linalg.norm(g - w)) / moved
    return out


def parallel_phase(np, torch, kernels, variables, video, repo: Path,
                   card: str) -> dict:
    """Phase 17: data, FSDP and pipeline parallelism, a world of 2 ranks
    sharing the one card (gloo: NCCL refuses two ranks on one device),
    TSM-R50 at 224², 8 segments, 12 classes, through
    ``parallel/dryrun.run`` on every rank; the engines on phase 4's random
    weights, the trainers from the JAX models' initializers at seed 0
    (``init_flax_variables``: a small head, so that 3 steps at the yaml's
    learning rate stay well-conditioned and two runs that round apart stay
    near):
    [17a] dp: 3 train steps (dropout 0.5) on a global batch of 8, 4 a
    rank, against the one-process steps on the same batch: fp32 (the plain
    model, TF32 off) within 1e-4; bf16 (the kernels) by the update rule
    (each leaf's gap from the one-process bf16 run, as a share of that
    run's update, within GRAD_RATIO times the one-process bf16 run's own
    gap from fp32 plus GRAD_FLOOR: the two bf16 runs differ only in
    summation order and rounding places, which bf16 rounding bounds);
    shift-matmul, dx and dW launches a rank (16, 33, 33 a step).
    [17b] fsdp: data 2, the bf16 steps again, every eligible leaf held by
    half on each rank, equal to [17a]'s within 1e-5 (1 + |p|).
    [17c] serve: an engine over data 2, the window batch split over the
    ranks: fp32 logits within 1e-4 of the one-process engine's, the
    phase-4 video's counts identical in fp32 and bf16 (0 on these random
    weights, as phase 4's), and the argmax sequences of a state walk over
    its windows (``dryrun.state_runs``: phase 4's count check, head
    biases a block of windows) identical, with 2 reps or more;
    fused-bottleneck and shift-matmul launches a rank.
    [17d] pp-serve: model 2, cuts [0, 3, 6], 2 microbatches: bf16 argmax,
    counts and state walk identical to the one-shot engine's (the bf16
    gap printed);
    the stem and layer1-2 rank launches the fused
    bottleneck (6 a microbatch) and layer2_0's shift-matmul, the layer3-4
    rank 9 shift-matmuls a microbatch.
    [17e] one DP step at world size 1 over NCCL, against the one-process
    step; NCCL with two ranks on the card, reported. Also the dry run's
    DividedBlock pipeline (fp32, forward and gradients) and a step over a
    (2, 1, 1) hybrid mesh.
    Steps/s, the share of step time in collectives (device synchronised
    around each) and each collective's transport, per rank. The ranks'
    phases start once this process's references, [17e] and the NCCL probe
    are done (``DryrunSpec.start_file``): the two ranks share the card
    with each other only."""
    import math
    import shutil
    import tempfile
    import threading

    from workoutdetector_tpu_torch.counting import pred_to_count
    from workoutdetector_tpu_torch.models import TSM
    from workoutdetector_tpu_torch.models.convert import (flax_to_port_state,
                                                          init_flax_variables)
    from workoutdetector_tpu_torch.parallel import dryrun
    from workoutdetector_tpu_torch.parallel.distributed import (free_port,
                                                                initialize,
                                                                spawn)
    from workoutdetector_tpu_torch.parallel.mesh import create_mesh
    from workoutdetector_tpu_torch.train.trainer import Trainer

    phase_t0 = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix=".smoke-parallel-", dir=repo))
    try:
        torch.save(variables, tmp / "variables.pt")
        train_vars = init_flax_variables(TSM(NUM_CLASS, FRAMES, "resnet50"),
                                         seed=0)
        torch.save(train_vars, tmp / "train_variables.pt")
        np.save(tmp / "video.npy", video)
        spec = dryrun.DryrunSpec(
            base_model="resnet50", num_class=NUM_CLASS, num_segments=FRAMES,
            image_size=SIZE, train_dtypes=("float32", "bfloat16"),
            serve_dtypes=("float32", "bfloat16"), dropout=0.5,
            batch=PARALLEL_BATCH, steps=PARALLEL_STEPS,
            window_batch=WINDOW_BATCH, pp_cuts=PP_CUTS, pp_microbatches=2,
            device="cuda", phases=("dp", "fsdp", "serve", "pp-serve", "pp",
                                   "slice"),
            weights=str(tmp / "variables.pt"),
            train_weights=str(tmp / "train_variables.pt"), out_dir=str(tmp),
            video=str(tmp / "video.npy"), timed=True, tf32=False,
            threads=2)
        x, y = dryrun.train_batch(spec)
        init = flax_to_port_state(train_vars)
        # the world and NCCL's two ranks on the card start (imports, CUDA
        # start-up) while this process runs the one-process references
        # and [17e]; the ranks' phases wait for ``go``, written once this
        # process and the probe are done with the card
        go = tmp / "go"
        spec.start_file = str(go)
        world, probe = {}, {}

        def run_world():
            t0 = time.perf_counter()
            try:
                world["ranks"] = spawn(dryrun.run, PARALLEL_RANKS, (spec,),
                                       device="cuda", timeout_s=300)
            except RuntimeError as exc:
                world["error"] = exc
            world["seconds"] = time.perf_counter() - t0

        def run_probe():
            try:
                spawn(nccl_all_reduce, 2, device="cuda", backend="nccl",
                      timeout_s=60)
                probe["result"] = "NCCL took two ranks on one card"
            except RuntimeError as exc:
                lines = [ln for ln in str(exc).splitlines() if ln.strip()]
                probe["result"] = next((ln.strip() for ln in lines
                                        if "Duplicate GPU" in ln),
                                       lines[-1].strip())

        world_thread = threading.Thread(target=run_world)
        probe_thread = threading.Thread(target=run_probe)
        world_thread.start()
        probe_thread.start()
        try:
            refs = {}
            for dtype in spec.train_dtypes:
                tr = Trainer(dryrun.train_config(spec, dtype), device="cuda")
                st = tr.init_state(steps_per_epoch=10, variables=train_vars)
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                losses = [float(tr.train_step(st, x, y)["loss"])
                          for _ in range(spec.steps)]
                torch.cuda.synchronize()
                refs[dtype] = {
                    "losses": losses, "launches": kernels.launch_counts(),
                    "steps_per_s": spec.steps / (time.perf_counter() - t0),
                    "state": {k: v.float().cpu().numpy() for k, v in
                              st.model.state_dict().items()}}
                del tr, st
            torch.cuda.empty_cache()
            log(f"    one process, global batch {PARALLEL_BATCH}: fp32 "
                f"losses {refs['float32']['losses']}, bf16 "
                f"{refs['bfloat16']['losses']} "
                f"({refs['bfloat16']['steps_per_s']:.2f} steps/s, beside "
                f"the world's start-up) on {card}")
            # [17e] one DP step over NCCL at world size 1
            backend = initialize(f"tcp://localhost:{free_port()}", 1, 0,
                                 device="cuda")
            try:
                mesh = create_mesh(device="cuda")
                tr = Trainer(dryrun.train_config(spec, "bfloat16"), mesh,
                             device="cuda")
                st = tr.init_state(steps_per_epoch=10, variables=train_vars)
                loss = float(tr.train_step(st, x, y)["loss"])
                transports = mesh.comm.transports()
                del tr, st, mesh
            finally:
                torch.distributed.destroy_process_group()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        finally:
            probe_thread.join()
            go.touch()  # the ranks' phases have the card to themselves
            world_thread.join()
        if "error" in world:
            raise world["error"]
        ranks, world_s = world["ranks"], world["seconds"]
        log(f"    world of {PARALLEL_RANKS} ranks on cuda:0: {world_s:.1f} s "
            f"(phases {ranks[0]['phase_seconds']}; rank 0's train set-up "
            f"and steps: " + ", ".join(
                f"{k} {ranks[0][k]['init_seconds']:.1f} + "
                f"{ranks[0][k]['seconds']:.1f} s" for k in
                ("dp-float32", "dp-bfloat16", "fsdp-bfloat16")) + ")")

        out = {"ranks": []}
        bf = refs["bfloat16"]
        bf_gap = update_errors(np, bf["state"], refs["float32"]["state"],
                               init)
        loss_gap = max(abs(a - b) for a, b in zip(
            bf["losses"], refs["float32"]["losses"]))
        dp = {d: torch.load(tmp / f"dp-{d}.pt", map_location="cpu",
                            weights_only=False)["model"]
              for d in spec.train_dtypes}
        fs = torch.load(tmp / "fsdp-bfloat16.pt", map_location="cpu",
                        weights_only=False)["model"]
        # [17a] fp32 within 1e-4, bf16 by the update rule
        f32 = refs["float32"]
        dp32 = {k: v.float().numpy() for k, v in dp["float32"].items()}
        err32 = max(float(np.max(np.abs(dp32[k] - f32["state"][k])
                                 / (1 + np.abs(f32["state"][k]))))
                    for k in dp32)
        for r in ranks:
            lerr = max(abs(a - b) for a, b in zip(
                r["dp-float32"]["losses"], f32["losses"]))
            if lerr > 1e-4 * (1 + max(abs(v) for v in f32["losses"])):
                raise AssertionError(f"rank {r['rank']} fp32 DP losses "
                                     f"{r['dp-float32']['losses']} vs "
                                     f"{f32['losses']}")
        if err32 > 1e-4:
            raise AssertionError(f"fp32 DP parameters off the one-process "
                                 f"run by {err32} (1 + |p|)")
        dpb = {k: v.float().numpy() for k, v in dp["bfloat16"].items()}
        gaps = update_errors(np, dpb, bf["state"], init)
        worst = max((gaps[k] - GRAD_RATIO * bf_gap[k], k) for k in gaps
                    if gaps[k] is not None)
        if worst[0] > GRAD_FLOOR:
            raise AssertionError(f"bf16 DP update of {worst[1]} off the one-"
                                 f"process bf16 run: {gaps[worst[1]]} > "
                                 f"{GRAD_RATIO} x {bf_gap[worst[1]]} + "
                                 f"{GRAD_FLOOR}")
        for r in ranks:
            lerr = max(abs(a - b) for a, b in zip(
                r["dp-bfloat16"]["losses"], bf["losses"]))
            if lerr > GRAD_RATIO * loss_gap + 1e-3:
                raise AssertionError(f"rank {r['rank']} bf16 DP losses "
                                     f"{r['dp-bfloat16']['losses']} vs "
                                     f"{bf['losses']}")
        log(f"    [17a] dp: fp32 parameters within {err32:.3g} (1 + |p|) of "
            f"one process; bf16 update gap max "
            f"{max(v for v in gaps.values() if v is not None):.4g} (one-"
            f"process bf16 vs fp32: "
            f"{max(v for v in bf_gap.values() if v is not None):.4g}); "
            f"losses rank 0 {ranks[0]['dp-bfloat16']['losses']}")
        # [17b] fsdp equals dp
        ref = dp["bfloat16"]
        e = max(float((fs[k].float() - ref[k].float()).abs().max()
                      / (1 + ref[k].float().abs().max())) for k in ref)
        if e > 1e-5:
            raise AssertionError(f"bf16 FSDP off DP by {e} (1 + |p|)")
        log(f"    [17b] fsdp bf16: within {e:.3g} (1 + |p|) of dp")
        for r in ranks:
            held = r["fsdp-bfloat16"]["held"]
            if not held or any(f != 0.5 for f in held.values()):
                raise AssertionError(f"rank {r['rank']} FSDP holds {held}")

        steps = spec.steps
        want_train = {"shift_matmul": 16 * steps, "conv1x1_dx": 33 * steps,
                      "conv1x1_dw": 33 * steps}
        chunks = math.ceil((WINDOW_BATCH + 3) / WINDOW_BATCH)
        vid_fwd = math.ceil((len(video) // 8) / WINDOW_BATCH)
        for r in ranks:
            rk = r["rank"]
            row = {"rank": rk}
            for ph in ("dp", "fsdp"):
                res = r[f"{ph}-bfloat16"]
                got = {k: res["launches"][k] for k in want_train}
                if got != want_train:
                    raise AssertionError(f"rank {rk} {ph} launches {got} != "
                                         f"{want_train}")
                share = res["collective_seconds"] / res["seconds"]
                row[ph] = {"launches": got, "steps_per_s": res["steps_per_s"],
                           "collective_share": share,
                           "transports": res["transports"]}
                log(f"    [17{'a' if ph == 'dp' else 'b'}] rank {rk} {ph} "
                    f"bf16: {res['steps_per_s']:.2f} steps/s, collectives "
                    f"{res['collective_seconds']:.3f} of {res['seconds']:.3f} "
                    f"s ({share:.3f}) in {res['collective_calls']}, launches "
                    f"{got}, transports {res['transports']} on {card}")
            # [17c] serve and [17d] pp-serve
            for ph in ("serve", "pp-serve"):
                s32, s16 = r.get(f"{ph}-float32"), r[f"{ph}-bfloat16"]
                if s32 is not None and s32["max_abs_err"] > 1e-4:
                    raise AssertionError(f"rank {rk} {ph} fp32 logits off "
                                         f"by {s32['max_abs_err']}")
                for res in (s32 or s16, s16):
                    if res["count"] != res["ref_count"]:
                        raise AssertionError(f"rank {rk} {ph} count "
                                             f"{res['count']} != "
                                             f"{res['ref_count']}")
                    runs = [pred_to_count(seq, step=8)[0] for seq in
                            (res["states"], res["ref_states"])]
                    if not np.array_equal(res["states"], res["ref_states"]) \
                            or runs[0] < 2:
                        raise AssertionError(f"rank {rk} {ph} state runs "
                                             f"{res['states']} vs one-shot "
                                             f"{res['ref_states']}")
                if ph == "serve":
                    want = {"fused_bottleneck": 6 * chunks,
                            "shift_matmul": 10 * chunks}
                    want_vid = {"fused_bottleneck": 6 * vid_fwd,
                                "shift_matmul": 10 * vid_fwd}
                else:
                    if not (s16["logits"].argmax(-1) ==
                            s16["ref"].argmax(-1)).all():
                        raise AssertionError(f"rank {rk} pp-serve argmax "
                                             "differs from one-shot")
                    stage0 = rk == 0  # model coordinate 0: the stem side
                    per = {"fused_bottleneck": 6 if stage0 else 0,
                           "shift_matmul": 1 if stage0 else 9}
                    want = {k: v * 2 * chunks for k, v in per.items()}
                    want_vid = {k: v * 2 * vid_fwd for k, v in per.items()}
                got = {k: s16["launches"][k] for k in want}
                got_vid = {k: s16["video_launches"][k] for k in want}
                if got != want or got_vid != want_vid:
                    raise AssertionError(f"rank {rk} {ph} launches {got} / "
                                         f"{got_vid} != {want} / {want_vid}")
                share = s16["collective_seconds"] / s16["seconds"]
                row[ph] = {"launches": got, "video_launches": got_vid,
                           "fp32_max_abs_err": s32 and s32["max_abs_err"],
                           "bf16_max_abs_err": s16["max_abs_err"],
                           "count": s16["count"],
                           "windows_per_s": (WINDOW_BATCH + 3) / s16["seconds"],
                           "collective_share": share,
                           "transports": s16["transports"]}
                fp32 = f"fp32 logits within {s32['max_abs_err']:.3g}, " \
                    if s32 is not None else ""
                reps = pred_to_count(s16["states"], step=8)[0]
                log(f"    [17{'c' if ph == 'serve' else 'd'}] rank {rk} {ph}: "
                    f"{fp32}bf16 gap {s16['max_abs_err']:.4g}, count "
                    f"{s16['count']} (one-shot {s16['ref_count']}), the "
                    f"state walk's {len(s16['states'])} argmax and {reps} "
                    f"reps = one-shot's, launches "
                    f"{got} + video {got_vid}, "
                    f"{(WINDOW_BATCH + 3) / s16['seconds']:.2f} windows/s, "
                    f"collectives {share:.3f} of the call, transports "
                    f"{s16['transports']} on {card}")
            row["pp"] = r["pp"]
            row["slice_loss"] = r["slice"]["loss"]
            out["ranks"].append(row)
        log(f"    pp (DividedBlocks, fp32: {r['pp']}), slice mesh "
            f"{r['slice']['mesh']} loss {r['slice']['loss']:.4f}")

        bf_loss = refs["bfloat16"]["losses"][0]
        if backend != "nccl" or abs(loss - bf_loss) > 1e-6:
            raise AssertionError(f"world of 1 over {backend}: loss {loss} vs "
                                 f"one process {bf_loss}")
        log(f"    [17e] world of 1 over {backend}: loss {loss:.6f} = one "
            f"process {bf_loss:.6f}, transports {transports}")
        nccl_pair = probe["result"]
        log(f"    [17e] two ranks on one card over NCCL: {nccl_pair}")
        out.update(nccl_world1={"backend": backend, "loss": loss,
                                "transports": transports},
                   nccl_pair=nccl_pair, world_seconds=world_s,
                   one_process_bf16_steps_per_s=bf["steps_per_s"],
                   seconds=time.perf_counter() - phase_t0)
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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

    torch.cuda.empty_cache()
    log(f"[11] serving and export: WorkoutServer over TSM-R50 {SIZE} "
        f"({TSM_YAML}, --num-class {SERVE_CLASSES}), bf16, window_batch "
        f"{WINDOW_BATCH}; .pt2 artifacts of TSM-R50 and TimeSformer-B/16")
    serve = serve_phase(np, torch, kernels, repo, card)

    torch.cuda.empty_cache()
    log(f"[12] TPN-R50 {SIZE} ({TPN_YAML}), bf16: window_batch {WINDOW_BATCH} "
        f"inference, {TPN_TRAIN_STEPS} train steps at batch {TRAIN_BATCH}, "
        f"export")
    tpn = tpn_phase(np, torch, kernels, video, repo, card)

    torch.cuda.empty_cache()
    log(f"[13] TDN-R50 {SIZE} ({TDN_YAML}), bf16: {WINDOW_BATCH} burst windows, "
        f"export, {TDN_TRAIN_STEPS} train steps at batch {TDN_BATCH} from "
        f"TDNDataset")
    tdn = tdn_phase(np, torch, kernels, video, repo, card)

    torch.cuda.empty_cache()
    log(f"[14] image models ({LIT_IMG_YAML}: ResNet-50 image classifier, "
        f"{SIZE}, bf16, {IMAGE_CLASSES} classes): window_batch "
        f"{WINDOW_BATCH} inference and the image counter, export, "
        f"{IMAGE_TRAIN_STEPS} train steps at batch {IMAGE_BATCH} from "
        f"ImageDataset; {', '.join(OTHER_BACKBONES)}; the counters")
    image = image_phase(np, torch, kernels, repo, card)

    torch.cuda.empty_cache()
    log(f"[15] RepNet-base ({REPNET_YAML}: T 64, 64², bf16, window_batch "
        f"{WINDOW_BATCH}, batch 32) and MoE TimeSformer-B/16 ({TS_YAML} with "
        f"model.moe_experts={MOE_EXPERTS}, bf16)")
    t15 = time.perf_counter()
    repnet = repnet_phase(np, torch, kernels, repo, card)
    torch.cuda.empty_cache()
    moe = moe_phase(np, torch, kernels, video, repo, card, ts_clips_s,
                    ts_train_clips_s)
    phase15_s = time.perf_counter() - t15
    log(f"    phase [15]: {phase15_s:.1f} s (RepNet {repnet['seconds']:.1f} "
        f"s, MoE {moe['seconds']:.1f} s)")

    torch.cuda.empty_cache()
    log(f"[16] the person detector, the person crop and pose: the tiny "
        f"detector and pose model ({PERSON_SIZE}², fp32), ResNet-50 "
        f"backbones ({PERSON_SIZE}², bf16)")
    person = person_phase(np, torch, kernels, repo, card)
    log(f"    phase [16]: {person['seconds']:.1f} s")

    torch.cuda.empty_cache()
    log(f"[17] data, FSDP and pipeline parallelism: {PARALLEL_RANKS} ranks on "
        f"the card, TSM-R50 {SIZE} ({TSM_YAML}), global batch "
        f"{PARALLEL_BATCH}, window_batch {WINDOW_BATCH}, cuts {PP_CUTS}")
    parallel = parallel_phase(np, torch, kernels, variables, video, repo, card)
    log(f"    phase [17]: {parallel['seconds']:.1f} s")

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
        # the same kernels at the image ResNet-50's sites (phase 14): the
        # fused blocks on 16 single images (fold 0), dx and dW unshifted at
        # lit_img.yaml's batch of 64
        "fused_bottleneck_image": ("workoutdetector_tpu_torch/csrc/fused_block.cu",
                                   "workoutdetector_tpu/ops/pallas/fused_block.py:192"),
        "conv1x1_dx_image": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                             "workoutdetector_tpu/ops/pallas/conv1x1.py:52"),
        "conv1x1_dw_image": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                             "workoutdetector_tpu/ops/pallas/conv1x1.py:92"),
        # the fused blocks in the ResNet-50 detector's and pose model's
        # backbone at 128² (phase 16), 16 images a forward
        "fused_bottleneck_person": ("workoutdetector_tpu_torch/csrc/fused_block.cu",
                                    "workoutdetector_tpu/ops/pallas/fused_block.py:192"),
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
                         attention_dq=tiled_launches["attention_dq"],
                         fused_bottleneck_image=image["fused_launches"],
                         conv1x1_dx_image=image["dx_launches"],
                         conv1x1_dw_image=image["dw_launches"],
                         fused_bottleneck_person=person["fused_launches"])
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
                    "sweep": sweep, "files": files, "serve": serve,
                    "tpn": tpn, "tdn": tdn, "image": image,
                    "repnet": repnet, "moe": moe, "phase15_s": phase15_s,
                    "person": person, "parallel": parallel,
                    "card": card}))
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
