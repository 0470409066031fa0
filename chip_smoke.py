#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure → exit 1, and the final ``{"ok": true, ...}`` line is
not printed; no CUDA device → exit 2):

  1. the card's name and power limit (nvidia-smi);
  2. build the hand kernels from ``workoutdetector_tpu_torch/csrc``;
  3. each kernel against its plain PyTorch version at every TSM-R50 224²
     shape of its main path, bf16 — the inference kernels at window batch
     16 (128 frames), dx and dW at the 12 backward site shapes of a
     batch-32 train step (256 frames), beside ``torch.matmul``: max error,
     kernel / plain / library time and the bound (per site, the larger of
     the call's bytes over the H100's 3.35 TB/s and its operations over
     989 TFLOP/s bf16);
  4. the main path: TSM-R50 224², 8 segments, 12 classes, bf16, random
     numpy-seeded flax weights through ``load_flax_variables``;
     ``InferenceEngine.score_video`` on a synthetic ~300-frame uint8 video
     and ``count_by_video_model`` on the same video, with the kernel launch
     counts checked (10 shift-matmul and 6 fused-block launches per
     forward) and the logits held against the port's plain path in fp32 on
     the card; then one ``score_windows`` batch under torch.profiler
     (device time by kernel and the device's idle share);
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
  7. one JSON line of per-kernel numbers, the card line again, and the
     contract line ``{"ok": true, "device": {...}}`` last.

Kernel times are CUDA-event means over repeated launches on the current
stream; ``ms``, ``plain_ms`` and ``bound_ms`` are per R50 forward (the sum
over the kernel's launch sites) for the inference kernels and per train
step (batch 32, the sum over the 33 backward sites) for dx and dW. No
single PyTorch call computes the shift, the shift-matmul or the fused
block, so their ``library_ms`` is null; dx and dW are timed beside
``torch.matmul`` of the same operands (g @ Wᵀ, xᵀ @ g, no shift).
"""

from __future__ import annotations

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


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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
        m = bt * h * w
        tb, to = bound_ms((m * c + c * o + m * o) * 2, 2.0 * m * c * o)
        add("shift_matmul", err, ms, pms, tb, to, count)
        log(f"  shift_matmul x{tuple(x.shape)} -> {o} err={err} kernel={ms:.4f} ms "
            f"plain={pms:.4f} ms bound={max(tb, to):.4f} ms")

    for h, w, c, f, o, ds, count in FUSED_SITES:
        x = randn(bt, h, w, c)
        p = kernels.FusedBlockParams(
            w1=randn(c, f, scale=math.sqrt(2 / c)).contiguous(), sb1=sb(f),
            w2=randn(3, 3, f, f, scale=math.sqrt(2 / (9 * f))).contiguous(),
            sb2=sb(f),
            w3=randn(f, o, scale=math.sqrt(2 / f)).contiguous(), sb3=sb(o),
            wd=randn(c, o, scale=math.sqrt(2 / c)).contiguous() if ds else None,
            sbd=sb(o) if ds else None)
        fold = c // 8
        got = kernels.fused_bottleneck(x, p, n_segment=FRAMES, fold=fold)
        want = kernels.fused_bottleneck_plain(x, p, n_segment=FRAMES, fold=fold)
        torch.cuda.synchronize()
        err = check_close(torch, f"fused_bottleneck {tuple(x.shape)} F={f} O={o}",
                          got, want)
        ms = time_ms(torch, lambda: kernels.fused_bottleneck(
            x, p, n_segment=FRAMES, fold=fold), 10)
        pms = time_ms(torch, lambda: kernels.fused_bottleneck_plain(
            x, p, n_segment=FRAMES, fold=fold), 3)
        m = bt * h * w
        wbytes = (c * f + 9 * f * f + f * o + (c * o if ds else 0)) * 2
        sbytes = (2 * f * 2 + 2 * o * (2 if ds else 1)) * 4
        flops = 2.0 * m * (c * f + 9 * f * f + f * o + (c * o if ds else 0))
        tb, to = bound_ms((m * c + m * o) * 2 + wbytes + sbytes, flops)
        add("fused_bottleneck", err, ms, pms, tb, to, count)
        log(f"  fused_bottleneck x{tuple(x.shape)} F={f} O={o} ds={ds} err={err} "
            f"kernel={ms:.4f} ms plain={pms:.4f} ms bound={max(tb, to):.4f} ms")
    backward_rows(torch, kernels, randn, add)
    return rows


def backward_rows(torch, kernels, randn, add) -> None:
    """dx and dW at every TSM-R50 224² backward site of one train step
    (batch 32 clips = 256 frames)."""
    frames = TRAIN_BATCH * FRAMES
    for h, c, o, shifted, count in BWD_SITES:
        r = frames * h * h
        spec = (FRAMES, c // 8, h * h) if shifted else (1, 0, 1)
        x = randn(r, c)
        g = randn(r, o)
        wt = randn(o, c, scale=1 / math.sqrt(o))
        site = f"R={r} C={c} O={o}{' shifted' if shifted else ''}"
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
        del x, g, wt
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
    counts, train clips/s)."""
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
                "fused_bottleneck": 6 * val_forwards, "temporal_shift": 0}
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

    grad_check(np, torch, build_model, load_flax_variables, cross_entropy,
               cfg, variables)

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
    return launches, clips_s


def grad_check(np, torch, build_model, load_flax_variables, cross_entropy,
               cfg, variables) -> None:
    """One batch's gradients of the main path (bf16, kernels) against the
    port's plain path in fp32 on the card, per leaf, with the bf16 plain
    path's own error beside. The batch is numpy-seeded noise, different in
    every frame (a DebugDataset clip repeats one colour, so a fault in the
    shift's direction would barely show). Then the same check on two
    planted wiring faults, each of which it must catch."""
    from workoutdetector_tpu_torch.ops.kernels import conv1x1 as c1
    from workoutdetector_tpu_torch.ops.preprocess import normalize_clip

    rng = np.random.default_rng(5)
    x = normalize_clip(torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BATCH, FRAMES, SIZE, SIZE, 3), dtype=np.uint8)).cuda())
    yt = torch.from_numpy(rng.integers(0, NUM_CLASS, TRAIN_BATCH)).cuda()

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

    # planted faults: ShiftConv1x1.backward calls the module's wrappers, so
    # swapping one for a version that drops the shift miswires all 16 sites
    # (the real wrapper then counts its launches on the stand-in's counter)
    faults = {"dx without S^T": "conv1x1_dx", "dW over unshifted x": "conv1x1_dw"}
    for label, name in faults.items():
        real = getattr(c1, name)

        def fault(a, b, *shift, real=real):
            return real(a, b)

        fault.launches = 0
        setattr(c1, name, fault)
        try:
            e = rel(grads("bfloat16", True))
        finally:
            setattr(c1, name, real)
        caught = beyond(e)
        log(f"    planted fault '{label}': max rel err {max(e.values()):.5f}, "
            f"largest ratio {ratio(e):.3f}, {len(caught)}/{len(e)} leaves "
            f"beyond the limit")
        if not caught:
            raise AssertionError(f"the gradient check misses the planted "
                                 f"fault '{label}'")


def profile_call(torch, fn, top: int = 10) -> None:
    """One call under torch.profiler: device time by kernel (copies
    included), hand kernels apart, and the device's idle share of the span
    from its first to its last recorded activity."""
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
        return
    wall_ms = (max(ends) - min(starts)) / 1e3
    device_ms = sum(by_name.values())
    hand = {k: v for k, v in by_name.items()
            if any(n in k for n in ("shift_kernel", "shift_matmul_kernel",
                                    "fused_bottleneck_kernel",
                                    "conv1x1_dx_kernel", "conv1x1_dw_kernel",
                                    "dw_reduce_kernel"))}
    log(f"    profile: device span {wall_ms:.3f} ms, busy {device_ms:.3f} ms "
        f"(idle share {max(0.0, 1 - device_ms / wall_ms):.3f}), hand kernels "
        f"{sum(hand.values()):.3f} ms, other {device_ms - sum(hand.values()):.3f} ms")
    if skipped:
        log("    not device work (left out): " + ", ".join(
            f"{n[:40]} {ms:.3f} ms" for n, ms in sorted(skipped.items())))
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"      {ms:9.3f} ms {calls[name]:4d}x  {name[:160]}")


def synthetic_video(np, frames: int, seed: int):
    """uint8 (frames, 224, 224, 3): a bright square moving up and down
    (a slow periodic 'exercise') over a noisy background."""
    rng = np.random.default_rng(seed)
    video = rng.integers(0, 60, (frames, SIZE, SIZE, 3), dtype=np.uint8)
    for t in range(frames):
        y = int(80 + 60 * math.sin(2 * math.pi * t / 48))
        video[t, y:y + 48, 88:136] = (220, 200, 180)
    return video


def main() -> int:
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
    for line in lib.ptxas_log.splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log("    " + line.strip())

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
    want = {"shift_matmul": 10 * forwards, "fused_bottleneck": 6 * forwards,
            "temporal_shift": 0, "conv1x1_dx": 0, "conv1x1_dw": 0}
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
        raise AssertionError("main path disagrees with the fp32 plain path")

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
    if blk_launches != {"temporal_shift": 16, "shift_matmul": 0,
                        "fused_bottleneck": 6, "conv1x1_dx": 0,
                        "conv1x1_dw": 0}:
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
    train_launches, clips_s = train_phase(np, torch, kernels, variables, repo,
                                          card)

    replaces = {
        "temporal_shift": ("workoutdetector_tpu_torch/csrc/shift.cu",
                           "workoutdetector_tpu/ops/pallas/shift.py:36"),
        "shift_matmul": ("workoutdetector_tpu_torch/csrc/shift_matmul.cu",
                         "workoutdetector_tpu/ops/pallas/shift_matmul.py:49"),
        "fused_bottleneck": ("workoutdetector_tpu_torch/csrc/fused_block.cu",
                             "workoutdetector_tpu/ops/pallas/fused_block.py:192"),
        "conv1x1_dx": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                       "workoutdetector_tpu/ops/pallas/conv1x1.py:52"),
        "conv1x1_dw": ("workoutdetector_tpu_torch/csrc/conv1x1_bwd.cu",
                       "workoutdetector_tpu/ops/pallas/conv1x1.py:92"),
    }
    # each kernel's launches on its main path: inference (phase 4) for the
    # forward kernels, the block path (5) for the shift, training (6) for
    # the 1x1 backward kernels
    main_launches = dict(launches, temporal_shift=blk_launches["temporal_shift"],
                         conv1x1_dx=train_launches["conv1x1_dx"],
                         conv1x1_dw=train_launches["conv1x1_dw"])
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
                    "train_clips_per_s": clips_s, "card": card}))
    log(f"card: {card_line()}")
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
