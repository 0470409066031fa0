#!/usr/bin/env python3
"""The shift-matmul kernel of the PyTorch port at every TSM-R50 224² site,
beside cuBLAS's unshifted product, on one CUDA card.

    python3 tools/shift_matmul_bench.py [--repo DIR] [--tag NAME] [--iters 20]

Runs ``kernels.shift_matmul`` of ``DIR``'s ``workoutdetector_tpu_torch``
(default: this checkout) at ``chip_smoke.py``'s sites: the 10 shifted
conv1 launches of an inference forward at 16 clips (128 frames) and the
16 of a train step at batch 32 (256 frames), bf16, random inputs from
a seeded torch generator. Per site: the kernel held to its plain
version by ``chip_smoke.check_close``, then CUDA-event means over
``--iters`` launches of the kernel, of the kernel without the shift (fold
0: its GEMM alone) and of ``torch.matmul`` on the same rows without the
shift, and the site's bound (max of its bytes over 3.35
TB/s and its operations over 989 TFLOP/s). Two checkouts are compared on
one card by one process each, alternated (parent, tree, tree, parent).

Prints one JSON line last: per forward and per train step the kernel's,
the library's and the bound's ms, and each site's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import sys
from pathlib import Path

TREE = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repo", type=Path, default=TREE,
                    help="checkout whose workoutdetector_tpu_torch runs")
    ap.add_argument("--tag", default="")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.repo.resolve()))
    spec = importlib.util.spec_from_file_location("chip_smoke", TREE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import torch

    from workoutdetector_tpu_torch.ops import kernels
    if not torch.cuda.is_available():
        print("shift_matmul_bench: no CUDA device", file=sys.stderr)
        return 2
    card = smoke.card_line()
    g = torch.Generator(device="cuda").manual_seed(0)
    frames_t = smoke.TRAIN_BATCH * smoke.FRAMES
    sites = [("forward", smoke.WINDOW_BATCH * smoke.FRAMES, h, c, o, n)
             for h, _, c, o, n in smoke.SHIFT_MATMUL_SITES]
    sites += [("train", frames_t, h, c, o, n)
              for h, c, o, shifted, n in smoke.BWD_SITES if shifted]
    totals = {}
    rows = []
    for where, frames, h, c, o, count in sites:
        x = torch.randn(frames, h, h, c, generator=g, device="cuda").bfloat16()
        w = (torch.randn(c, o, generator=g, device="cuda") / math.sqrt(c)).bfloat16()
        got = kernels.shift_matmul(x, w, smoke.FRAMES, 8)
        err = smoke.check_close(torch, f"shift_matmul {where} {tuple(x.shape)}x{o}",
                                got, kernels.shift_matmul_plain(x, w, smoke.FRAMES, 8))
        del got
        ms = smoke.time_ms(torch, lambda: kernels.shift_matmul(x, w, smoke.FRAMES, 8),
                           args.iters)
        flat = x.view(-1, c)
        lms = smoke.time_ms(torch, lambda: torch.matmul(flat, w), args.iters)
        # the kernel without the shift (fold 0): its GEMM alone
        ums = smoke.time_ms(
            torch, lambda: kernels.shift_matmul(x, w, smoke.FRAMES, c + 1), args.iters)
        m = flat.shape[0]
        bound = max(smoke.bound_ms((m * c + c * o + m * o) * 2, 2.0 * m * c * o))
        t = totals.setdefault(where, [0.0, 0.0, 0.0])
        for i, v in enumerate((ms, lms, bound)):
            t[i] += v * count
        rows.append(dict(where=where, m=m, c=c, o=o, count=count, err=err, ms=ms,
                         unshifted_ms=ums, library_ms=lms, bound_ms=bound))
        print(f"  {args.tag} {where} M={m} C={c} O={o} x{count}: kernel {ms:.4f} ms "
              f"(unshifted {ums:.4f}) library (unshifted x @ W) {lms:.4f} ms "
              f"bound {bound:.4f} ms ratio {ms / lms:.3f} err {err}", flush=True)
        del x, w, flat
        torch.cuda.empty_cache()
    for where, (ms, lms, bound) in totals.items():
        print(f"  {args.tag} per {where}: kernel {ms:.4f} ms library {lms:.4f} ms "
              f"({ms / lms:.3f}x) bound {bound:.4f} ms ({ms / bound:.2f}x) on {card}",
              flush=True)
    print(json.dumps({"tag": args.tag, "card": card, "per": {
        where: dict(ms=ms, library_ms=lms, bound_ms=bound)
        for where, (ms, lms, bound) in totals.items()}, "sites": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
