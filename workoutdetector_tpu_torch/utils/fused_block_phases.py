#!/usr/bin/env python3
"""Where the wgmma fused bottleneck's time goes, on one CUDA card.

    python3 -m workoutdetector_tpu_torch.utils.fused_block_phases

Copies this checkout's ``workoutdetector_tpu_torch`` into a temporary
directory inside the checkout, adds clock64() timers to the copy's
``csrc/fused_block.cu`` (the package itself is not touched), builds it and
runs the kernel once at each TSM-R50 fused site (16 clips, random bf16
inputs). Block 0 prints, for each warpgroup and its first three tile
pairs, the cycles of each phase — conv1 with the y1 epilogue (of which
the last y1 epilogue, and the waits for the x chunks), conv2, the y2
epilogue, conv3 with its epilogues — and, summed over the pair, the
cycles thread 0 spent feeding the weight ring (``fill``: issuing tiles,
and waiting for a stage both warpgroups have freed) and waiting for a
tile to land (``full``). The timers and printf slow the kernel: compare
phases with each other, and take kernel times from ``chip_smoke.py``.
"""

from __future__ import annotations

import math
import shutil
import sys
import tempfile
from pathlib import Path

TREE = Path(__file__).resolve().parents[2]  # the checkout

# (anchor in csrc/fused_block.cu, text that replaces it)
PATCHES = [
    ('#include "wd_wgmma.cuh"\n', '#include "wd_wgmma.cuh"\n#include <cstdio>\n'),
    ('''  for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x) {
    Tile next;''', '''  long long ck[6];
  int npair = 0;
  for (int pair = blockIdx.x; pair < p.pairs; pair += gridDim.x, ++npair) {
    ck[0] = clock64();
    Tile next;'''),
    ('''    wd::named_barrier(1 + wg, WG);  // y1 is complete
''', '''    wd::named_barrier(1 + wg, WG);  // y1 is complete
    ck[2] = clock64();
'''),
    ('''    // conv3's first residual x in flight''', '''    ck[3] = clock64();
    // conv3's first residual x in flight'''),
    ('''    // ---- conv3 (+ downsample) + residual + ReLU, 64 columns of O a pass''',
     '''    ck[4] = clock64();
    // ---- conv3 (+ downsample) + residual + ReLU, 64 columns of O a pass'''),
    ('''  auto next_w = [&]() {
    if (feeder) feed.fill(taken);
    wd::mbar_wait(&full[taken % STAGES], (taken / STAGES) & 1);''', '''  long long wfill = 0, wfull = 0, wx = 0;
  auto next_w = [&]() {
    const long long c0 = clock64();
    if (feeder) feed.fill(taken);
    const long long c1 = clock64();
    wd::mbar_wait(&full[taken % STAGES], (taken / STAGES) & 1);
    wfill += c1 - c0;
    wfull += clock64() - c1;'''),
    ('''        if (q < NB)
          cp_async_wait<NB>();
        else
          cp_async_wait<NB - 1>();''', '''        const long long cx = clock64();
        if (q < NB)
          cp_async_wait<NB>();
        else
          cp_async_wait<NB - 1>();
        wx += clock64() - cx;'''),
    ('''      if (nb == NF - 1) {''', '''      ck[1] = clock64();
      if (nb == NF - 1) {'''),
    ('''    tl = next;
  }''', '''    ck[5] = clock64();
    if (blockIdx.x == 0 && t == 0 && npair < 3)
      printf("  wg%d pair%d: conv1+y1 %lld (last y1 epilogue %lld, x waits %lld) conv2 %lld "
             "y2 %lld conv3 %lld | fill %lld full %lld\\n",
             wg, npair, ck[2] - ck[0], ck[2] - ck[1], wx, ck[3] - ck[2], ck[4] - ck[3],
             ck[5] - ck[4], wfill, wfull);
    wfill = wfull = wx = 0;
    tl = next;
  }'''),
]


def main() -> int:
    sys.path.insert(0, str(TREE))
    import chip_smoke as smoke
    import torch
    if not torch.cuda.is_available():
        print("fused_block_phases: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(dir=TREE, prefix=".fused-phases-") as tmp:
        pkg = Path(tmp) / "workoutdetector_tpu_torch"
        shutil.copytree(TREE / "workoutdetector_tpu_torch", pkg,
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = pkg / "csrc" / "fused_block.cu"
        text = src.read_text()
        for anchor, new in PATCHES:
            if anchor not in text:
                raise SystemExit(f"fused_block_phases: anchor not found: {anchor[:60]!r}")
            text = text.replace(anchor, new, 1)
        src.write_text(text)
        sys.path.insert(0, tmp)
        for name in [m for m in sys.modules if m.startswith("workoutdetector_tpu_torch")]:
            del sys.modules[name]
        from workoutdetector_tpu_torch.ops import kernels
        print(f"card: {smoke.card_line()}", flush=True)
        g = torch.Generator(device="cuda").manual_seed(0)

        def randn(*shape, scale=1.0):
            return (torch.randn(*shape, generator=g, device="cuda") * scale).bfloat16()

        def sb(n):
            return torch.stack([torch.rand(n, generator=g, device="cuda") * 0.5 + 0.5,
                                torch.randn(n, generator=g, device="cuda") * 0.1]).contiguous()

        frames = smoke.WINDOW_BATCH * smoke.FRAMES
        for h, w, c, f, o, ds, _ in smoke.FUSED_SITES:
            x = randn(frames, h, w, c)
            p = kernels.FusedBlockParams(
                randn(c, f, scale=math.sqrt(2 / c)).contiguous(), sb(f),
                randn(3, 3, f, f, scale=math.sqrt(2 / (9 * f))).contiguous(), sb(f),
                randn(f, o, scale=math.sqrt(2 / f)).contiguous(), sb(o),
                randn(c, o, scale=math.sqrt(2 / c)).contiguous() if ds else None,
                sb(o) if ds else None)
            print(f"site {frames}x{h}x{w} C={c} F={f} O={o} ds={ds}: cycles", flush=True)
            kernels.fused_bottleneck(x, p, n_segment=smoke.FRAMES, fold=c // 8)
            torch.cuda.synchronize()
            sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
