"""Temporal frame sampling.

The port's own copy of ``sample_frames`` from
``workoutdetector_tpu/data/sampling.py``: uniform-interval segment
sampling with per-segment jitter drawn from an explicit numpy Generator,
so a data pipeline repeats per seed. (TDN's burst sampler,
``tdn_sample_indices``, comes with TDN: ROADMAP §1 item 6.)
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np


def sample_frames(total: int,
                  num: int,
                  offset: int = 0,
                  random: bool = True,
                  rng: Optional[np.random.Generator] = None) -> List[int]:
    """Uniform-interval segment sampling with optional per-segment jitter.

    If ``total < num`` frames are repeated (ceil(num/total) each) before
    sampling. Returns ``num`` indices offset by ``offset``.

        >>> sample_frames(4, 8, 0, False)
        [0, 0, 1, 1, 2, 2, 3, 3]
        >>> sample_frames(10, 8, 0, False)
        [0, 1, 2, 3, 4, 5, 6, 7]
        >>> sample_frames(40, 8, 0, False)
        [0, 5, 10, 15, 20, 25, 30, 35]
    """
    if rng is None:
        rng = np.random.default_rng()
    if total < num:
        repeats = math.ceil(num / total)
        data = [x for x in range(total) for _ in range(repeats)]
        total = len(data)
    else:
        data = list(range(total))
    interval = total // num
    indices = np.arange(0, total, interval)[:num]
    if random and interval > 0:
        for i, x in enumerate(indices):
            if i == num - 1:
                upper = total
                rand = int(rng.integers(0, upper - x))
            else:
                upper = min(interval * (i + 1), total)
                rand = int(rng.integers(0, interval))
            indices[i] = (x + rand) % upper
    assert len(indices) == num
    return [data[i] + offset for i in indices]

