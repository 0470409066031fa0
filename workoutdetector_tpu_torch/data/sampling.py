"""Temporal frame sampling.

The port's own copy of ``sample_frames`` and ``tdn_sample_indices`` from
``workoutdetector_tpu/data/sampling.py``: uniform-interval segment
sampling with per-segment jitter, and TDN's burst starts, drawn from an
explicit numpy Generator, so a data pipeline repeats per seed.
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



def tdn_sample_indices(total: int,
                       num_segments: int = 8,
                       num_frames: int = 5,
                       rng: Optional[np.random.Generator] = None,
                       random: bool = True) -> np.ndarray:
    """TDN's burst sampler: ``num_segments`` start indices (0-based), from
    each of which the caller reads ``num_frames`` consecutive frames.
    Jittered per segment when ``random``, else the middle of each
    segment. Where fewer than ``num_segments`` bursts fit, the span is
    taken as ``total − 5 + 1`` whatever ``num_frames`` is, as the
    reference's sampler does."""
    if rng is None:
        rng = np.random.default_rng()

    def randint(upper: int, size: Optional[int] = None):
        if not random:
            if size is None:
                return upper // 2
            return np.full(size, upper // 2, dtype=np.int64)
        return rng.integers(0, upper, size=size)

    if (total - num_frames + 1) < num_segments:
        average_duration = (total - 5 + 1) // num_segments
    else:
        average_duration = (total - num_frames + 1) // num_segments
    if average_duration > 0:
        offsets = np.multiply(np.arange(num_segments), average_duration) + \
            randint(average_duration, size=num_segments)
    elif total > num_segments:
        if (total - num_frames + 1) >= num_segments:
            offsets = np.sort(randint(total - num_frames + 1,
                                      size=num_segments))
        else:
            offsets = np.sort(randint(total - 5 + 1, size=num_segments))
    else:
        offsets = np.zeros((num_segments,))
    return np.asarray(offsets).astype(int)
