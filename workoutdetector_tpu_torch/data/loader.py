"""Host data loader: threaded item fetch → fixed-shape uint8 batches.

Port of ``workoutdetector_tpu/data/loader.py`` (``DataLoader``) for one
process: worker threads fetch items, batches are stacked into contiguous
arrays, and a queue keeps ``PREFETCH`` batches ready. The order and every
item's generator depend only on (seed, epoch, index), so a pass started at
``set_epoch(epoch, start_batch)`` yields exactly the batches an
uninterrupted pass yields from that position (exact mid-epoch resume).
Train drops the tail batch (``drop_last=True``); eval keeps every sample
by zero-padding the tail to ``batch_size`` with label -1, which consumers
mask.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterator, Tuple

import numpy as np

PREFETCH = 2  # batches kept ready ahead of the consumer


class DataLoader:
    """Deterministic prefetching loader.

    Args:
        dataset: object with __len__ and __getitem__(idx, rng) → (array, label).
        batch_size: clips per batch.
        shuffle: reshuffle each epoch (seeded by seed + epoch).
        num_workers: fetch threads.
        seed: base seed of the order and of every item's generator.
        drop_last: True drops the tail partial batch; False pads it to
            batch_size with zero clips labelled -1.
    """

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.start_batch = 0

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.dataset) // self.batch_size
        return -(-len(self.dataset) // self.batch_size)

    def set_epoch(self, epoch: int, start_batch: int = 0) -> None:
        """Position the next pass: epoch ``epoch``, skipping its first
        ``start_batch`` batches without fetching them."""
        self.epoch = epoch
        self.start_batch = start_batch

    def _item_rng(self, idx: int) -> np.random.Generator:
        return np.random.default_rng(
            (self.seed * 1_000_003 + self.epoch * len(self.dataset) + idx)
            & 0x7FFFFFFF)

    def _fetch(self, idx: int) -> Tuple[np.ndarray, int]:
        return self.dataset.__getitem__(int(idx), self._item_rng(int(idx)))

    def _batches(self, order: np.ndarray, out_q: "queue.Queue",
                 stop: threading.Event) -> None:
        n = len(order)
        with ThreadPoolExecutor(self.num_workers) as pool:
            for b in range(min(self.start_batch, len(self)), len(self)):
                if stop.is_set():
                    return
                idxs = order[b * self.batch_size:min((b + 1) * self.batch_size, n)]
                items = list(pool.map(self._fetch, idxs))
                xs = np.stack([it[0] for it in items])
                ys = np.asarray([it[1] for it in items], dtype=np.int32)
                pad = self.batch_size - len(items)
                if pad:  # eval tail: same shape, pad rows labelled -1
                    xs = np.concatenate(
                        [xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
                    ys = np.concatenate([ys, np.full((pad,), -1, np.int32)])
                if not _put(out_q, (xs, ys), stop):
                    return

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        if len(self) == 0:
            return
        out_q: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def producer():
            try:
                self._batches(order, out_q, stop)
            except Exception as e:  # surface worker errors to the consumer
                _put(out_q, e, stop)
            else:
                _put(out_q, None, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            while not out_q.empty():  # let a blocked producer see stop
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
            t.join()


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Enqueue unless the consumer has gone away; True when enqueued."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False
