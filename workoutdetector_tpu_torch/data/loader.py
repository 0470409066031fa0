"""Host data loader: threaded item fetch → fixed-shape uint8 batches.

Port of ``workoutdetector_tpu/data/loader.py`` (``DataLoader``): worker
threads fetch items, batches are stacked into contiguous arrays, and a
queue keeps ``PREFETCH`` batches ready. In a data-parallel run each
process reads only its block of every global batch (``shard_id`` of
``num_shards``, ``parallel/mesh.host_batch_shard``). The order and every
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
from typing import Any, Iterator, Optional, Tuple

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
        shard_id / num_shards: ``batch_size`` stays the GLOBAL batch; this
            loader yields only its contiguous batch_size / num_shards
            sub-block of every global batch, in shard order, so the shards
            put together are the one-process batch. The order and every
            item's generator depend only on (seed, epoch, global index),
            and every shard has the same ``len``. On a padded tail batch
            each shard pads its own block (a later shard's block may be
            all pad rows).
    """

    def __init__(self, dataset: Any, batch_size: int, shuffle: bool = False,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True,
                 shard_id: int = 0, num_shards: int = 1):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard_id {shard_id} not in [0, {num_shards})")
        if batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by "
                             f"{num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.drop_last = drop_last
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.local_batch = batch_size // num_shards
        self.epoch = 0
        self.start_batch = 0
        self._item_shape: Optional[Tuple[Tuple[int, ...], Any]] = None

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
                # this shard's contiguous block of global batch b
                lo = b * self.batch_size + self.shard_id * self.local_batch
                hi = min(lo + self.local_batch, (b + 1) * self.batch_size, n)
                items = list(pool.map(self._fetch, order[lo:hi]))
                if items:
                    xs = np.stack([it[0] for it in items])
                    ys = np.asarray([it[1] for it in items], dtype=np.int32)
                    self._item_shape = (xs.shape[1:], xs.dtype)
                else:  # a tail batch can leave a later shard no item
                    shape, dtype = self._probe()
                    xs = np.zeros((0,) + shape, dtype)
                    ys = np.zeros((0,), np.int32)
                pad = self.local_batch - len(items)
                if pad:  # eval tail: same shape, pad rows labelled -1
                    xs = np.concatenate(
                        [xs, np.zeros((pad,) + xs.shape[1:], xs.dtype)])
                    ys = np.concatenate([ys, np.full((pad,), -1, np.int32)])
                if not _put(out_q, (xs, ys), stop):
                    return

    def _probe(self) -> Tuple[Tuple[int, ...], Any]:
        """An item's (shape, dtype), for a block of pad rows only: the
        dataset's ``item_shape`` where it declares one, else item 0's."""
        if self._item_shape is None:
            declared = getattr(self.dataset, "item_shape", None)
            if declared is not None:
                self._item_shape = (tuple(declared[0]), np.dtype(declared[1]))
            else:
                x0 = np.asarray(self._fetch(0)[0])
                self._item_shape = (x0.shape, x0.dtype)
        return self._item_shape

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
