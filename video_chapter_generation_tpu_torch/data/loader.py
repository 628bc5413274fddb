"""Batch loader: deterministic shuffling, dict collation, threaded prefetch.

The port's own copy of video_chapter_generation_tpu/data/loader.py (the definitions the port uses;
each names the line it was copied from), so the port never imports
the JAX package.
"""

from __future__ import annotations
import queue
import threading
from typing import Dict, Iterator, List
import numpy as np
from ..core.metrics import span
from ..core.seeding import host_rng


def collate(items: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stacks the items' arrays, under a "collate" span (rows) on the
    thread's current timer (core/metrics.py).

    Copied from video_chapter_generation_tpu/data/loader.py:21."""
    out = {}
    with span("collate", len(items)):
        for k in items[0]:
            out[k] = np.stack([it[k] for it in items])
    return out


class DataLoader:
    """Copied from video_chapter_generation_tpu/data/loader.py:28."""
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 123,
        drop_last: bool = True,
        num_shards: int = 1,
        shard_index: int = 0,
        prefetch: int = 2,
        num_threads: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.prefetch = prefetch
        self.num_threads = num_threads

    def _indices(self, epoch: int) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            idx = host_rng(self.seed, epoch).permutation(n)
        # DistributedSampler-style shard: pad to a multiple, stride-slice
        if self.num_shards > 1:
            per = -(-n // self.num_shards)
            padded = np.resize(idx, per * self.num_shards)
            idx = padded[self.shard_index :: self.num_shards]
        return idx

    def batches_per_epoch(self) -> int:
        n = len(self._indices(0))
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __call__(self, epoch: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        idx = self._indices(epoch)
        nb = len(idx) // self.batch_size if self.drop_last else -(
            -len(idx) // self.batch_size
        )

        def make_batch(b: int) -> Dict[str, np.ndarray]:
            rows = idx[b * self.batch_size : (b + 1) * self.batch_size]
            items = [self.dataset.__getitem__(int(i), epoch) for i in rows]
            return collate(items)

        if self.prefetch <= 0 or nb <= 1:
            for b in range(nb):
                yield make_batch(b)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = object()

        def producer():
            try:
                for b in range(nb):
                    q.put(make_batch(b))
            finally:
                q.put(stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is stop:
                break
            yield item
        t.join()
