"""Each process's rows of the global batch (data-parallel training).

A process of the port is a device of the JAX mesh: step s of a W-process
run takes the same global batch as step s of a one-process run, the
`data.batch_size` rows that the loader's seeded order gives it, and
process r of W keeps the contiguous block r of them (P("data"), as
parallel/mesh.py:shard_rows splits a batch). So a W-process run equals
the one-process run step for step, whatever W. The JAX package's
train_segment instead strides the dataset over processes
(`num_shards=jax.process_count()`, cli/train_segment.py:102-106), under
which the batches a step sees depend on the number of processes; the
port does not copy that.

Every process draws the same order (the loader's seed) and decodes only
its own rows: the rows are chosen before `dataset.__getitem__`.
"""

from __future__ import annotations

import numpy as np

from ..data.loader import DataLoader


class RankLoader(DataLoader):
    """The rows of process `index` of `count` (the data axis) in each
    global batch of `loader` (a DataLoader of the global batch size that
    drops its last short batch, as every training loader does)."""

    def __init__(self, loader: DataLoader, index: int, count: int):
        if loader.num_shards != 1 or not loader.drop_last:
            raise ValueError("RankLoader splits the global batches of an "
                             "unsharded loader that drops its last short "
                             "batch")
        if loader.batch_size % count:
            raise ValueError(f"global batch {loader.batch_size} not "
                             f"divisible by the {count} processes of the "
                             "data axis; pick data.batch_size divisible by "
                             "it")
        super().__init__(loader.dataset, loader.batch_size // count,
                         shuffle=loader.shuffle, seed=loader.seed,
                         drop_last=True, prefetch=loader.prefetch,
                         num_threads=loader.num_threads)
        self.global_batch = loader.batch_size
        self.index, self.count = index, count

    def _indices(self, epoch: int) -> np.ndarray:
        """The global order's batches, block `index` of each, in order."""
        idx = super()._indices(epoch)
        nb = len(idx) // self.global_batch
        blocks = idx[:nb * self.global_batch].reshape(nb, self.count, -1)
        return blocks[:, self.index].reshape(-1)


def rank_loader(loader: DataLoader, index: int, count: int) -> DataLoader:
    """loader itself for one process, else its RankLoader."""
    return loader if count == 1 else RankLoader(loader, index, count)
