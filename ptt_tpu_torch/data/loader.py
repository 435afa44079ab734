"""Batch loader (the JAX package's ``data/loader.py``): epoch-seeded shuffling,
``drop_last``, collation into (B, ...) numpy arrays (or, for test items, lists
of whole tracklets), and a thread pool that builds the items of the next
batches while the device trains on the current one (item construction is numpy
work that releases the GIL). The train step uploads each batch to the device.
``build_dataloader`` makes a dataset by its DATA_CONFIG.DATASET name and its
loader, for training or for tests.

Under data parallelism each of ``num_shards`` processes loads its shard of
every global batch: the indices ``batch_idx[shard_id::num_shards]``, as the JAX
loader takes them. ``batch_size`` stays the global batch. Items are seeded by
(seed, index), so a shard's items equal the same items of the one-process
batch.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PREFETCH = 2  # batches built ahead of the consumer


def default_collate(items):
    """A list of dict items -> a dict of stacked (B, ...) arrays."""
    return {key: np.stack([it[key] for it in items], axis=0) for key in items[0]}


def identity_collate(items):
    """Test items: a batch is the list of its whole tracklets."""
    return items


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_workers: int = 4, collate_fn=default_collate, num_shards: int = 1,
                 shard_id: int = 0):
        if not 0 <= shard_id < num_shards:
            raise ValueError(f"shard {shard_id} of {num_shards}")
        if drop_last and batch_size % num_shards:
            # the JAX mesh refuses a batch its devices do not divide
            raise ValueError(f"a training batch of {batch_size} does not split over {num_shards} processes")
        self.num_shards = num_shards
        self.shard_id = shard_id
        self.dataset = dataset
        self.collate_fn = collate_fn
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """The shuffle order of each epoch is seeded by (seed, epoch)."""
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else (n + self.batch_size - 1) // self.batch_size

    def batch_indices(self):
        """The dataset indices of this shard of each batch of the current
        epoch, in order; a shard left empty by a short last batch is skipped."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch])).permutation(n)
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        shards = (order[start:start + self.batch_size][self.shard_id::self.num_shards]
                  for start in range(0, stop, self.batch_size))
        return [idx for idx in shards if len(idx)]

    def __iter__(self):
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        out_q: queue.Queue = queue.Queue(maxsize=_PREFETCH)
        done = object()
        stop = threading.Event()

        def produce():
            try:
                for batch_idx in self.batch_indices():
                    if stop.is_set():
                        return
                    out_q.put(self.collate_fn(list(pool.map(self.dataset.__getitem__, batch_idx))))
            except BaseException as e:  # surface worker errors to the consumer
                out_q.put(e)
            finally:
                out_q.put(done)

        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        try:
            while True:
                item = out_q.get()
                if item is done:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            while producer.is_alive():  # unblock a producer waiting on a full queue
                try:
                    out_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            pool.shutdown(wait=True, cancel_futures=True)


def build_dataloader(dataset_cfg: dict, class_names, batch_size: int, root_path=None, workers: int = 4, logger=None,
                     training: bool = True, seed: int = 0, num_shards: int = 1, shard_id: int = 0):
    """The dataset DATA_CONFIG.DATASET names and its loader: shuffled, stacked
    train batches without the last partial batch, or sequential batches of
    whole test tracklets; shard ``shard_id`` of ``num_shards`` of each.
    Returns (dataset, loader)."""
    from . import ALL_DATASETS

    dataset = ALL_DATASETS[dataset_cfg["DATASET"]](dataset_cfg=dataset_cfg, class_names=class_names,
                                                   training=training, root_path=root_path, logger=logger, seed=seed)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=training, drop_last=training, seed=seed,
                        num_workers=workers, collate_fn=default_collate if training else identity_collate,
                        num_shards=num_shards, shard_id=shard_id)
    return dataset, loader
