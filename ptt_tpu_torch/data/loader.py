"""Batch loader (the JAX package's ``data/loader.py``): epoch-seeded shuffling,
``drop_last``, collation into (B, ...) numpy arrays, and a thread pool that
builds the items of the next batches while the device trains on the current
one (item construction is numpy work that releases the GIL). The train step
uploads each batch to the device.
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


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
                 seed: int = 0, num_workers: int = 4):
        self.dataset = dataset
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
        """The dataset indices of each batch of the current epoch, in order."""
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch])).permutation(n)
        else:
            order = np.arange(n)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        return [order[start:start + self.batch_size] for start in range(0, stop, self.batch_size)]

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
                    out_q.put(default_collate(list(pool.map(self.dataset.__getitem__, batch_idx))))
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
