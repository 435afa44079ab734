"""Batch loader (the JAX package's ``data/loader.py``): epoch-seeded shuffling,
``drop_last``, collation into (B, ...) numpy arrays (or, for test items, lists
of whole tracklets), built by worker processes while the device trains on the
current batch. The trainer uploads each batch to the device
(``train/train_step.py`` ``BatchUploader``). ``build_dataloader`` makes a
dataset by its DATA_CONFIG.DATASET name and its loader, for training or for
tests.

Workers are processes of PyTorch's own ``torch.utils.data.DataLoader``, as the
reference PTT trained: item construction is numpy and Python work on small
arrays, which a thread pool runs one thread at a time under the interpreter
lock. Its batch sampler yields ``batch_indices()`` of the current epoch, so a
worker builds one whole batch and collates it; items are seeded by (seed,
index), so which worker builds a batch does not change it, and the batches
equal those built in the main process (``num_workers`` 0) bit for bit.

- Workers start by ``forkserver``, never by ``fork`` from this process: a
  fork copies whatever locks the parent's other threads hold (the gloo
  backend's threads, CUDA's, the profiler's), and a child that touches one of
  them hangs. The fork server is a fresh interpreter, started once per process
  when the first loader with workers is made, that imports this package (and
  with it PyTorch, while the caller goes on) and nothing else, and forks each
  worker; it exits with the process. (``spawn`` is as safe but starts the
  workers one after another, each a new interpreter: the parent's write of
  the pickled dataset waits until the child has imported PyTorch. On the
  H100's host 8 workers took about 50 s to a first batch by ``spawn``, under
  3 s by the fork server: ``chip_smoke.py --loader-start``, PERF.md.) Each
  worker gets a pickled copy of the dataset (the KITTI dataset pickles its
  tracklets: train crops, or whole clouds for tests), so a dataset must be
  picklable, its class at module level of an importable module, no lambda;
  and each worker imports the main module, so a script that makes a loader
  guards its entry point with ``if __name__ == "__main__"``.
- The workers persist across epochs (``set_epoch`` reorders the next pass) and
  stop with ``close()``, or when the loader is collected. Breaking out of an
  epoch stops nothing: the next ``iter()`` drops what the workers built ahead.
- A loader never starts more workers than an epoch has batches; each worker
  runs PyTorch on one thread. A test item is a whole tracklet the dataset
  already holds, which a worker only copies (twice: the dataset to it, the
  tracklet back), so the CLIs load test items in the calling process unless
  ``--workers`` asks otherwise. Under ``torchrun`` every rank starts its own
  workers, and on one host the ranks' workers share its cores.
- An item that raises, raises in the consumer; a worker that dies raises
  ``RuntimeError`` there. Nothing falls back to threads.

Under data parallelism each of ``num_shards`` processes loads its shard of
every global batch: the indices ``batch_idx[shard_id::num_shards]``, as the JAX
loader takes them. ``batch_size`` stays the global batch. Items are seeded by
(seed, index), so a shard's items equal the same items of the one-process
batch.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.forkserver
import weakref

import numpy as np
import torch
import torch.utils.data


def default_collate(items):
    """A list of dict items -> a dict of stacked (B, ...) arrays."""
    return {key: np.stack([it[key] for it in items], axis=0) for key in items[0]}


def identity_collate(items):
    """Test items: a batch is the list of its whole tracklets."""
    return items


def _init_worker(worker_id: int) -> None:
    torch.set_num_threads(1)


def _fork_server():
    """The ``forkserver`` context, its server preloading this package and
    started now (it imports PyTorch while the caller goes on)."""
    context = multiprocessing.get_context("forkserver")
    context.set_forkserver_preload([__name__])
    multiprocessing.forkserver.ensure_running()
    return context


class _EpochBatches(torch.utils.data.Sampler):
    """The batch sampler: ``loader.batch_indices()`` of the epoch current when
    an iteration starts. It holds the loader weakly, so that a loader dropped
    without ``close`` is collected at once and its workers stop."""

    def __init__(self, loader):
        self.loader = weakref.ref(loader)

    def __iter__(self):
        return iter(self.loader().batch_indices())

    def __len__(self):
        return len(self.loader().batch_indices())


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
        self.num_workers = max(0, num_workers)
        self.epoch = 0
        self._loader = None
        self._context = _fork_server() if min(self.num_workers, len(self)) else None

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
        if self._loader is None:
            workers = min(self.num_workers, len(self))
            self._loader = torch.utils.data.DataLoader(
                self.dataset, batch_sampler=_EpochBatches(self), collate_fn=self.collate_fn, num_workers=workers,
                persistent_workers=workers > 0, worker_init_fn=_init_worker if workers else None,
                multiprocessing_context=self._context if workers else None)
        return iter(self._loader)

    def close(self):
        """Stop the worker processes; a later iteration starts new ones."""
        loader, self._loader = self._loader, None
        iterator = getattr(loader, "_iterator", None)
        if iterator is not None and hasattr(iterator, "_shutdown_workers"):
            iterator._shutdown_workers()


def build_dataloader(dataset_cfg: dict, class_names, batch_size: int, root_path=None, workers: int = 4, logger=None,
                     training: bool = True, seed: int = 0, num_shards: int = 1, shard_id: int = 0):
    """The dataset DATA_CONFIG.DATASET names and its loader: shuffled, stacked
    train batches without the last partial batch, or sequential batches of
    whole test tracklets; shard ``shard_id`` of ``num_shards`` of each.
    Returns (dataset, loader)."""
    from . import ALL_DATASETS

    if workers:
        _fork_server()  # it imports PyTorch while the dataset is built
    dataset = ALL_DATASETS[dataset_cfg["DATASET"]](dataset_cfg=dataset_cfg, class_names=class_names,
                                                   training=training, root_path=root_path, logger=logger, seed=seed)
    loader = DataLoader(dataset, batch_size=batch_size, shuffle=training, drop_last=training, seed=seed,
                        num_workers=workers, collate_fn=default_collate if training else identity_collate,
                        num_shards=num_shards, shard_id=shard_id)
    return dataset, loader
