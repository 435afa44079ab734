"""Datasets for ``tests/test_torch_port_loader.py`` that the loader's worker
processes unpickle: a module that imports nothing heavy (a class defined in
the test file would make each worker import the JAX package)."""

import os

import numpy as np


class Raising:
    """Items 0..15 as {"i": i}; item 5 raises, or with ``die`` ends the worker
    process that builds it."""

    def __init__(self, die=False):
        self.die = die

    def __len__(self):
        return 16

    def __getitem__(self, i):
        if i == 5:
            if self.die:
                os._exit(3)
            raise ValueError("item 5 is broken")
        return {"i": np.asarray(i)}


class Range:
    """Items 0..n-1 as {"i": i}."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}
