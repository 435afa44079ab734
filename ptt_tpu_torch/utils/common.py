"""The running-statistics meter of the JAX package's ``utils/common.py``."""

from __future__ import annotations


class AverageMeter:
    """Running mean and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(1, self.count)
