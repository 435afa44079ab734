"""Logging, seeding and the running-statistics meter of the JAX package's
``utils/common.py``."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


def create_logger(log_file=None, rank: int = 0, log_level=logging.INFO) -> logging.Logger:
    """A logger that writes to the console and, given ``log_file``, to that
    file. Ranks other than 0 of a process group log errors only."""
    level = log_level if rank == 0 else logging.ERROR
    logger = logging.getLogger(f"ptt_tpu_torch.rank{rank}.{log_file}")
    logger.setLevel(level)
    logger.propagate = False
    if logger.handlers:
        return logger
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    handlers = [logging.StreamHandler()]
    if log_file is not None:
        handlers.append(logging.FileHandler(str(log_file)))
    for handler in handlers:
        handler.setLevel(level)
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    return logger


def set_manual_seed(seed: int) -> None:
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


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
