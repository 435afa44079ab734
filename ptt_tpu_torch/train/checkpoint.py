"""Checkpoints (the JAX package's ``train/checkpoint.py``): rolling retention of
the newest ``max_to_keep`` epochs, ``latest_epoch`` and auto-resume of model,
optimizer and step; and model-only ``.npz`` files in the JAX package's flat
layout (``save_variables_npz``), which its loader and ``convert.py`` read.

A training checkpoint is one ``torch.save`` file per epoch,
``checkpoint_epoch_<N>.pth``, holding {model, optimizer, step, epoch}; it is
written to a temporary name and renamed, so a reader never sees half a file.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import torch

from ..convert import variables_from_state_dict

_NAME = re.compile(r"^checkpoint_epoch_(\d+)\.pth$")


class CheckpointManager:
    """Training checkpoints of one run directory."""

    def __init__(self, ckpt_dir, max_to_keep: int = 30):
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _path(self, epoch: int) -> Path:
        return self.ckpt_dir / f"checkpoint_epoch_{int(epoch)}.pth"

    def epochs(self) -> list:
        """The saved epochs, oldest first."""
        return sorted(int(m.group(1)) for p in self.ckpt_dir.iterdir() if (m := _NAME.match(p.name)))

    def latest_epoch(self):
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, model, optimizer, epoch: int, step: int) -> Path:
        path = self._path(epoch)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                    "step": int(step), "epoch": int(epoch)}, tmp)
        os.replace(tmp, path)
        for old in self.epochs()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            self._path(old).unlink()
        return path

    def restore(self, model, optimizer, epoch: int | None = None):
        """Load model and optimizer from ``epoch`` (default: the newest).
        Returns (epoch, step); (0, 0) when there is no checkpoint."""
        epoch = self.latest_epoch() if epoch is None else int(epoch)
        if epoch is None:
            return 0, 0
        device = next(model.parameters()).device
        payload = torch.load(self._path(epoch), map_location=device, weights_only=True)
        model.load_state_dict(payload["model"], strict=True)
        optimizer.load_state_dict(payload["optimizer"])
        return int(payload["epoch"]), int(payload["step"])


def save_variables_npz(path, model, metadata: dict | None = None) -> None:
    """Model-only checkpoint as one ``.npz`` in the JAX package's flat layout:
    ``params/<flax path>`` and ``batch_stats/<flax path>`` arrays, and
    ``__meta__/<key>`` for ``metadata`` (str -> number or str)."""
    arrays = variables_from_state_dict(model.state_dict())
    for key, value in (metadata or {}).items():
        arrays[f"__meta__/{key}"] = np.asarray(value)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
