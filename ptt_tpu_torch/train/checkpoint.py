"""Checkpoints (the JAX package's ``train/checkpoint.py``): rolling retention of
the newest ``max_to_keep`` epochs, ``latest_epoch`` and auto-resume of model,
optimizer and step; and model-only ``.npz`` files in the JAX package's flat
layout (``save_variables_npz``), which its loader and ``convert.py`` read.

A training checkpoint is one ``torch.save`` file per epoch,
``checkpoint_epoch_<N>.pth``, holding {model, optimizer, step, epoch}; it is
written to a temporary name and renamed, so a reader never sees half a file.
In a process group rank 0 writes, and every rank waits at a barrier until the
file is there; every rank restores from the same file.

``load_params_from_file`` loads a model from any of three files: such a
checkpoint, a JAX-package ``.npz``, or a ``.pth`` in the reference code's
layout ({'model_state': state_dict, 'epoch': ...} or a bare state_dict, keyed
as ``convert.reference_state_dict`` writes). All are read with
``torch.load(weights_only=True)`` or ``np.load(allow_pickle=False)``.
"""

from __future__ import annotations

import os
import re
from pathlib import Path

import numpy as np
import torch

from ..convert import reference_key, state_dict_from_npz, state_dict_from_reference, variables_from_state_dict
from ..utils.dist import barrier, get_dist_info

_NAME = re.compile(r"^checkpoint_epoch_(\d+)\.pth$")


class CheckpointManager:
    """Training checkpoints of one run directory."""

    def __init__(self, ckpt_dir, max_to_keep: int = 30):
        self.ckpt_dir = Path(ckpt_dir).resolve()
        self.ckpt_dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = int(max_to_keep)

    def _path(self, epoch: int) -> Path:
        return self.ckpt_dir / f"checkpoint_epoch_{int(epoch)}.pth"

    @staticmethod
    def epochs_in(ckpt_dir) -> list:
        """The epochs of the ``checkpoint_epoch_<N>.pth`` files in ``ckpt_dir``, oldest first."""
        return sorted(int(m.group(1)) for p in Path(ckpt_dir).iterdir() if (m := _NAME.match(p.name)))

    def epochs(self) -> list:
        """The saved epochs, oldest first."""
        return self.epochs_in(self.ckpt_dir)

    def latest_epoch(self):
        epochs = self.epochs()
        return epochs[-1] if epochs else None

    def save(self, model, optimizer, epoch: int, step: int) -> Path:
        """Write the checkpoint of ``epoch`` (rank 0 of a process group) and
        drop the oldest beyond ``max_to_keep``; every rank returns once it is
        written."""
        path = self._path(epoch)
        if get_dist_info()[0] == 0:
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict(),
                        "step": int(step), "epoch": int(epoch)}, tmp)
            os.replace(tmp, path)
            for old in self.epochs()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
                self._path(old).unlink()
        barrier()
        return path

    def restore(self, model, optimizer, epoch: int | None = None, path=None):
        """Load model and optimizer from ``path``, a training checkpoint, or
        else from ``epoch`` of this directory (default: the newest). Returns
        (epoch, step); (0, 0) when there is no checkpoint."""
        if path is None:
            epoch = self.latest_epoch() if epoch is None else int(epoch)
            if epoch is None:
                return 0, 0
            path = self._path(epoch)
        device = next(model.parameters()).device
        payload = torch.load(path, map_location=device, weights_only=True)
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


def resolve_checkpoint_path(path, epoch: int | None = None) -> Path:
    """A checkpoint argument -> a file: a file as it is; a run's ``ckpt``
    directory, or the run directory holding it, -> its
    ``checkpoint_epoch_<epoch>.pth`` (default: the newest)."""
    path = Path(path).resolve()
    if not path.exists():
        raise FileNotFoundError(f"checkpoint path {path} does not exist")
    if path.is_file():
        return path
    epochs = CheckpointManager.epochs_in(path)
    if not epochs and (path / "ckpt").is_dir():
        path = path / "ckpt"
        epochs = CheckpointManager.epochs_in(path)
    if not epochs:
        raise FileNotFoundError(f"no checkpoint_epoch_<N>.pth in {path}")
    path = path / f"checkpoint_epoch_{epochs[-1] if epoch is None else int(epoch)}.pth"
    if not path.exists():
        raise FileNotFoundError(f"checkpoint {path} does not exist")
    return path


def read_model_state(path, template: dict):
    """The model weights of a checkpoint file as (state_dict, problems): this
    package's keys, and the lines of what did not match ``template`` (the
    model's own state_dict) for a reference-layout file."""
    path = Path(path)
    if path.suffix == ".npz":
        return state_dict_from_npz(path), []
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(payload, dict) and "model" in payload and "optimizer" in payload:
        return payload["model"], []  # this package's training checkpoint
    state = payload.get("model_state", payload) if isinstance(payload, dict) else payload
    # the two layouts share the transformers' keys: the one naming more of the model's tensors is the file's
    ours = sum(key in template for key in state)
    theirs = sum(key in state for key in map(reference_key, template))
    return (state, []) if ours >= theirs else state_dict_from_reference(state, template)


def load_params_from_file(path, model, logger=None, strict: bool = True) -> None:
    """Load the weights of ``path`` (see the module's docstring) into ``model``.
    ``strict``: every weight of the model, of its shape, and nothing else, or
    ValueError. Otherwise the weights found with the model's shape are loaded,
    the rest keep their values, and each miss is logged."""
    emit = logger.info if logger is not None else (lambda *a: None)
    template = model.state_dict()
    state, problems = read_model_state(path, template)
    loaded = {}
    for key, tmpl in template.items():
        src = state.get(key)
        if src is None and key.endswith("num_batches_tracked"):
            loaded[key] = tmpl
        elif src is None:
            problems.append(f"missing: {key}")
        elif tuple(src.shape) != tuple(tmpl.shape):
            problems.append(f"shape: {key} {tuple(tmpl.shape)} vs checkpoint {tuple(src.shape)}")
        else:
            loaded[key] = src
    problems += [f"unused: {k}" for k in state if k not in template]
    if strict and problems:
        raise ValueError(f"{path} does not match the model:\n" + "\n".join(problems))
    for line in problems:
        emit(f"checkpoint {line} (kept the model's value)")
    model.load_state_dict(loaded, strict=strict)
    emit(f"loaded {len(loaded)}/{len(template)} tensors from {path}")
