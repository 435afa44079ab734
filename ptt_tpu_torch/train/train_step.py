"""The train step (the JAX package's ``train/train_state.py`` ``make_train_step``):
upload the batch, forward in train mode, losses, backward, clip and Adam.

One device, float32, one step per call. The JAX package's mesh, K-step scan
and bf16 options are not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..nn.losses import compute_losses
from .bn_momentum import MODEL_BN_MOMENTUM, set_bn_momentum


def to_device(batch: dict, device) -> dict:
    """A loader batch (dict of numpy arrays or tensors) as float32/int tensors on
    ``device``."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        out[key] = t.to(device, non_blocking=True)
    return out


def make_train_step(model_cfg: dict, device="cuda"):
    """Returns ``step(model, optimizer, batch, bn_momentum=None) -> metrics``.

    ``model`` is the tracker on ``device`` (CUDA unless the caller asks for the
    CPU), ``optimizer`` a ``train.optim.Adam`` over its parameters, ``batch`` a
    loader batch. ``bn_momentum``, the scheduled flax momentum, replaces
    MODEL_BN_MOMENTUM in every BatchNorm for this step. ``metrics`` are the loss
    terms, ``loss`` and ``grad_norm`` (before clipping), 0-dim tensors still on
    the device."""
    device = resolve_device(device)

    def step(model, optimizer, batch, bn_momentum=None):
        model.train()
        set_bn_momentum(model, MODEL_BN_MOMENTUM if bn_momentum is None else bn_momentum)
        batch = to_device(batch, device)
        out = model(batch)
        loss, tb = compute_losses(model_cfg, out, batch)
        optimizer.zero_grad()
        loss.backward()
        metrics = {k: v.detach() for k, v in tb.items()}
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step
