"""The train step (the JAX package's ``train/train_state.py`` ``make_train_step``):
upload the batch, forward in train mode, losses, backward, clip and the
optimizer step.

One device, one step per call. With ``mixed_precision`` (OPTIMIZATION.
MIXED_PRECISION) the forward and backward run in bfloat16 as the JAX step runs
them: the parameters and the batch's floats are cast to bf16 inside the
differentiated function (``torch.func.functional_call`` on bf16 copies), so
their gradients flow back into the float32 master parameters, which the
optimizer and its state keep; the outputs are cast back to float32, the losses
are computed in float32 on the float32 batch, and the BatchNorm running
statistics stay float32. Each layer follows flax's type promotion, not
autocast (``nn/layers.py``). The JAX package's mesh and K-step scan are not
ported (ROADMAP.md).
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


def cast_floats(tree: dict, dtype) -> dict:
    """The dict with every floating-point tensor cast to ``dtype``."""
    return {k: v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() else v for k, v in tree.items()}


def forward(model, batch: dict, mixed_precision: bool = False) -> dict:
    """The train-mode forward of ``model`` on a device batch: as it is, or
    with ``mixed_precision`` on bf16 copies of the parameters and the batch's
    floats, the outputs cast back to float32."""
    if not mixed_precision:
        return model(batch)
    params = {name: p.to(torch.bfloat16) for name, p in model.named_parameters()}
    out = torch.func.functional_call(model, params, (cast_floats(batch, torch.bfloat16),))
    return cast_floats(out, torch.float32)


def make_train_step(model_cfg: dict, device="cuda", mixed_precision: bool = False):
    """Returns ``step(model, optimizer, batch, bn_momentum=None) -> metrics``.

    ``model`` is the tracker on ``device`` (CUDA unless the caller asks for the
    CPU), ``optimizer`` a ``train.optim.Optimizer`` over its parameters,
    ``batch`` a loader batch. ``bn_momentum``, the scheduled flax momentum,
    replaces MODEL_BN_MOMENTUM in every BatchNorm for this step. ``metrics``
    are the loss terms, ``loss`` and ``grad_norm`` (before clipping), 0-dim
    tensors still on the device."""
    device = resolve_device(device)

    def step(model, optimizer, batch, bn_momentum=None):
        model.train()
        set_bn_momentum(model, MODEL_BN_MOMENTUM if bn_momentum is None else bn_momentum)
        batch = to_device(batch, device)
        out = forward(model, batch, mixed_precision)
        loss, tb = compute_losses(model_cfg, out, batch)
        optimizer.zero_grad()
        loss.backward()
        metrics = {k: v.detach() for k, v in tb.items()}
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step
