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
autocast (``nn/layers.py``). The JAX package's K-step scan is not ported
(ROADMAP.md Queue 1 item 4b): OPTIMIZATION.STEPS_PER_DISPATCH = K runs as K
of these steps (``train/trainer.py``).

Data parallelism, the JAX package's ``make_sharded_train_step``: in a
process group each rank steps on its shard of the global batch; BatchNorm and
the losses take the global batch's statistics and denominators (``nn/``), and
after the backward one all-reduce of one flat buffer averages the gradients
and the loss terms over the ranks, so that the clip, ``grad_norm`` and the
optimizer see the global gradient and the metrics are the global batch's.
Every rank then makes the same update. (No ``DistributedDataParallel``
wrapper: the parameter names, and with them the checkpoints' keys, and the
bf16 ``functional_call`` path stay as they are.)
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..nn.losses import compute_losses
from ..utils.dist import all_reduce_mean_, get_dist_info
from .bn_momentum import MODEL_BN_MOMENTUM, set_bn_momentum


def to_device(batch: dict, device) -> dict:
    """A loader batch (dict of numpy arrays or tensors) as float32/int tensors on
    ``device``; a tensor already there is passed as it is."""
    out = {}
    for key, value in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
        out[key] = t.to(device, non_blocking=True)
    return out


def pin_batch(batch: dict) -> dict:
    """A loader batch as CPU tensors in page-locked memory, one staging copy, so
    that a copy to the GPU from there runs asynchronously (from pageable memory
    the host waits for the stream first). Only where CUDA is present."""
    return {key: torch.from_numpy(np.ascontiguousarray(value)).pin_memory() for key, value in batch.items()}


class BatchUploader:
    """Uploads loader batches to ``device`` ahead of the step that takes them:
    the JAX trainer's upload of batch k+1 while step k runs.

    On CUDA, ``put`` makes one pinned staging copy of the batch (``pin_batch``)
    and enqueues its host-to-device copy on a side stream, then records an event
    there; ``take`` makes the compute stream wait for that event and marks each
    tensor as used on the compute stream (``record_stream``), so that the
    caching allocator does not give its memory to the side stream's next
    upload before the step that reads it has run. Neither waits on the device.
    On the CPU ``put`` is ``to_device`` and ``take`` returns its batch."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None

    def put(self, batch):
        if batch is None:
            return None
        if self.stream is None:
            return to_device(batch, self.device)
        host = pin_batch(batch)
        with torch.cuda.stream(self.stream):
            uploaded = {key: value.to(self.device, non_blocking=True) for key, value in host.items()}
        return uploaded, self.stream.record_event()

    def take(self, pending) -> dict:
        if self.stream is None:
            return pending
        uploaded, event = pending
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(event)
        for value in uploaded.values():
            value.record_stream(compute)
        return uploaded


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


def average_over_ranks(params, metrics: dict) -> dict:
    """The gradients of ``params`` (in place; a missing one is zeros) and the
    0-dim ``metrics``, each averaged over the ranks by one all-reduce."""
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    values = torch.stack(list(metrics.values()))
    all_reduce_mean_([p.grad for p in params] + [values])
    return dict(zip(metrics, values))


def make_train_step(model_cfg: dict, device="cuda", mixed_precision: bool = False):
    """Returns ``step(model, optimizer, batch, bn_momentum=None) -> metrics``.

    ``model`` is the tracker on ``device`` (CUDA unless the caller asks for the
    CPU), ``optimizer`` a ``train.optim.Optimizer`` over its parameters,
    ``batch`` a loader batch, on the host or already on the device
    (``BatchUploader``). ``bn_momentum``, the scheduled flax momentum,
    replaces MODEL_BN_MOMENTUM in every BatchNorm for this step. ``metrics``
    are the loss terms, ``loss`` and ``grad_norm`` (before clipping), 0-dim
    tensors still on the device; in a process group, the global batch's."""
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
        if get_dist_info()[1] > 1:
            metrics = average_over_ranks(optimizer.params, metrics)
        metrics["grad_norm"] = optimizer.step()
        return metrics

    return step
