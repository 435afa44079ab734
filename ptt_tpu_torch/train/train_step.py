"""The train step (the JAX package's ``train/train_state.py`` ``make_train_step``
and ``make_sharded_multi_step``): forward in train mode, losses, backward,
clip and the optimizer step, K of them a dispatch.

``TrainStep`` is K steps as one body over static tensors: step j reads its
batch from slice j of (K, B, ...) input tensors and the hyperparameters of
its update from row j of the optimizer's table (``train/optim.py``
``hyper_rows``), and the metrics of the K steps come out as one (K, n)
tensor. The scheduled BatchNorm momentum comes from a (2,) device tensor of
its own (``train/bn_momentum.py`` ``flax_bn_factors``), as the JAX step takes
it as a traced argument. On the GPU the body is captured as one CUDA graph per
key (``utils/cuda_graph.py`` ``train_graph_key``: K, the batch's shapes and
dtypes, mixed precision, the model and the optimizer's moments) and every
later dispatch of that key is one replay: the counterpart of the JAX step's
single jitted dispatch and of its K-step ``lax.scan``. The graphs of one
``TrainStep``, and of the ``TrainStep``s that share a ``CaptureContext``
(the Trainer's K-step and one-step forms), share one memory pool. On
the CPU, in a process group of more than one rank (whose collectives run from
the host, ``graph_mode``), or when the caller asks for it (``graph=False``),
the same body runs eagerly. ``make_train_step`` is the one-step form that
takes a loader batch; ``make_multi_step`` the K-step form, fed by
``stack_batches``. A capture that fails raises: on the GPU there is no eager
fallback.

With ``mixed_precision`` (OPTIMIZATION.MIXED_PRECISION) the forward and
backward run in bfloat16 as the JAX step runs them: the parameters and the
batch's floats are cast to bf16 inside the differentiated function
(``torch.func.functional_call`` on bf16 copies), so their gradients flow back
into the float32 master parameters, which the optimizer and its state keep;
the outputs are cast back to float32, the losses are computed in float32 on
the float32 batch, and the BatchNorm running statistics stay float32. Each
layer follows flax's type promotion, not autocast (``nn/layers.py``).

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
from ..utils import cuda_graph, timer
from ..utils.dist import all_reduce_mean_, get_dist_info
from .bn_momentum import MODEL_BN_MOMENTUM, flax_bn_factors, set_bn_factors


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


def stack_batches(batches) -> dict:
    """K batches of one shape (dicts of numpy arrays, or of tensors) as one
    dict of (K, B, ...) arrays: the input of a K-step dispatch, the JAX
    package's ``stack_shard_batches`` on one device."""
    first = batches[0]
    return {key: torch.stack([b[key] for b in batches]) if torch.is_tensor(first[key])
            else np.stack([b[key] for b in batches]) for key in first}


def graph_mode(device) -> str:
    """How a train step runs on ``device``: "on" (a replay of its captured
    CUDA graph), or "off" and why (the CPU, or a process group of more than
    one rank, whose gradient all-reduce, BatchNorm moments and loss
    denominators are collectives that gloo runs from the host; NCCL's are not
    captured either, untested on a card a rank)."""
    if torch.device(device).type != "cuda":
        return "off (CPU: the eager step)"
    world = get_dist_info()[1]
    if world > 1:
        import torch.distributed as dist

        return f"off (process group of {world} ranks on {dist.get_backend()})"
    return "on"


class TrainStep:
    """K train steps a dispatch, called as ``multi(model, optimizer, stacked,
    bn_momentum=None) -> metrics``: ``stacked`` holds (K, B, ...) arrays
    (``stack_batches``; on the host, or tensors already on the device,
    ``BatchUploader``), ``model`` is the tracker on ``device`` and
    ``optimizer`` a ``train.optim.Optimizer`` over its parameters, whose count
    advances by K. ``bn_momentum``, the scheduled flax momentum, replaces
    MODEL_BN_MOMENTUM in every BatchNorm for these steps. ``metrics`` is a
    (K, len(names)) tensor on the device, this dispatch's own: the loss
    terms, ``loss`` and ``grad_norm`` (before clipping) of each step, in a
    process group the global batch's. A call is the span
    ``train_step.dispatch`` (``utils/timer.py``; request id the optimizer's
    count before it, ``n`` = K); a replay, the graph's launch and the copy of
    its metrics, is its child ``train_step.replay``, so that the dispatch's
    self time is the host's own work.

    With ``graphed`` (the GPU, unless ``graph_mode`` says otherwise or the
    caller passed ``graph=False``) each key's first dispatch makes its graph
    (``cuda_graph.StepGraph`` in ``context``, a ``CaptureContext``, by default
    one of this step's own): the context's first graph runs the eager K steps
    before it captures, a later one captures and replays, so either way the
    dispatch's real K steps. Each later dispatch copies its batches, table
    rows and BatchNorm factors into the key's static inputs on the compute
    stream, replays, and copies the metrics out of the pool, which the next
    replay of any graph of the context may rewrite. The graphs of a context
    keep one memory pool of about one step's activations (``close``
    releases this step's graphs). After a graphed dispatch the parameters'
    ``.grad`` are None: the gradients live in the pool, and the optimizer has
    used them."""

    def __init__(self, model_cfg: dict, k: int = 1, device="cuda", mixed_precision: bool = False,
                 graph: bool = True, context=None):
        self.model_cfg = model_cfg
        self.k = int(k)
        self.device = resolve_device(device)
        self.mixed_precision = bool(mixed_precision)
        self.mode = graph_mode(self.device) if graph else "off (the eager step asked for)"
        self.graphed = self.mode == "on"
        self.context = cuda_graph.CaptureContext(self.device) if context is None else context
        self.graphs = cuda_graph.GraphCache(cuda_graph.GRAPH_CACHE_SIZE)
        self.names = None  # the metrics' names, the columns of the output

    def body(self, model, optimizer, inputs: dict, hyper: torch.Tensor, bn: torch.Tensor) -> torch.Tensor:
        """The K steps on ``inputs`` ((K, B, ...) tensors on the device) with
        the rows of ``hyper`` ((K, 5) on the device) and the BatchNorm factors
        ``bn`` ((2,) on the device). Reads nothing from the device on the
        host."""
        rows = []
        set_bn_factors(model, bn)
        try:
            for j in range(self.k):
                batch = {key: value[j] for key, value in inputs.items()}
                out = forward(model, batch, self.mixed_precision)
                loss, tb = compute_losses(self.model_cfg, out, batch)
                optimizer.zero_grad()
                loss.backward()
                metrics = {key: value.detach() for key, value in tb.items()}
                if get_dist_info()[1] > 1:
                    metrics = average_over_ranks(optimizer.params, metrics)
                metrics["grad_norm"] = optimizer.update(hyper[j])
                self.names = tuple(metrics)
                rows.append(torch.stack(list(metrics.values())))
        finally:
            set_bn_factors(model, None)
        return torch.stack(rows)

    def __call__(self, model, optimizer, stacked: dict, bn_momentum=None) -> torch.Tensor:
        with timer.span("train_step.dispatch", optimizer.count, self.k):
            model.train()
            bn = flax_bn_factors(MODEL_BN_MOMENTUM if bn_momentum is None else bn_momentum)
            hyper = optimizer.hyper_rows(self.k)
            if self.device.type == "cuda":
                bn = bn.pin_memory()  # so that its copy to the device does not wait for the device
            if self.graphed:
                out = self._replay(model, optimizer, stacked, hyper, bn)
            else:
                out = self.body(model, optimizer, to_device(stacked, self.device),
                                hyper.to(self.device, non_blocking=True), bn.to(self.device, non_blocking=True))
            optimizer.count += self.k
        return out

    def _replay(self, model, optimizer, stacked, hyper, bn) -> torch.Tensor:
        stacked = {key: torch.from_numpy(np.ascontiguousarray(value)) if isinstance(value, np.ndarray) else value
                   for key, value in stacked.items()}
        key = cuda_graph.train_graph_key(self.k, stacked, self.mixed_precision, model, optimizer)
        entry = self.graphs.get(key)
        if entry is None:
            # the static inputs, outside the pool: allocated before the capture
            inputs = {name: torch.empty(value.shape, dtype=value.dtype, device=self.device)
                      for name, value in stacked.items()}
            table = torch.empty(hyper.shape, dtype=hyper.dtype, device=self.device)
            factors = torch.empty(bn.shape, dtype=bn.dtype, device=self.device)
            entry = self.graphs.put(key, cuda_graph.GraphEntry((inputs, table, factors)))
        inputs, table, factors = entry.state
        for name, value in stacked.items():
            inputs[name].copy_(value, non_blocking=True)
        table.copy_(hyper, non_blocking=True)
        factors.copy_(bn, non_blocking=True)
        if entry.graph is None:
            entry.graph = cuda_graph.StepGraph(lambda: self.body(model, optimizer, inputs, table, factors),
                                               self.device, self.context)
            # the capture's gradients are tensors of the pool, which only a replay writes: nothing outside the
            # graphs keeps them, so that releasing the graphs frees the whole pool
            optimizer.zero_grad()
            return entry.graph.first.clone()
        with timer.span("train_step.replay"):  # a launch, which may wait for the device
            entry.graph.replay()
            return entry.graph.output.clone()

    def metrics(self, out: torch.Tensor) -> list:
        """The K rows of a dispatch's metrics as dicts of 0-dim tensors."""
        return [dict(zip(self.names, row)) for row in out]

    def close(self) -> None:
        """Releases the captured graphs."""
        self.graphs.clear()


def make_multi_step(model_cfg: dict, k: int, device="cuda", mixed_precision: bool = False,
                    graph: bool = True, context=None) -> TrainStep:
    """K train steps a dispatch (``TrainStep``), the JAX package's
    ``make_sharded_multi_step``; ``graph=False`` asks for the eager body on
    the GPU too, ``context`` (a ``cuda_graph.CaptureContext``) shares the
    graphs' pool and stream with other train steps of the model."""
    return TrainStep(model_cfg, k, device, mixed_precision, graph, context)


def make_train_step(model_cfg: dict, device="cuda", mixed_precision: bool = False, graph: bool = True,
                    context=None):
    """Returns ``step(model, optimizer, batch, bn_momentum=None) -> metrics``,
    one train step on a loader batch (on the host, or already on the device,
    ``BatchUploader``): a ``TrainStep`` of K = 1, which is ``step.steps``.
    ``metrics`` are the loss terms, ``loss`` and ``grad_norm`` (before
    clipping), 0-dim tensors on the device, this step's own; in a process
    group, the global batch's. ``model`` is the tracker on ``device`` (CUDA
    unless the caller asks for the CPU). On the GPU the step is a replay of
    its captured graph unless ``graph=False``; ``context`` as
    ``make_multi_step``'s."""
    steps = TrainStep(model_cfg, 1, device, mixed_precision, graph, context)

    def step(model, optimizer, batch, bn_momentum=None):
        out = steps(model, optimizer, {key: value[None] for key, value in batch.items()}, bn_momentum)
        return steps.metrics(out)[0]

    step.steps = steps
    return step
