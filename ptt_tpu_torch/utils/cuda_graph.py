"""CUDA graphs of the port's step bodies: the counterpart of the JAX package's
jitted programs (``jax.jit`` of the tracker's ``lax.scan``, of the host
evaluator's ``track_step`` and of the train step and its K-step scan).

A body is a function of static tensors: it reads its inputs from tensors the
caller keeps and writes its results into them (or returns tensors that the
graph keeps). ``StepGraph`` runs it once eagerly on a side stream, which
builds every kernel its launches build (``ops/_build.py`` runs ``nvcc`` on
first use) and sets up cuBLAS for that stream, then captures it into a
memory pool; that first run is real work, the caller's first step (for the
train step, the dispatch's real K steps). Between the two the allocator's
cached free blocks are given back (``empty_cache``), so that the capture's
pool can take the memory the eager run held: a train step near the card's
memory, as ``ptt_waymo.yaml``'s, would not fit twice, and processes that
share the card would each keep a step's worth. Every later step is one
``replay``: one launch of the whole body from the host.

By default a graph has a pool and a stream of its own, as the tracker's frame
step has (a few hundred MB a shape). Graphs that never run at the same time
and whose pools would each hold a step's activations, a Trainer's train
graphs, share one ``CaptureContext``: one pool and one stream. Only the
context's first graph runs its body eagerly; every later one captures on the
warmed stream into the shared pool and replays at once, so the graphs of a
context hold about one step's memory between them, not one each.

Parameters are read by address, so weights loaded in place
(``load_state_dict``) show in the next replay; ``model_signature`` is what a
graph's key must hold besides the input shapes, so that a model whose
parameters moved, or whose kernels were switched off (``set_use_kernels``), is
captured anew rather than replayed stale; ``train_graph_key`` adds what a
train step depends on.

A replay runs no Python wrapper, so the kernels' launch counters
(``LAUNCHES``: counters of ``utils/timer.py`` that each wrapper advances) are
advanced by what the capture counted, once per replay; the capture itself
launches nothing and counts nothing. A ``StepGraph``'s eager run and capture
are the span ``graph.capture``, and each capture counts one
``graph.captures``.

``history`` keeps the order of two events for ``utils/profiling.py``: the
last release of a graph, and the release that the last capture into a
shared pool came after. A trace of replays after that sequence, with CUPTI
set up before it, has died inside ``cudaGraphLaunch``.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict

from . import timer

GRAPH_CACHE_SIZE = 4  # captured shapes a caller keeps


class _History:
    """Ticks of one process-wide clock: ``released``, the last release of a
    graph; ``shared_after``, the value ``released`` had at the last capture
    into a shared pool (a context's later graph); 0 for never."""

    def __init__(self):
        self.clock = itertools.count(1)
        self.released = self.shared_after = 0

    def tick(self) -> int:
        return next(self.clock)


history = _History()


# the kernel wrappers' launch counters (``ops/fps.py``, ``ops/sa.py``, ``ops/group.py``, ``ops/linear.py``)
LAUNCHES = ("launches.fps", "launches.sa", "launches.group_fwd", "launches.group_bwd", "launches.tf32x3")


def read_launches() -> tuple:
    return tuple(timer.counter(name) for name in LAUNCHES)


def _add_launches(values) -> None:
    for name, value in zip(LAUNCHES, values):
        if value:
            timer.count(name, value)


def model_signature(model) -> tuple:
    """What a captured forward of ``model`` depends on besides its inputs'
    shapes: each module's ``use_kernels`` switch, train or eval mode, and the
    address of every parameter and buffer."""
    switches = tuple(m.use_kernels for m in model.modules() if hasattr(m, "use_kernels"))
    addresses = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
    return switches, model.training, addresses


def train_graph_key(k: int, stacked: dict, mixed_precision: bool, model, optimizer) -> tuple:
    """What a captured train dispatch (``train/train_step.py`` ``TrainStep``)
    is keyed by: K, the (K, B, ...) inputs' shapes and dtypes, mixed
    precision, ``model_signature`` and the addresses of the optimizer's
    moments, which the body updates in place. Not the BatchNorm momentum: the
    body reads it from a device tensor, so one graph serves every epoch of a
    schedule."""
    shapes = tuple((name, tuple(value.shape), value.dtype) for name, value in stacked.items())
    moments = tuple(t.data_ptr() for t in optimizer.mu + optimizer.nu)
    return int(k), shapes, bool(mixed_precision), model_signature(model), moments


class CaptureContext:
    """One memory pool and one capture stream on ``device``, shared by graphs
    that never run at the same time (every train graph of a Trainer: the
    K-step graph and the epoch tail's one-step graph, each key of either).

    The first graph of a context runs its body eagerly on the stream, then
    captures (``StepGraph``'s rule); every later graph runs no eager body: it
    captures into the shared pool on the already warmed stream, then replays,
    and that replay's output is its first result. Once every graph of the
    context is released, the next graph is a first graph again, in a new
    pool.

    The lifetime rule of graphs that share a pool, PyTorch's: a graph's
    output tensors hold its result only until another graph of the pool
    replays, because memory that one graph freed during its capture (its
    intermediates, the gradients dropped after the capture) is scratch that
    another graph's capture may hand out, and every replay writes its scratch
    again. So a caller copies each output out of the pool before the next
    replay, and keeps its static inputs outside the pool. The pool and the
    stream are made at the first capture, so a context can be made on a host
    without CUDA."""

    def __init__(self, device):
        self.device = device
        self.pool = self.stream = None
        self.live = 0  # graphs captured into the pool and not released

    def begin(self) -> bool:
        """Whether the graph about to be captured is the context's first: if
        so, a new pool (and at the first time, the stream)."""
        import torch

        first = self.live == 0
        if first:
            self.pool = torch.cuda.graph_pool_handle()
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        return first


class StepGraph:
    """``body`` (no arguments) captured as one CUDA graph on ``device``, in a
    pool and on a stream of its own or of ``context`` (``CaptureContext``).
    The first graph of a pool runs ``body`` once eagerly on the stream before
    the capture, and ``first`` is what that run returned; a later graph of a
    shared context captures and replays, and ``first`` is its ``output``.
    ``output`` is what the captured body returns (tensors of the pool,
    rewritten by every replay of the pool's graphs). Capture failure
    raises."""

    def __init__(self, body, device, context=None):
        with timer.span("graph.capture"):
            self._capture(body, device, context)
        timer.count("graph.captures")

    def _capture(self, body, device, context) -> None:
        import torch

        self.context = CaptureContext(device) if context is None else context
        eager = self.context.begin()
        self.graph = torch.cuda.CUDAGraph()
        self.pool, stream = self.context.pool, self.context.stream
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        if eager:
            with torch.cuda.stream(stream):
                self.first = body()
            stream.synchronize()
            torch.cuda.empty_cache()  # the eager run's cached blocks, which the capture's pool cannot take
        before = read_launches()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=self.pool, stream=stream, capture_error_mode="thread_local"):
                self.output = body()
        finally:
            counted = read_launches()
            _add_launches(tuple(b - a for a, b in zip(counted, before)))
        self.context.live += 1
        self.capture_s = time.perf_counter() - t0
        self.launches = tuple(a - b for a, b in zip(counted, before))
        current.wait_stream(stream)
        if not eager:
            history.shared_after = history.released
            self.replay()
            self.first = self.output

    def replay(self) -> None:
        self.graph.replay()
        _add_launches(self.launches)

    def pool_bytes(self) -> int:
        """Device memory reserved by the graph's pool (shared with the other
        graphs of its context)."""
        import torch

        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def release(self) -> None:
        """Frees the graph; its pool goes back to the allocator once no graph
        of its context and no tensor of it is held."""
        if self.graph is not None:
            self.graph.reset()
            self.context.live -= 1
            history.released = history.tick()
        self.graph = self.first = self.output = None


class GraphEntry:
    """What a cache keeps for one key: the static tensors a body reads and
    writes (``state``) and, once captured, its ``StepGraph``."""

    def __init__(self, state, graph=None):
        self.state = state
        self.graph = graph

    def release(self) -> None:
        if self.graph is not None:
            self.graph.release()
        self.graph = self.state = None


class GraphCache:
    """Graph entries (anything with a ``release()``) by key, at most
    ``size`` of them: the least recently used is released when a new one would
    exceed it, and ``clear`` releases them all."""

    def __init__(self, size: int):
        self.size = int(size)
        self.captures = 0
        self._entries: OrderedDict = OrderedDict()

    def get(self, key):
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
        return entry

    def put(self, key, entry):
        self.captures += 1
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.size:
            _, old = self._entries.popitem(last=False)
            old.release()
        return entry

    def clear(self) -> None:
        while self._entries:
            self._entries.popitem(last=False)[1].release()

    def values(self):
        return list(self._entries.values())

    def __len__(self) -> int:
        return len(self._entries)
