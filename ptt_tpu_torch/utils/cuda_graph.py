"""CUDA graphs of the port's step bodies: the counterpart of the JAX package's
jitted programs (``jax.jit`` of the tracker's ``lax.scan``, of the host
evaluator's ``track_step`` and of the train step and its K-step scan).

A body is a function of static tensors: it reads its inputs from tensors the
caller keeps and writes its results into them (or returns tensors that the
graph keeps). ``StepGraph`` runs it once eagerly on a side stream, which
builds every kernel its launches build (``ops/_build.py`` runs ``nvcc`` on
first use) and sets up cuBLAS for that stream, then captures it into a private
memory pool; that first run is real work, the caller's first step (for the
train step, the dispatch's real K steps). Between the two the allocator's
cached free blocks are given back (``empty_cache``), so that the capture's
pool can take the memory the eager run held: a train step near the card's
memory, as ``ptt_waymo.yaml``'s, would not fit twice, and processes that
share the card would each keep a step's worth. Every later step is one
``replay``: one launch of the whole body from the host.

Parameters are read by address, so weights loaded in place
(``load_state_dict``) show in the next replay; ``model_signature`` is what a
graph's key must hold besides the input shapes, so that a model whose
parameters moved, or whose kernels were switched off (``set_use_kernels``), is
captured anew rather than replayed stale; ``train_graph_key`` adds what a
train step depends on.

A replay runs no Python wrapper, so the kernels' launch counters
(``ops/fps.py`` ``launches`` and the others) are advanced by what the capture
counted, once per replay; the capture itself launches nothing and counts
nothing.
"""

from __future__ import annotations

import itertools
import time
from collections import OrderedDict

GRAPH_CACHE_SIZE = 4  # captured shapes a caller keeps


def _counters():
    from ..ops import fps, group, sa

    return ((fps, "launches"), (sa, "launches"), (group, "fwd_launches"), (group, "bwd_launches"))


def read_launches() -> tuple:
    return tuple(getattr(mod, name) for mod, name in _counters())


def _set_launches(values) -> None:
    for (mod, name), value in zip(_counters(), values):
        setattr(mod, name, value)


def model_signature(model) -> tuple:
    """What a captured forward of ``model`` depends on besides its inputs'
    shapes: each module's ``use_kernels`` switch, train or eval mode, and the
    address of every parameter and buffer."""
    switches = tuple(m.use_kernels for m in model.modules() if hasattr(m, "use_kernels"))
    addresses = tuple(t.data_ptr() for t in itertools.chain(model.parameters(), model.buffers()))
    return switches, model.training, addresses


def train_graph_key(k: int, stacked: dict, mixed_precision: bool, bn_momentum: float, model, optimizer) -> tuple:
    """What a captured train dispatch (``train/train_step.py`` ``TrainStep``)
    is keyed by: K, the (K, B, ...) inputs' shapes and dtypes, mixed
    precision, the flax BatchNorm momentum (a constant of the body: the
    update's 1 - m rounds as today's step rounds it), ``model_signature`` and
    the addresses of the optimizer's moments, which the body updates in
    place."""
    shapes = tuple((name, tuple(value.shape), value.dtype) for name, value in stacked.items())
    moments = tuple(t.data_ptr() for t in optimizer.mu + optimizer.nu)
    return int(k), shapes, bool(mixed_precision), float(bn_momentum), model_signature(model), moments


class StepGraph:
    """``body`` (no arguments) run once eagerly on a side stream of ``device``,
    then captured as one CUDA graph in a private memory pool. ``first`` is what
    the eager run returned, ``output`` what the captured one returns (tensors of
    the pool, rewritten by every replay). Capture failure raises."""

    def __init__(self, body, device):
        import torch

        self.graph = torch.cuda.CUDAGraph()
        self.pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
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
            _set_launches(before)
        self.capture_s = time.perf_counter() - t0
        self.launches = tuple(a - b for a, b in zip(counted, before))
        current.wait_stream(stream)

    def replay(self) -> None:
        self.graph.replay()
        _set_launches(tuple(a + b for a, b in zip(read_launches(), self.launches)))

    def pool_bytes(self) -> int:
        """Device memory reserved by the graph's private pool."""
        import torch

        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def release(self) -> None:
        """Frees the graph; its pool goes back to the allocator once no tensor
        of it is held."""
        self.graph.reset()
        self.first = self.output = None


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
