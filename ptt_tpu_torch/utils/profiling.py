"""Parameter counts, FLOPs and traces (the JAX package's ``utils/profiling.py``,
after the reference's ``calc_flops`` / ``count_parameters``).

``count_parameters`` counts per top-level module. ``per_layer_flops`` is the
reference's forward-hook walk: hooks on every linear, BatchNorm and LayerNorm
layer record the output shape of each call, and the counts are the JAX
package's analytic ones, 2 x out_positions x C_in x C_out for a pointwise
linear layer and 2 x out_elements for a normalization. ``per_module_flops``
counts each top-level stage with ``torch.utils.flop_counter.FlopCounterMode``,
and ``train_step_flops`` a train step's forward and backward.
``device_window`` opens the port's ``torch.profiler`` sessions, with the
CUPTI settings a process that replays CUDA graphs needs already in place, and
reads back the device's activity; ``trace`` records a timeline through it;
``annotation`` is the ``record_function`` that ``utils/timer.py`` enters for
each of its spans while a session is active.
"""

from __future__ import annotations

import copy
import json
import os
import tempfile
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch
from torch import nn


def count_parameters(model: nn.Module) -> dict:
    """Total and per-top-level-module parameter counts (the top-level modules
    are the JAX tracker's top-level parameter keys)."""
    return {"total": int(sum(p.numel() for p in model.parameters())),
            "per_module": {name: int(sum(p.numel() for p in child.parameters()))
                           for name, child in model.named_children()}}


def _plain_copy(model: nn.Module, train: bool) -> nn.Module:
    from ..nn import set_use_kernels

    walk = copy.deepcopy(model).train(train)
    set_use_kernels(walk, False)
    return walk


def per_module_flops(model: nn.Module, batch: dict) -> list:
    """Per-top-level-module FLOPs of an eval forward of ``batch`` (tensors on
    the model's device) on the plain path: each stage of the tracker
    (backbone, similarity, centroid head, box head) runs in turn on the
    previous stage's output under ``FlopCounterMode``.

    This stands in for the JAX package's ``cost_analysis`` and
    ``per_module_cost_analysis``, which report XLA's flops and bytes after
    fusion. PyTorch has no counterpart of that: the table counts only the
    matrix-product class of operations that PyTorch's counter knows (matmul,
    convolution, attention), on the plain path (a CUDA kernel's work is
    invisible to the counter), and no bytes.

    Returns [(module_name, {"flops": f, "params": n}), ...] in order."""
    from torch.utils.flop_counter import FlopCounterMode

    walk = _plain_copy(model, train=False)
    rows, out = [], dict(batch)
    with torch.no_grad():
        for name, stage in walk.named_children():
            counter = FlopCounterMode(display=False)
            with counter:
                out = stage(out)
            rows.append((name, {"flops": float(counter.get_total_flops()),
                                "params": int(sum(p.numel() for p in stage.parameters()))}))
    return rows


def train_step_flops(model_cfg: dict, model: nn.Module, batch: dict, mixed_precision: bool = False) -> float:
    """FLOPs of one train step's forward, losses and backward on ``batch``
    (tensors on the model's device) as ``FlopCounterMode`` counts them (the
    matrix-product class of operations), on the plain path of a copy of
    ``model``. The optimizer's elementwise work is not counted."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..nn.losses import compute_losses
    from ..train.train_step import forward

    walk = _plain_copy(model, train=True)
    counter = FlopCounterMode(display=False)
    with counter:
        loss, _ = compute_losses(model_cfg, forward(walk, batch, mixed_precision), batch)
        loss.backward()
    return float(counter.get_total_flops())


def per_layer_flops(model: nn.Module, batch: dict) -> list:
    """Per-layer parameter and FLOPs rows over the whole network, the
    reference's forward-hook walk: one forward of ``batch`` with a hook on
    every ``nn.Linear``, BatchNorm and ``nn.LayerNorm`` recording each call's
    output shape; FLOPs sum over the calls (the Siamese backbone's layers run
    twice).

    The walk runs on a copy of ``model`` on the plain path
    (``set_use_kernels(copy, False)``) in train mode: in eval mode an SA stage
    is one fused function with BatchNorm folded into its weights, which hides
    its layers as the JAX package's fused SA kernel does (its walk turns the
    kernel off). Train mode changes no shape; the counts are the eval-mode
    ones, and the model itself is not touched.

    Returns [(layer_path, {"params": n, "out_shape": tuple, "flops": f,
    "calls": c, "kind": "Linear" | "BatchNorm" | "LayerNorm"}), ...] in module
    order."""
    walk = _plain_copy(model, train=True)
    layers = [(name, m) for name, m in walk.named_modules() if isinstance(m, (nn.Linear, nn.BatchNorm1d, nn.LayerNorm))]
    shapes = {name: [] for name, _ in layers}
    hooks = [m.register_forward_hook(lambda mod, args, out, name=name: shapes[name].append(tuple(out.shape)))
             for name, m in layers]
    try:
        with torch.no_grad():
            walk(dict(batch))
    finally:
        for h in hooks:
            h.remove()
    rows = []
    for name, m in layers:
        calls = shapes[name]
        out_shape = max(calls, key=lambda s: int(np.prod(s)), default=None)
        if isinstance(m, nn.Linear):
            params = m.weight.numel() + (m.bias.numel() if m.bias is not None else 0)
            positions = sum(int(np.prod(s[:-1])) for s in calls)
            info = {"params": int(params), "flops": 2.0 * positions * m.in_features * m.out_features,
                    "kind": "Linear"}
        else:
            info = {"params": int(sum(p.numel() for p in m.parameters())),
                    "flops": 2.0 * sum(int(np.prod(s)) for s in calls),
                    "kind": "LayerNorm" if isinstance(m, nn.LayerNorm) else "BatchNorm"}
        rows.append((name, {**info, "out_shape": out_shape, "calls": len(calls)}))
    return rows


def _table(headers, body, total, align) -> str:
    lines = [headers] + body + [total]
    widths = [max(len(str(r[i])) for r in lines) for i in range(len(headers))]
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"

    def fmt(row):
        return "| " + " | ".join(align(str(v), w) for v, w in zip(row, widths)) + " |"

    return "\n".join([sep, fmt(headers), sep] + [fmt(r) for r in body] + [sep, fmt(total), sep])


def format_cost_table(rows) -> str:
    """``per_module_flops`` rows as the reference's PrettyTable-style block."""
    body = [(name, f"{c['params']:,}", f"{c['flops'] / 1e6:.2f}") for name, c in rows]
    total = ("TOTAL", f"{sum(c['params'] for _, c in rows):,}", f"{sum(c['flops'] for _, c in rows) / 1e6:.2f}")
    return _table(("Module", "Params", "MFLOPs"), body, total, str.rjust)


def format_layer_table(rows) -> str:
    """``per_layer_flops`` rows as the reference's FLOPs report."""
    body = [(name, info["kind"], "x".join(map(str, info["out_shape"])) if info["out_shape"] else "?",
             info["calls"], f"{info['params']:,}", f"{info['flops'] / 1e6:.2f}") for name, info in rows]
    total = ("TOTAL", "", "", "", f"{sum(i['params'] for _, i in rows):,}",
             f"{sum(i['flops'] for _, i in rows) / 1e6:.2f}")
    return _table(("Layer", "Type", "Output shape", "Calls", "Params", "MFLOPs"), body, total, str.ljust)


# Read by Kineto, the library behind torch.profiler. By default it tears CUPTI
# (NVIDIA's tracing interface) down when a trace ends and sets it up again at
# the next; late in a process whole windows then came back without the
# device's activity, and with 0 (CUPTI subscribed from the first trace to the
# end of the process) far fewer did. (PyTorch sets the same, with
# DISABLE_CUPTI_LAZY_REINIT, for inductor's CUDA graphs only.)
CUPTI_SETTINGS = {"TEARDOWN_CUPTI": "0"}

# this process's CUDA traces: the cuda_graph.history tick of the first, and
# the TEARDOWN_CUPTI value of the first that ended with CUPTI torn down
_traces = {"cupti_since": None, "torn_down": None}


class TraceRefused(RuntimeError):
    """A CUDA trace in a state of the process where CUPTI has crashed the
    process or lost the device's activity."""


def refusal(cuda: bool) -> str | None:
    """Why a trace may not start now (None if it may): the two states of
    ``device_window``'s docstring."""
    from . import cuda_graph  # here: utils/timer.py imports this module, and cuda_graph imports timer

    if not cuda:
        return None
    if _traces["torn_down"] is not None:
        return (f"an earlier trace of this process ended with TEARDOWN_CUPTI={_traces['torn_down']}, so Kineto tore "
                f"CUPTI down; a CUDA trace after that has died inside cudaGraphLaunch and missed the device's "
                f"activity. Unset TEARDOWN_CUPTI (the port sets 0) or trace in a new process.")
    since = _traces["cupti_since"]
    if since is not None and cuda_graph.history.shared_after > since:
        return ("since this process's first trace set CUPTI up, a CUDA graph was released and then another was "
                "captured into a shared pool (utils/cuda_graph.py history); a trace of graph replays after that "
                "has died inside cudaGraphLaunch (cupti_repro.py). Trace in a process whose first trace comes "
                "after those captures.")
    return None


class DeviceEvent(NamedTuple):
    """One activity of the device in a trace: a kernel, a copy or a set;
    start and duration in the trace's microseconds, the stream it ran on."""

    name: str
    kind: str  # "kernel", "memcpy" or "memset"
    start_us: float
    dur_us: float
    stream: int | None


class OperatorRow(NamedTuple):
    """One host-side operator of a trace, summed over its calls (grouped by
    input shapes where asked): the device time of the kernels it launched
    itself (``self_device_us``) and with its children's (``device_us``)."""

    key: str
    count: int
    self_device_us: float
    device_us: float
    input_shapes: list


_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}


def profiler_setup() -> dict:
    """Put ``CUPTI_SETTINGS`` in the environment where the user has not set
    them (a value the user set stands) and return the values in force.
    ``device_window`` calls it before each session: Kineto may read them only
    once, at a process's first trace. The cost: CUPTI stays subscribed after
    the trace ends, for the life of the process."""
    for key, value in CUPTI_SETTINGS.items():
        os.environ.setdefault(key, value)
    return {key: os.environ[key] for key in CUPTI_SETTINGS}


class Window:
    """What ``device_window`` yields: ``profiler``, the ``torch.profiler``
    session; after the block, ``events`` (the device's activity, in order of
    start) and ``operators()``."""

    def __init__(self, profiler):
        self.profiler = profiler
        self._events = None

    @property
    def events(self) -> list:
        if self._events is None:
            with tempfile.TemporaryDirectory() as tmp:
                path = os.path.join(tmp, "trace.json")
                self.profiler.export_chrome_trace(path)
                with open(path) as fh:
                    trace_events = json.load(fh)["traceEvents"]
            self._events = sorted((DeviceEvent(e["name"], _DEVICE_CATS[e["cat"]], float(e["ts"]), float(e["dur"]),
                                               e.get("args", {}).get("stream"))
                                   for e in trace_events if e.get("cat") in _DEVICE_CATS and "dur" in e),
                                  key=lambda e: e.start_us)
        return self._events

    def operators(self, group_by_input_shape: bool = False) -> list:
        """The host-side operators (``aten::mm``, a module's forward, ...) of
        the window with their device time, as ``OperatorRow``s."""
        from torch.profiler import DeviceType

        return [OperatorRow(e.key, e.count, e.self_device_time_total, getattr(e, "device_time_total", 0.0),
                            [tuple(x) for x in (e.input_shapes or []) if x])
                for e in self.profiler.key_averages(group_by_input_shape=group_by_input_shape)
                if e.device_type == DeviceType.CPU]


@contextmanager
def device_window(cpu: bool = True, record_shapes: bool = False):
    """A ``torch.profiler`` session over the block: the device's activity
    where CUDA is present, the host's operators unless ``cpu`` is False.
    ``profiler_setup`` runs first. Yields a ``Window``; its ``events`` list
    every kernel, copy and set the device ran in the block (none without
    CUDA).

    Raises ``TraceRefused`` before a CUDA trace in two states of the process
    in which CUPTI has crashed it inside ``cudaGraphLaunch``: after a trace
    that ended with CUPTI torn down (the user set ``TEARDOWN_CUPTI`` to
    another value than 0), and when, after the process's first trace set
    CUPTI up, a port graph was released and another then captured into a
    shared pool (``utils/cuda_graph.py`` ``history``; graphs made without
    the port, and traces opened with ``torch.profiler`` itself, are not seen
    here)."""
    from torch.profiler import ProfilerActivity, profile

    from . import cuda_graph

    settings = profiler_setup()
    cuda = torch.cuda.is_available()
    reason = refusal(cuda)
    if reason is not None:
        raise TraceRefused(reason)
    if cuda and _traces["cupti_since"] is None:
        _traces["cupti_since"] = cuda_graph.history.tick()
    activities = ([ProfilerActivity.CPU] if cpu or not cuda else []) + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=activities, record_shapes=record_shapes) as prof:
            yield Window(prof)
    finally:
        if cuda and settings["TEARDOWN_CUPTI"] != "0" and _traces["torn_down"] is None:
            _traces["torn_down"] = settings["TEARDOWN_CUPTI"]


def annotation(name: str):
    """A ``record_function`` named ``name``: a host span on the trace of the
    active session."""
    from torch.profiler import record_function

    return record_function(name)


@contextmanager
def trace(log_dir):
    """A ``torch.profiler`` timeline of the block, the device's too where CUDA
    is present, written to ``log_dir/trace.json`` (Chrome trace format, for
    Perfetto or chrome://tracing); opened by ``device_window``, so it holds
    every ``utils/timer.py`` span of the block as a ``ptt.<name>`` annotation.
    Yields the profiler."""
    os.makedirs(log_dir, exist_ok=True)
    with device_window() as window:
        yield window.profiler
    window.profiler.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
