"""Parameter counts, FLOPs and traces (the JAX package's ``utils/profiling.py``,
after the reference's ``calc_flops`` / ``count_parameters``).

``count_parameters`` counts per top-level module. ``per_layer_flops`` is the
reference's forward-hook walk: hooks on every linear, BatchNorm and LayerNorm
layer record the output shape of each call, and the counts are the JAX
package's analytic ones, 2 x out_positions x C_in x C_out for a pointwise
linear layer and 2 x out_elements for a normalization. ``per_module_flops``
counts each top-level stage with ``torch.utils.flop_counter.FlopCounterMode``,
and ``train_step_flops`` a train step's forward and backward.
``trace`` records a ``torch.profiler`` timeline.
"""

from __future__ import annotations

import copy
import os
from contextlib import contextmanager

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


@contextmanager
def trace(log_dir):
    """A ``torch.profiler`` timeline of the block, the device's too where CUDA
    is present, written to ``log_dir/trace.json`` (Chrome trace format, for
    Perfetto or chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(log_dir), "trace.json"))
