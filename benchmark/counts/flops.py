"""Floating-point operations of a frame step and of a train step, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the benchmark's own
reference (``reference/model.py``, ``reference/train.py``) at the cell's
shapes, on the meta device: shapes only, no memory, no time. The counter
counts the matrix-product class of operations (each multiply-add as 2), which
is the work the float32 peak bounds; the elementwise rest is not counted, so
an ``mfu`` share reads low, never high."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..reference import model as ref_model
from ..reference import train as ref_train


def _meta_state(model_cfg):
    return {name: (torch.zeros(shape, dtype=torch.int64, device="meta") if kind == "count"
                   else torch.zeros(shape, device="meta"))
            for name, shape, kind, _ in ref_model.param_specs(model_cfg)}


def frame_step_flops(model_cfg: dict, batch: int, search: int, template: int) -> float:
    """One eval-mode forward of ``batch`` search / template clouds."""
    P = _meta_state(model_cfg)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        ref_model.forward(P, model_cfg, torch.zeros(batch, search, 3, device="meta"),
                          torch.zeros(batch, template, 3, device="meta"))
    return float(counter.get_total_flops())


def train_step_flops(model_cfg: dict, batch: int, search: int, template: int) -> float:
    """One train-mode forward, the losses and the backward of ``batch``
    items."""
    P = _meta_state(model_cfg)
    names = ref_train.trainable(ref_model.param_specs(model_cfg))
    leaves = {n: P[n].requires_grad_(True) for n in names}
    b = {"search_points": torch.zeros(batch, search, 3, device="meta"),
         "template_points": torch.zeros(batch, template, 3, device="meta"),
         "cls_label": torch.zeros(batch, search, device="meta"), "reg_label": torch.zeros(batch, 4, device="meta")}
    counter = FlopCounterMode(display=False)
    with counter:
        out = ref_model.forward(dict(P, **leaves), model_cfg, b["search_points"], b["template_points"], train=True)
        loss = ref_train.losses(model_cfg, out, b)["loss"]
        torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
    return float(counter.get_total_flops())
