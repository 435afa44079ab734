"""The optimizers and learning-rate schedules of the JAX package's
``train/optim.py``, the optax chains it builds, written out on tensors:

    clip_by_global_norm(clip) -> tx, with tx by OPTIMIZER:
      adam           [add_decayed_weights(wd)] -> scale_by_adam(b1, b2, eps) -> scale_by_learning_rate(lr)
      adamw          scale_by_adam(b1, b2, eps) -> add_decayed_weights(wd) -> scale_by_learning_rate(lr)
      sgd            [add_decayed_weights(wd)] -> trace(MOMENTUM) -> scale_by_learning_rate(lr)
      adam_onecycle  scale_by_adam(b1 = mom(count), b2 = 0.99) -> [add_decayed_weights(wd)]
                     -> scale_by_learning_rate(lr)

and lr by SCHEDULER: 'step' (StepLR per epoch), or absent (or adam_onecycle
with any scheduler but 'step'): fastai's OneCycle, a cosine rise from
LR / DIV_FACTOR to LR over the first PCT_START of the steps, then a cosine fall
to LR / DIV_FACTOR / 1e4; adam_onecycle's b1 follows MOMS the other way round
(0.95 -> 0.85 -> 0.95), and is 0.9 under 'step'. adam's weight decay is L2
into the gradient, adamw's and adam_onecycle's is decoupled (after the Adam
scaling, before the lr), sgd's is L2.

Where it differs from ``torch.optim``: gradients are scaled by clip / norm
only when norm >= clip (torch scales by clip / (norm + 1e-6) whenever norm >
clip); the moments are (1 - b) * g + b * m; Adam's update is m_hat /
(sqrt(v_hat) + eps) with the bias corrections of the current b1 (which
OneCycle moves); sgd's trace is g + momentum * trace; and update k uses the
hyperparameters of the schedule at the pre-increment count k.
"""

from __future__ import annotations

import math

import numpy as np
import torch

OPTIMIZERS = ("adam", "adamw", "sgd", "adam_onecycle")


def step_lr_schedule(base_lr: float, step_size_epochs: int, gamma: float, iters_per_epoch: int):
    """StepLR stepped per epoch: lr(count) = base * gamma^(epoch // step_size)."""

    def schedule(count: int) -> float:
        epoch = count // max(1, iters_per_epoch)
        return base_lr * (gamma ** (epoch // step_size_epochs))

    return schedule


def _annealing_cos(start: float, end: float, pct: np.float32) -> np.float32:
    """fastai's cosine anneal from ``start`` to ``end`` as ``pct`` goes 0 -> 1,
    in float32 as the JAX package evaluates it."""
    cos_out = np.cos(np.float32(math.pi) * pct) + np.float32(1.0)
    return np.float32(end) + np.float32((start - end) / 2.0) * cos_out


def onecycle_schedules(total_steps: int, lr_max: float, moms, div_factor: float, pct_start: float):
    """fastai's OneCycle pair (lr, Adam b1) of the update count, as the JAX
    package's ``fastai_onecycle_schedules`` defines it."""
    a1 = int(total_steps * pct_start)
    low_lr = lr_max / div_factor
    up, down = np.float32(max(1, a1)), np.float32(max(1, total_steps - a1))
    m0, m1 = float(moms[0]), float(moms[1])

    def lr_schedule(count: int) -> float:
        c = np.float32(count)
        if count < a1:
            return float(_annealing_cos(low_lr, lr_max, c / up))
        return float(_annealing_cos(lr_max, low_lr / 1e4, (c - np.float32(a1)) / down))

    def mom_schedule(count: int) -> float:
        c = np.float32(count)
        if count < a1:
            return float(_annealing_cos(m0, m1, c / up))
        return float(_annealing_cos(m1, m0, (c - np.float32(a1)) / down))

    return lr_schedule, mom_schedule


class Optimizer:
    """The optimizer of ``optim_cfg`` (the OPTIMIZATION section) over
    ``params``, for a run of ``total_epochs`` (default NUM_EPOCHS) epochs of
    ``iters_per_epoch`` steps. ``step()`` reads each parameter's ``.grad``,
    clips, updates the parameters in place and returns the global norm of the
    unclipped gradients as a 0-dim tensor on their device (no host sync).
    ``lr_schedule(k)`` is the learning rate of update k."""

    def __init__(self, params, optim_cfg: dict, iters_per_epoch: int, total_epochs: int | None = None):
        self.name = optim_cfg["OPTIMIZER"]
        if self.name not in OPTIMIZERS:
            raise NotImplementedError(f"optimizer {self.name!r}")
        scheduler = optim_cfg.get("SCHEDULER")
        epochs = int(optim_cfg["NUM_EPOCHS"] if total_epochs is None else total_epochs)
        base_lr = float(optim_cfg["LR"])
        self.mom_schedule = None
        if scheduler == "step":
            self.lr_schedule = step_lr_schedule(base_lr, int(optim_cfg["STEP_SIZE"]), float(optim_cfg["GAMMA"]),
                                                iters_per_epoch)
        elif scheduler is None or self.name == "adam_onecycle":
            self.lr_schedule, self.mom_schedule = onecycle_schedules(
                max(1, iters_per_epoch * epochs), base_lr, [float(m) for m in optim_cfg.get("MOMS", [0.95, 0.85])],
                float(optim_cfg.get("DIV_FACTOR", 10.0)), float(optim_cfg.get("PCT_START", 0.4)))
        else:
            raise NotImplementedError(f"scheduler {scheduler!r}")
        if self.name == "adam_onecycle":
            self.b1, self.b2, self.eps = 0.9, 0.99, 1e-8
        else:
            self.b1, self.b2 = (float(b) for b in optim_cfg.get("BETAS", [0.9, 0.999]))
            self.eps = float(optim_cfg.get("EPS", 1e-8))
            self.mom_schedule = None  # b1 moves with OneCycle in adam_onecycle only
        self.momentum = float(optim_cfg.get("MOMENTUM", 0.9))
        self.wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
        clip = optim_cfg.get("GRAD_NORM_CLIP")
        self.clip = None if clip is None else float(clip)
        self.params = [p for p in params if p.requires_grad]
        self.count = 0
        # Adam's moments, or sgd's trace in ``mu``
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params] if self.name != "sgd" else []

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def _adam_direction(self, grads, b1: float):
        """scale_by_adam: the moments move, and the bias-corrected direction."""
        b2 = self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** (self.count + 1))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** (self.count + 1))
        torch._foreach_div_(update, denom)
        return update

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
        if self.clip is not None:
            clipped = norm >= self.clip
            grads = [torch.where(clipped, (g / norm) * self.clip, g) for g in grads]
        l2 = self.wd > 0 and self.name in ("adam", "sgd")
        if l2:
            grads = torch._foreach_add(grads, self.params, alpha=self.wd)
        if self.name == "sgd":
            torch._foreach_mul_(self.mu, self.momentum)
            torch._foreach_add_(self.mu, grads)
            update = self.mu
        else:
            b1 = self.b1 if self.mom_schedule is None else self.mom_schedule(self.count)
            update = self._adam_direction(grads, b1)
            if self.wd > 0 and not l2:  # decoupled: after the Adam scaling, before the lr
                torch._foreach_add_(update, self.params, alpha=self.wd)
        torch._foreach_add_(self.params, update, alpha=-self.lr_schedule(self.count))
        self.count += 1
        return norm

    def state_dict(self) -> dict:
        return {"name": self.name, "count": self.count, "mu": [m.clone() for m in self.mu],
                "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if state.get("name", "adam") != self.name:
            raise ValueError(f"optimizer state of {state.get('name', 'adam')!r}, not {self.name!r}")
        if len(state["mu"]) != len(self.params) or len(state["nu"]) != len(self.nu):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
