"""Adam with a stepped learning rate and global-norm clipping, the optax chain
that the JAX package's ``train/optim.py`` builds for ``OPTIMIZER: adam`` and
``SCHEDULER: step`` (the ptt.yaml recipe):

    clip_by_global_norm(clip) -> [add_decayed_weights(wd)] -> scale_by_adam
    -> scale_by_learning_rate(schedule)

written out on tensors. Where it differs from ``torch.optim.Adam`` with
``clip_grad_norm_``: gradients are scaled by clip / norm only when norm > clip
(torch scales by clip / (norm + 1e-6) whenever norm > clip); the moments are
(1 - b) * g + b * m; the update is m_hat / (sqrt(v_hat) + eps); and the
learning rate of update k is the schedule at the pre-increment count k.
Weight decay, when set, is added to the gradient (L2, not decoupled).
"""

from __future__ import annotations

import torch


def step_lr_schedule(base_lr: float, step_size_epochs: int, gamma: float, iters_per_epoch: int):
    """StepLR stepped per epoch: lr(count) = base * gamma^(epoch // step_size)."""

    def schedule(count: int) -> float:
        epoch = count // max(1, iters_per_epoch)
        return base_lr * (gamma ** (epoch // step_size_epochs))

    return schedule


class Adam:
    """The optimizer of ``optim_cfg`` (the OPTIMIZATION section) over
    ``params``. ``step()`` reads each parameter's ``.grad``, clips, updates the
    parameters in place and returns the global norm of the unclipped gradients
    as a 0-dim tensor on their device (no host sync)."""

    def __init__(self, params, optim_cfg: dict, iters_per_epoch: int):
        name = optim_cfg["OPTIMIZER"]
        if name != "adam":
            raise NotImplementedError(f"optimizer {name!r} is not ported yet (adam only)")
        scheduler = optim_cfg.get("SCHEDULER")
        if scheduler != "step":
            raise NotImplementedError(f"scheduler {scheduler!r} is not ported yet (step only)")
        self.params = [p for p in params if p.requires_grad]
        self.lr_schedule = step_lr_schedule(float(optim_cfg["LR"]), int(optim_cfg["STEP_SIZE"]),
                                            float(optim_cfg["GAMMA"]), iters_per_epoch)
        self.b1, self.b2 = (float(b) for b in optim_cfg.get("BETAS", [0.9, 0.999]))
        self.eps = float(optim_cfg.get("EPS", 1e-8))
        self.wd = float(optim_cfg.get("WEIGHT_DECAY", 0.0))
        clip = optim_cfg.get("GRAD_NORM_CLIP")
        self.clip = None if clip is None else float(clip)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
        if self.clip is not None:
            clipped = norm >= self.clip
            grads = [torch.where(clipped, (g / norm) * self.clip, g) for g in grads]
        if self.wd > 0:
            grads = torch._foreach_add(grads, self.params, alpha=self.wd)
        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        lr = self.lr_schedule(self.count)
        self.count += 1
        denom = torch._foreach_div(self.nu, 1.0 - b2 ** self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        update = torch._foreach_div(self.mu, 1.0 - b1 ** self.count)
        torch._foreach_div_(update, denom)
        torch._foreach_add_(self.params, update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [m.clone() for m in self.mu], "nu": [v.clone() for v in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        if len(state["mu"]) != len(self.params):
            raise ValueError("optimizer state does not match the parameters")
        self.count = int(state["count"])
        for dst, src in zip(self.mu + self.nu, list(state["mu"]) + list(state["nu"])):
            dst.copy_(src)
