"""The epoch loop (the JAX package's ``train/trainer.py``): one train step per
loader batch, a finite-loss check per epoch, checkpoints every
``ckpt_save_interval`` epochs with rolling retention and auto-resume, and an
optional ``eval_fn`` hook after each epoch that keeps the best-Success model in
``ckpt_best.npz``. Scalars go to ``tb_writer`` only if one is passed.

Inside an epoch nothing waits for the device: the metrics of each step stay on
the device until the epoch ends.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from .bn_momentum import bn_momentum_for_epoch
from .checkpoint import CheckpointManager, save_variables_npz
from .optim import Optimizer
from .train_step import make_train_step


class Trainer:
    """Trains ``model`` (moved to ``device``, CUDA unless the caller asks for
    the CPU) on ``train_loader`` with the optimizer of ``optim_cfg``.
    ``eval_fn(model, epoch) -> dict`` runs with the model in eval mode; a
    ``succ`` entry selects the best model."""

    def __init__(self, model, model_cfg: dict, optim_cfg: dict, train_loader, output_dir, logger,
                 total_epochs: int | None = None, max_ckpt_save_num: int = 30,
                 ckpt_save_interval: int = 1, tb_writer=None, eval_fn=None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.train_loader = train_loader
        self.logger = logger
        self.total_epochs = int(total_epochs if total_epochs is not None else optim_cfg["NUM_EPOCHS"])
        self.tb_writer = tb_writer
        self.eval_fn = eval_fn
        self.optimizer = Optimizer(self.model.parameters(), optim_cfg, len(train_loader), self.total_epochs)
        self.logger.info(f"optimizer={self.optimizer.name} with the "
                         f"{'OneCycle' if optim_cfg.get('SCHEDULER') is None else optim_cfg['SCHEDULER']} lr schedule"
                         f"{', OneCycle b1' if self.optimizer.mom_schedule else ''}")
        mixed_precision = bool(optim_cfg.get("MIXED_PRECISION", False))
        # the effective precision in every run log, as the JAX trainer logs it
        self.logger.info("mixed_precision=%s (%s; set OPTIMIZATION.MIXED_PRECISION: %s to flip)"
                         % ("bf16" if mixed_precision else "f32",
                            "default" if "MIXED_PRECISION" not in optim_cfg else "from config", not mixed_precision))
        self.train_step = make_train_step(model_cfg, device=self.device, mixed_precision=mixed_precision)
        self.bn_sched_cfg = optim_cfg.get("BN_SCHEDULER")
        self.output_dir = Path(output_dir)
        self.ckpt = CheckpointManager(self.output_dir / "ckpt", max_to_keep=max_ckpt_save_num)
        self.ckpt_save_interval = int(ckpt_save_interval)
        self.start_epoch = 0
        self.accumulated_iter = 0
        self._best_succ = float("-inf")

    def resume(self, path=None):
        """Continue from the training checkpoint ``path``, or else from the
        newest checkpoint of the run directory, if any."""
        if path is None and self.ckpt.latest_epoch() is None:
            self.logger.info("no checkpoint found; starting from scratch")
            return self
        self.start_epoch, self.accumulated_iter = self.ckpt.restore(self.model, self.optimizer, path=path)
        self.logger.info(f"resumed from {path or self.ckpt.ckpt_dir} at epoch {self.start_epoch} "
                         f"(step {self.accumulated_iter})")
        return self

    def _bn_momentum(self, epoch: int):
        if not self.bn_sched_cfg:
            return None
        c = self.bn_sched_cfg
        torch_m = bn_momentum_for_epoch(epoch, bn_init=float(c.get("BN_INIT", 0.5)),
                                        bn_decay=float(c.get("BN_DECAY", 0.5)),
                                        decay_step=int(c.get("DECAY_STEP", 20)),
                                        bn_clip=float(c.get("BN_CLIP", 0.01)))
        return 1.0 - torch_m

    def train(self):
        n_iters = len(self.train_loader)
        for epoch in range(self.start_epoch, self.total_epochs):
            self.train_loader.set_epoch(epoch)
            bn_m = self._bn_momentum(epoch)
            t0 = time.perf_counter()
            history = []
            for batch in self.train_loader:
                history.append(self.train_step(self.model, self.optimizer, batch, bn_m))
                self.accumulated_iter += 1
            if not history:
                raise RuntimeError("the train loader gave no batch")
            if self.tb_writer is not None:
                first = self.accumulated_iter - len(history) + 1
                for i, metrics in enumerate(history):
                    # the lr of update k is the schedule at the pre-increment count k - 1
                    self.tb_writer.add_scalar("meta_data/learning_rate",
                                              self.optimizer.lr_schedule(first + i - 1), first + i)
                    for key, val in metrics.items():
                        self.tb_writer.add_scalar(f"train/{key}", float(val), first + i)
            metrics = {k: float(v) for k, v in history[-1].items()}
            dt = time.perf_counter() - t0
            self.logger.info(
                f"epoch {epoch + 1}/{self.total_epochs}  loss {metrics['loss']:.4f}  "
                f"lr {self.optimizer.lr_schedule(self.accumulated_iter):.2e}  "
                f"{dt:.1f}s ({dt / max(1, n_iters) * 1e3:.0f} ms/it)")
            if not np.isfinite(metrics["loss"]):
                raise FloatingPointError(f"non-finite loss at epoch {epoch + 1}")

            trained = epoch + 1
            if trained % self.ckpt_save_interval == 0 or trained == self.total_epochs:
                self.ckpt.save(self.model, self.optimizer, trained, self.accumulated_iter)
            if self.eval_fn is not None:
                self.model.eval()
                eval_metrics = self.eval_fn(self.model, trained) or {}
                if self.tb_writer is not None:
                    for key, val in eval_metrics.items():
                        self.tb_writer.add_scalar(f"eval/{key}", float(val), trained)
                succ = eval_metrics.get("succ")
                if succ is not None and succ > self._best_succ:
                    self._best_succ = float(succ)
                    save_variables_npz(self.output_dir / "ckpt_best.npz", self.model,
                                       metadata={"epoch": trained, "succ": float(succ),
                                                 "prec": float(eval_metrics.get("prec", -1.0))})
                    self.logger.info(f"new best Success {succ:.1f} at epoch {trained}; saved ckpt_best.npz")
        return self.model
