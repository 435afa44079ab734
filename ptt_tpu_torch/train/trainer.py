"""The epoch loop (the JAX package's ``train/trainer.py``): one train step per
loader batch, a finite-loss check per epoch, checkpoints every
``ckpt_save_interval`` epochs with rolling retention and auto-resume, and an
optional ``eval_fn`` hook after each epoch that keeps the best-Success model in
``ckpt_best.npz``. Scalars go to ``tb_writer`` only if one is passed.

Inside an epoch nothing waits for the device (``pipelined_steps``, the JAX
trainer's hot loop): dispatch d is launched, then the batches of dispatch d+1
are taken from the loader and their upload enqueued (``BatchUploader``: from
pinned memory on a side stream, which dispatch d+1 waits for), so that the
loader's workers and the upload run while dispatch d runs on the device; the
metrics of each step stay on the device until the epoch ends. On the GPU a
dispatch is one replay of the train step's CUDA graph (``train/train_step.py``
``TrainStep``; ``graph=False`` asks for the eager step), and the Trainer logs
the graph mode once. OPTIMIZATION.STEPS_PER_DISPATCH = K > 1 stacks K batches
into one dispatch of K steps, one graph, as the JAX trainer scans K steps in
one dispatch; the epoch's tail (fewer than K batches) takes the one-step
graph, as the JAX trainer's takes its single step. Both graphs are captured
in one ``utils/cuda_graph.py`` ``CaptureContext``: one memory pool and one
stream, so that they hold about one step's activations together, which is
what lets K > 1 train ``ptt_large.yaml`` and ``ptt_waymo.yaml`` on one card.
The BatchNorm momentum of a schedule is read from the device, so each graph
serves every epoch.

The loop's host work is spans of ``utils/timer.py`` (recorded while tracing
is on): ``trainer.steps`` (the whole pass, ``n`` its steps), ``trainer.fetch``
(the next group from the loader, which holds the loader's wait) and
``trainer.upload`` (stacking and ``BatchUploader.put``, ``n`` the bytes
staged), each with the index of the group's first step as its request id, as
the step's own ``train_step.dispatch`` has.

In a process group (data parallelism, ``train/train_step.py``) every rank
starts from rank 0's parameters and buffers, broadcast at construction and
after ``resume``; only rank 0 writes tensorboard scalars and checkpoints, and
``eval_fn`` runs on every rank (the test tracklets sharded, the metrics
merged).
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from .. import resolve_device
from ..config import steps_per_dispatch
from ..utils import timer
from ..utils.cuda_graph import CaptureContext
from ..utils.dist import broadcast_module, get_dist_info
from .bn_momentum import bn_momentum_for_epoch
from .checkpoint import CheckpointManager, save_variables_npz
from .optim import Optimizer
from .train_step import BatchUploader, make_multi_step, make_train_step, stack_batches


def _groups(batches, k: int):
    """``batches`` in lists of ``k``, the last one shorter if k does not
    divide their count."""
    group = []
    for batch in batches:
        group.append(batch)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def pipelined_steps(step, model, optimizer, batches, uploader: BatchUploader, bn_momentum=None,
                    multi_step=None) -> list:
    """One pass over ``batches``. Without ``multi_step`` a dispatch is one
    ``step`` (``make_train_step``) on one batch; with it (a ``TrainStep`` of K)
    a dispatch is K batches stacked into one upload and one call of
    ``multi_step``, and a last group of fewer than K goes through ``step``
    one batch at a time. Dispatch d is launched, then the batches of d+1 are
    fetched and their upload enqueued while d runs. Nothing waits on the
    device. Returns each step's metrics (dicts of 0-dim tensors on the device,
    each step's own)."""
    k = 1 if multi_step is None else multi_step.k
    groups = _groups(batches, k)
    history = []
    fetched = optimizer.count  # the index of the next fetched group's first step

    def put():
        nonlocal fetched
        with timer.span("trainer.fetch", fetched):
            group = next(groups, None)
        if group is None:
            return None
        with timer.span("trainer.upload", fetched) as span:
            stacked = stack_batches(group)
            if span is not None:
                span.n = sum(value.nbytes for value in stacked.values())
            uploaded = uploader.put(stacked)
        fetched += len(group)
        return len(group), uploaded

    with timer.span("trainer.steps") as span:
        pending = put()
        while pending is not None:
            n, uploaded = pending
            stacked = uploader.take(uploaded)
            if n == k and multi_step is not None:
                history.extend(multi_step.metrics(multi_step(model, optimizer, stacked, bn_momentum)))
            else:
                for j in range(n):
                    history.append(step(model, optimizer, {key: value[j] for key, value in stacked.items()},
                                        bn_momentum))
            pending = put()
        if span is not None:
            span.n = len(history)
    return history


class Trainer:
    """Trains ``model`` (moved to ``device``, CUDA unless the caller asks for
    the CPU) on ``train_loader`` with the optimizer of ``optim_cfg``.
    ``eval_fn(model, epoch) -> dict`` runs with the model in eval mode; a
    ``succ`` entry selects the best model. On the GPU the train step is a
    replay of its captured CUDA graph; ``graph=False`` asks for the eager
    step."""

    def __init__(self, model, model_cfg: dict, optim_cfg: dict, train_loader, output_dir, logger,
                 total_epochs: int | None = None, max_ckpt_save_num: int = 30,
                 ckpt_save_interval: int = 1, tb_writer=None, eval_fn=None, device="cuda", graph: bool = True):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        broadcast_module(self.model)
        self.rank = get_dist_info()[0]
        self.train_loader = train_loader
        self.logger = logger
        self.total_epochs = int(total_epochs if total_epochs is not None else optim_cfg["NUM_EPOCHS"])
        self.tb_writer = tb_writer if self.rank == 0 else None
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
        self.graph_context = CaptureContext(self.device)  # one pool and stream for the train graphs below
        self.train_step = make_train_step(model_cfg, device=self.device, mixed_precision=mixed_precision,
                                          graph=graph, context=self.graph_context)
        self.logger.info(f"graph: {self.train_step.steps.mode}")
        self.uploader = BatchUploader(self.device)
        k = steps_per_dispatch(optim_cfg)
        self.multi_step = None
        if k > 1:
            # the JAX trainer's line; the epoch's tail takes the one-step graph
            self.logger.info(f"steps_per_dispatch={k} (K-step CUDA graph per dispatch)")
            self.multi_step = make_multi_step(model_cfg, k, device=self.device, mixed_precision=mixed_precision,
                                              graph=graph, context=self.graph_context)
        self.bn_sched_cfg = optim_cfg.get("BN_SCHEDULER")
        self.output_dir = Path(output_dir)
        self.ckpt = CheckpointManager(self.output_dir / "ckpt", max_to_keep=max_ckpt_save_num)
        self.ckpt_save_interval = int(ckpt_save_interval)
        self.start_epoch = 0
        self.accumulated_iter = 0
        self._best_succ = float("-inf")

    def resume(self, path=None):
        """Continue from the training checkpoint ``path``, or else from the
        newest checkpoint of the run directory, if any. Then, in a process
        group, every rank holds rank 0's parameters and buffers."""
        if path is None and self.ckpt.latest_epoch() is None:
            self.logger.info("no checkpoint found; starting from scratch")
            broadcast_module(self.model)
            return self
        self.start_epoch, self.accumulated_iter = self.ckpt.restore(self.model, self.optimizer, path=path)
        broadcast_module(self.model)
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
            history = pipelined_steps(self.train_step, self.model, self.optimizer, self.train_loader, self.uploader,
                                      bn_m, self.multi_step)
            self.accumulated_iter += len(history)
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
                    if self.rank == 0:
                        save_variables_npz(self.output_dir / "ckpt_best.npz", self.model,
                                           metadata={"epoch": trained, "succ": float(succ),
                                                     "prec": float(eval_metrics.get("prec", -1.0))})
                    self.logger.info(f"new best Success {succ:.1f} at epoch {trained}; saved ckpt_best.npz")
        return self.model
