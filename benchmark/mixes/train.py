"""Traffic kind ``train``: the program's graphed train step fed by the
Trainer's loop, as the train CLI runs it (``train/trainer.py``
``pipelined_steps`` with ``train/train_step.py`` ``BatchUploader`` and
``make_train_step``: one CUDA graph replay a step), on a pool of distinct
batches of synthetic train items made at set-up.

Set-up builds the model on the seed's weights, the optimizer of the
OPTIMIZATION section and the step, then drives that same step through the
window's own loop and uploader on the first pool batches: step 0, whose
dispatch runs the body eagerly and then captures it (the start), then
``checked_steps`` steps, each a replay of that graph as every step of the
window is. It keeps what the check reads: the start's loss and gradient (the
optimizer's first moments after it over 1 - b1), the program's whole state
after the start (parameters, moments, count), each replayed step's loss, the
first replayed step's gradient as the optimizer got it ((m1 - b1 m0) / (1 -
b1)), and the parameters after the last. Then warm-up steps, and the window:
pool batches cycled through ``pipelined_steps`` until ``seconds`` have
passed, at most ``in_flight`` steps queued ahead of the device, then a
synchronize. ``train_step_ms``: the window over its steps.

The check, after the window, follows the program from its own state, as the
track check follows its boxes: Adam's first updates are sign-like, so two
sound runs of the same steps part by whole learning rates on entries whose
gradient is rounding, and only a reference that starts where the program
stands can judge a replay. So the reference's step 0 runs from the seed's
weights and judges the start; its replayed steps run from the program's
state after the start. Compared, as |norm(program) - norm(reference)| over
the larger of the reference's norm and the median parameter's: the start's
loss and gradient by the worst parameter; the first replay's loss and
gradient by the worst parameter; and the change over the replays of the
median parameter (the worst one is a small leaf's rounding, PERF.md).
Parameters whose reference gradient is under a thousandth of the median
parameter's (fc_gamma's last bias, whose shift the softmax cancels) move by
round-off alone under Adam and are left out of the change.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace as btrace
from ..counts.flops import train_step_flops
from ..counts.group import group_bwd_counts, group_fwd_counts
from ..gen.items import TrainItems, batch_pool
from ..gen.tracklets import generate
from ..reference import model as ref_model
from ..reference import train as ref_train

SILENT_GRAD = 1e-3  # a parameter whose first reference gradient is under this share of the median's is left out


def leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """|prog - ref| / max(ref, median of ref) of each of ``names``."""
    med = float(np.median([ref[n] for n in names]))
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med) for n in names}


def worst_gap(prog: dict, ref: dict, names) -> float:
    return max(leaf_gaps(prog, ref, names).values())


def median_gap(prog: dict, ref: dict, names) -> float:
    return float(np.median(list(leaf_gaps(prog, ref, names).values())))


class Train:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        data = cfg["DATA_CONFIG"]
        tracklets = generate(int(tr["train_tracklets"]), int(tr["train_frames"]), int(tr["object_points"]),
                             int(tr["clutter_points"]), ctx.seed)
        self.batch = int(tr["batch_size"])
        self.pool = batch_pool(TrainItems(tracklets, data, ctx.seed), int(tr["pool_batches"]), self.batch, ctx.seed)
        ctx.mark("train items")
        self.weights = ref_model.make_weights(ref_model.param_specs(cfg["MODEL"]), ctx.seed, self.device)
        ctx.mark("weights")
        self.n_checked = int(tr["checked_steps"])
        self.traced = None
        self.steps = 0
        self._build()

    def _build(self):
        from ptt_tpu_torch.nn import build_network
        from ptt_tpu_torch.train.optim import Optimizer
        from ptt_tpu_torch.train.train_step import BatchUploader, make_train_step

        cfg, tr = self.ctx.config, self.ctx.traffic
        self.model = build_network(cfg["MODEL"], device=self.device, train=True)
        self.model.load_state_dict(self.weights, strict=True)
        self.optimizer = Optimizer(self.model.parameters(), cfg["OPTIMIZATION"], int(tr["iters_per_epoch"]))
        self.step = make_train_step(cfg["MODEL"], device=self.device)
        self.uploader = BatchUploader(self.device)
        self.ctx.mark("program")
        names = [n for n, _ in self.model.named_parameters()]
        opt, b1 = self.optimizer, self.optimizer.b1

        def moments():
            return {n: m.detach().clone() for n, m in zip(names, opt.mu)}, \
                   {n: v.detach().clone() for n, v in zip(names, opt.nu)}

        def losses(history):
            return [{k: float(v) for k, v in m.items()} for m in history]

        start = self._run(self.pool[:1])
        m0, v0 = moments()
        self.state0 = {"params": {n: p.detach().clone() for n, p in self.model.named_parameters()},
                       "m": m0, "v": v0, "count": opt.count}
        self.start = {"losses": losses(start), "grad1": {n: m / (1.0 - b1) for n, m in m0.items()}}
        first = self._run(self.pool[1:2])
        m1, _ = moments()
        rest = self._run(self.pool[2:1 + self.n_checked])
        self.sync()
        self.readings = {"losses": losses(first + rest),
                         "grad1": {n: (m1[n] - b1 * m0[n]) / (1.0 - b1) for n in names},
                         "params": {n: p.detach().clone() for n, p in self.model.named_parameters()}}
        self.ctx.mark("checked steps")
        k = 1 + self.n_checked
        self._run([self.pool[(k + i) % len(self.pool)] for i in range(int(tr["warmup_steps"]))])
        self.sync()
        self.ctx.mark("warm-up")

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, batches) -> list:
        from ptt_tpu_torch.train.trainer import pipelined_steps

        return pipelined_steps(self.step, self.model, self.optimizer, batches, self.uploader)

    # ------------------------------------------------------------------ window

    def _feed(self, deadline=None, count=None):
        """Pool batches from the next index until ``deadline`` or ``count``,
        each fetched after the previous step was enqueued, never more than
        ``in_flight`` steps ahead of the device."""
        depth = int(self.ctx.traffic["in_flight"])
        events, n = [], 0
        while (deadline is None or time.perf_counter() < deadline) and (count is None or n < count):
            if self.device.type == "cuda" and n:
                events.append(torch.cuda.Event())
                events[-1].record()
                if len(events) > depth:
                    events.pop(0).synchronize()
            yield self.pool[(1 + self.n_checked + self.steps) % len(self.pool)]
            self.steps += 1
            n += 1

    def _steps(self, deadline=None, count=None):
        with btrace.span("steps"):
            self.history.extend(self._run(self._feed(deadline, count)))
            self.sync()

    def failures(self):
        """(steps whose loss is not finite, steps) of the window."""
        losses = torch.stack([m["loss"] for m in self.history]) if self.history else torch.zeros(0)
        return int((~torch.isfinite(losses)).sum()), len(self.history)

    def window(self, seconds: float, trace: bool) -> dict:
        start = time.perf_counter()
        self.steps, self.history = 0, []
        if trace:
            self._steps(deadline=start + seconds / 2)
            n = int(self.ctx.traffic["traced_steps"])
            self.traced = btrace.traced(lambda: self._steps(count=n))
            self.steps_traced = n
        self._steps(deadline=start + seconds)
        return {"train_step_ms": (time.perf_counter() - start) * 1e3 / self.steps}

    def release(self) -> None:
        for name in ("model", "optimizer", "step", "uploader"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------- check

    def reference(self, tf32: bool = False, half: bool = False) -> dict:
        """The reference's steps: ``start``, step 0 from the seed's weights,
        and ``steps``, the checked steps from the program's state after step
        0; with TF32 products where ``tf32``, on the first half of each batch
        where ``half`` (the control and a fault, in the program's place)."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
        pool = self.pool[:1 + self.n_checked]
        if half:
            pool = [{k: v[:len(v) // 2] for k, v in b.items()} for b in pool]
        model_cfg, optim_cfg = self.ctx.config["MODEL"], self.ctx.config["OPTIMIZATION"]
        try:
            start = ref_train.steps(model_cfg, optim_cfg, self.weights, pool[:1], self.device)
            s0 = self.state0
            steps = ref_train.steps(model_cfg, optim_cfg, dict(self.weights, **s0["params"]), pool[1:], self.device,
                                    adam_state=(s0["m"], s0["v"], s0["count"]))
            return {"start": start, "steps": steps}
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def leaves(self, got: dict, ref: dict) -> dict:
        """Per parameter: the reference's first gradient norm of the checked
        steps, and the change norms of both sides over them, of the moving
        parameters."""
        names = list(ref["params"])
        g_ref = {n: float(ref["grad1"][n].norm()) for n in names}
        med = float(np.median(list(g_ref.values())))
        moving = [n for n in names if g_ref[n] >= SILENT_GRAD * med]
        p0 = self.state0["params"]
        return {"grad": g_ref, "moving": moving,
                "d_ref": {n: float((ref["params"][n] - p0[n]).norm()) for n in moving},
                "d_got": {n: float((got["params"][n] - p0[n]).norm()) for n in moving}}

    def compare(self, got: dict, ref: dict) -> dict:
        """The numbers compared, of ``got`` (the program's readings, or a
        control's: {"start": ..., "steps": ...}) against ``ref``, the
        reference's."""

        def loss_gap(a, b):
            return abs(a["losses"][0]["loss"] - b["losses"][0]["loss"]) / abs(b["losses"][0]["loss"])

        def grad_gap(a, b):
            names = list(b["grad1"])
            return worst_gap({n: float(a["grad1"][n].norm()) for n in names},
                             {n: float(b["grad1"][n].norm()) for n in names}, names)

        leaves = self.leaves(got["steps"], ref["steps"])
        return {"start_loss_gap": loss_gap(got["start"], ref["start"]),
                "start_grad_gap": grad_gap(got["start"], ref["start"]),
                "loss_gap": loss_gap(got["steps"], ref["steps"]),
                "grad_gap": grad_gap(got["steps"], ref["steps"]),
                "change_gap": median_gap(leaves["d_got"], leaves["d_ref"], leaves["moving"])}

    def program_readings(self) -> dict:
        return {"start": self.start, "steps": self.readings}

    def check(self) -> dict:
        ref = self.reference()
        self._count_group()
        return self.compare(self.program_readings(), ref)

    def _count_group(self):
        """The group kernels' bytes and operations of one train step, from
        the reference's SA calls on the first pool batch."""
        b = {k: torch.from_numpy(v).to(self.device) for k, v in self.pool[0].items()}
        calls = []
        with torch.no_grad():
            ref_model.forward(self.weights, self.ctx.config["MODEL"], b["search_points"], b["template_points"],
                              train=True, calls=calls)
        fwd = [group_fwd_counts(xyz, ctr, widths[0], r, ns) for xyz, ctr, _, r, ns, widths in calls]
        bwd = [group_bwd_counts(xyz.shape[0], xyz.shape[1], ctr.shape[1], ns, widths[0])
               for xyz, ctr, _, r, ns, widths in calls]
        self.group_counts = {"fwd": fwd, "bwd": bwd}

    # ---------------------------------------------------------------- readings

    def layer_readings(self) -> dict:
        """What the per-layer metrics read; the FLOPs of a train step are
        counted here, after the window, for a traced run only."""
        flops = None
        if self.traced is not None:
            data = self.ctx.config["DATA_CONFIG"]
            flops = train_step_flops(self.ctx.config["MODEL"], self.batch, int(data["SEARCH_INPUT_SIZE"]),
                                     int(data["TEMPLATE_INPUT_SIZE"]))
        return {"traced": self.traced, "steps_traced": getattr(self, "steps_traced", 0), "flops_per_step": flops,
                "group_counts": getattr(self, "group_counts", None)}


def setup(ctx):
    return Train(ctx)
