"""The check that decides ``correct`` against a broken timed path: a run on
the CPU at a tiny size (``run_cell``, without the look for a card) with the
program broken underneath comes out not correct, once for each fault a cell
can have: a step that returns its state unchanged, half of the batch left
out, an answer altered where it is produced. (No cell exchanges anything
between chips.)"""

import pytest
import torch

from benchmark import run
from benchmark.tests._tiny import TRACK, tiny


def _run(cell):
    return run.run_cell(tiny(run.load_cell(cell)), 2**31 + 99, 0.5, False, device="cpu")


def _step_unchanged(monkeypatch):
    from ptt_tpu_torch.eval import device_loop

    def step(self, s):  # the box stays where it was, t advances
        s.boxes[:, int(s.t)] = s.prev
        s.t.add_(1)

    monkeypatch.setattr(device_loop.FrameLoop, "step", step)


def _half_batch(monkeypatch):
    from ptt_tpu_torch.eval import device_loop

    orig = device_loop.FrameLoop.step

    def step(self, s):  # the second half of the batch is not tracked
        t, half = int(s.t), s.prev.shape[0] // 2
        keep = s.prev[half:].clone()
        orig(self, s)
        s.prev[half:] = keep
        s.boxes[half:, t] = keep

    monkeypatch.setattr(device_loop.FrameLoop, "step", step)


def _altered(monkeypatch):
    from ptt_tpu_torch.eval import device_loop

    orig = device_loop.decode_box_offset

    def decode(box_vec, offset4, use_z):  # each box 5 cm off along x
        out = orig(box_vec, offset4, use_z)
        return out + torch.tensor([0.05, 0.0, 0.0, 0.0])

    monkeypatch.setattr(device_loop, "decode_box_offset", decode)


def _slot_altered(monkeypatch):
    from ptt_tpu_torch.eval import device_loop

    orig = device_loop.FrameLoop.step

    def step(self, s):  # the last tracklet's boxes 0.5 m off along x from the middle frame on
        t = int(s.t)
        orig(self, s)
        if t >= TRACK["frames"] // 2:
            s.prev[-1, 0] += 0.5
            s.boxes[-1, t, 0] += 0.5

    monkeypatch.setattr(device_loop.FrameLoop, "step", step)


@pytest.mark.parametrize("fault", [_step_unchanged, _half_batch, _altered, _slot_altered])
@pytest.mark.parametrize("cell", ["ptt.track"])
def test_track_fault(cell, fault, monkeypatch):
    fault(monkeypatch)
    result = _run(cell)
    assert result["correct"] is False
    if fault is _slot_altered:  # the wild share is the number that catches it
        wild = result["checks"]["box_wild_share"]
        assert wild["value"] > wild["limit"], result["checks"]


def _train_unchanged(monkeypatch):
    from ptt_tpu_torch.train.optim import Optimizer

    @torch.no_grad()
    def update(self, hyper):  # the gradient's norm, and no update
        return torch.stack([(p.grad * p.grad).sum() for p in self.params if p.grad is not None]).sum().sqrt()

    monkeypatch.setattr(Optimizer, "update", update)


def _train_half(monkeypatch):
    from ptt_tpu_torch.train import train_step

    orig = train_step.compute_losses

    def losses(model_cfg, out, batch):  # the mean over the first half of the batch
        half = batch["search_points"].shape[0] // 2
        return orig(model_cfg, {k: v[:half] for k, v in out.items()}, {k: v[:half] for k, v in batch.items()})

    monkeypatch.setattr(train_step, "compute_losses", losses)


def _train_altered(monkeypatch):
    from ptt_tpu_torch.train import train_step

    orig = train_step.compute_losses

    def losses(model_cfg, out, batch):  # the regression target 10 cm off
        batch = dict(batch, reg_label=batch["reg_label"] + 0.1)
        return orig(model_cfg, out, batch)

    monkeypatch.setattr(train_step, "compute_losses", losses)


@pytest.mark.parametrize("fault", [_train_unchanged, _train_half, _train_altered])
@pytest.mark.parametrize("cell", ["ptt.train", "p2b.train"])
def test_train_fault(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(cell)["correct"] is False
