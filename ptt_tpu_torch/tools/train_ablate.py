"""Roofline split of the train step (the JAX package's ``tools/train_ablate.py``)::

    python3 -m ptt_tpu_torch.tools.train_ablate [--iters 24] [--batch_size 48]
        [--cfg_file tools/cfgs/kitti_models/ptt.yaml] [--device cuda]

At B = 48 on the synthetic dataset (16 tracklets x 24 frames), from the
port's seeded init, six rows:

- the full step (forward, losses, backward, the optimizer) in float32 and in
  bf16 (OPTIMIZATION.MIXED_PRECISION), each with the kernels and with the
  plain path (``nn.set_use_kernels(model, False)``: the group forward and
  backward and FPS in plain PyTorch, the counterpart of the JAX tool's jnp
  group path);
- forward and losses only (no gradient, no update), float32 and bf16.

Each row is timed on the GPU as one CUDA graph, the full step's as the
Trainer runs it (``TrainStep``), the forward's captured on its own: ``--iters``
replays chained without a sync, timed by CUDA events after a warm-up. Each
variant's graph and pool are released before the next (a pool is about one
step's activations). Then "backward + optimizer by subtraction".

FLOPs and bytes are counted once per precision on the plain path of a copy of
the model (the custom kernels are ctypes calls that no dispatch mode sees):
FLOPs by ``FlopCounterMode`` (matrix products, convolutions and attention
only), bytes as the sum of every operator's input and output tensor bytes
under a ``TorchDispatchMode`` (views left out, a tensor counted once an
operator). They are unfused bytes: what the step would move if no operator
kept anything on chip, an upper bound of its traffic, not XLA's post-fusion
count. The floors are FLOPs over the precision's peak (H100 SXM: float32 67
TFLOP/s with TF32 off, dense bf16 989 TFLOP/s) and unfused bytes over 3.35
TB/s. The table gives each floor's share of the measured time: the FLOP
floor's is the roofline figure; the unfused-byte floor overstates the step's
real traffic, so its share is no roofline share and says nothing of whether
bytes bind. The kernel rows take the plain path's counts. ``--device cpu`` runs the same code on the CPU
(eager, the host's clock, no floors).
"""

from __future__ import annotations

import argparse
import copy
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_FLOPS = {"float32": 67e12, "bf16": 989e12}  # H100 SXM, dense; TF32 off for float32
HBM_BYTES_PER_S = 3.35e12


class ByteCounter(TorchDispatchMode):
    """The bytes of every operator's tensor inputs and outputs, each tensor
    once an operator (an in-place operator's output is its input), view
    operators left out: they move nothing."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            seen = {id(t): t for t in tree_flatten((args, kwargs, out))[0] if isinstance(t, torch.Tensor)}
            self.bytes += sum(t.numel() * t.element_size() for t in seen.values())
        return out


def step_cost(model_cfg: dict, model, batch: dict, optim_cfg: dict, mixed_precision: bool, backward: bool):
    """(FLOPs, unfused bytes) of one step on ``batch`` on the plain path of a
    copy of ``model``: forward and losses, with ``backward`` also the
    backward and the optimizer's update."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..nn import compute_losses, set_use_kernels
    from ..train.optim import Optimizer
    from ..train.train_step import forward

    walk = copy.deepcopy(model).train()
    set_use_kernels(walk, False)
    opt = Optimizer(walk.parameters(), optim_cfg, 100, 60)
    flops, nbytes = FlopCounterMode(display=False), ByteCounter()
    with flops, nbytes:
        with torch.set_grad_enabled(backward):
            loss, _ = compute_losses(model_cfg, forward(walk, batch, mixed_precision), batch)
        if backward:
            opt.zero_grad()
            loss.backward()
            opt.step()
    return float(flops.get_total_flops()), float(nbytes.bytes)


def _replays_ms(run, iters: int, device) -> float:
    from .train_bench import device_ms

    for _ in range(2):
        run()
    return device_ms(lambda: [run() for _ in range(iters)], device) / iters


def time_full_step(cfg, batch, mixed_precision: bool, kernels: bool, iters: int, device) -> float:
    """ms a step of the train step (one graph replay on the GPU) on ``batch``."""
    from ..nn import build_network, set_use_kernels
    from ..train.optim import Optimizer
    from ..train.train_step import make_train_step

    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device=device, train=True)
    set_use_kernels(model, kernels)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], 100, 60)
    step = make_train_step(cfg["MODEL"], device=device, mixed_precision=mixed_precision)
    try:
        step(model, opt, batch)  # the eager step, then the capture
        return _replays_ms(lambda: step(model, opt, batch), iters, device)
    finally:
        step.steps.close()
        opt.zero_grad()


def time_forward(cfg, batch, mixed_precision: bool, iters: int, device) -> float:
    """ms of the train-mode forward and losses, no gradient (one graph replay
    on the GPU), with the kernels."""
    from ..nn import build_network, compute_losses
    from ..train.train_step import forward
    from ..utils import cuda_graph

    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device=device, train=True)

    @torch.no_grad()
    def body():
        return compute_losses(cfg["MODEL"], forward(model, batch, mixed_precision), batch)[0]

    if device.type != "cuda":
        return _replays_ms(body, iters, device)
    graph = cuda_graph.StepGraph(body, device)
    try:
        return _replays_ms(graph.replay, iters, device)
    finally:
        graph.release()


ROWS = (  # name, mixed precision, kernels, full step
    ("full step, f32, kernels", False, True, True),
    ("full step, bf16, kernels", True, True, True),
    ("full step, f32, plain group path", False, False, True),
    ("full step, bf16, plain group path", True, False, True),
    ("fwd + loss only, f32, kernels", False, True, False),
    ("fwd + loss only, bf16, kernels", True, True, False),
)


def ablate(cfg, batch, iters: int, device, log=None) -> list:
    """The six rows: dicts of name, precision, ms, flops, bytes."""
    from ..nn import build_network

    torch.manual_seed(0)
    costs, rows = {}, []
    model = build_network(cfg["MODEL"], device=device, train=True)
    for mixed in (False, True):
        for full in (True, False):
            costs[mixed, full] = step_cost(cfg["MODEL"], model, batch, cfg["OPTIMIZATION"], mixed, full)
    del model
    for name, mixed, kernels, full in ROWS:
        if full:
            ms = time_full_step(cfg, batch, mixed, kernels, iters, device)
        else:
            ms = time_forward(cfg, batch, mixed, iters, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()  # the variant's released pool, before the next is captured
        flops, nbytes = costs[mixed, full]
        rows.append({"name": name, "precision": "bf16" if mixed else "float32", "ms": ms, "flops": flops,
                     "bytes": nbytes})
        if log is not None:
            log(f"  measured {name}: {ms:.1f} ms")
    return rows


def roofline(row: dict) -> dict:
    """The FLOP floor and the unfused-byte floor of a row, each floor's share
    of the measured time, and the rate of unfused bytes."""
    flop_floor = row["flops"] / PEAK_FLOPS[row["precision"]] * 1e3
    byte_floor = row["bytes"] / HBM_BYTES_PER_S * 1e3
    return {"flop_floor_ms": flop_floor, "byte_floor_ms": byte_floor,
            "flop_pct": 100 * flop_floor / row["ms"], "byte_pct": 100 * byte_floor / row["ms"],
            "gb_per_s": row["bytes"] / (row["ms"] / 1e3) / 1e9}


def format_rows(rows, on_card: bool) -> str:
    lines = ["| Variant | Device ms | GFLOP | GB (unfused) | FLOP floor ms | unfused-byte floor ms "
             "| FLOP floor / measured | unfused-byte floor / measured | unfused GB/s |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        head = f"| {r['name']} | {r['ms']:.1f} | {r['flops'] / 1e9:.1f} | {r['bytes'] / 1e9:.2f} "
        if not on_card:
            lines.append(head + "| n/a (cpu) | | | | |")
            continue
        f = roofline(r)
        lines.append(head + f"| {f['flop_floor_ms']:.2f} | {f['byte_floor_ms']:.2f} | {f['flop_pct']:.1f}% "
                            f"| {f['byte_pct']:.0f}% | {f['gb_per_s']:.0f} |")
    ms = [r["ms"] for r in rows]  # in the order of ROWS
    lines.append(f"\nbackward + optimizer by subtraction: f32 {ms[0] - ms[4]:.1f} ms, bf16 {ms[1] - ms[5]:.1f} ms")
    lines.append("(floors: FLOPs over 67e12 (f32, TF32 off) or 989e12 (bf16) FLOP/s, unfused bytes over 3.35e12 B/s, "
                 "one H100 SXM; FLOPs are FlopCounterMode's matrix-product class; 'FLOP floor / measured' is the "
                 "roofline share; bytes are every operator's inputs and outputs, unfused, far above the step's "
                 "real traffic, so 'unfused-byte floor / measured' is no roofline share)")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="roofline split of the train step")
    parser.add_argument("--iters", type=int, default=24)
    parser.add_argument("--batch_size", type=int, default=48)
    parser.add_argument("--cfg_file", default="tools/cfgs/kitti_models/ptt.yaml")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--tracklets", type=int, default=16)
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..config import cli_config
    from ..data.loader import build_dataloader
    from ..train.train_step import to_device
    from .train_bench import card_line

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    cfg = cli_config(args.cfg_file, args.set_cfgs)
    ds_cfg = dict(cfg["DATA_CONFIG"], DATASET="SyntheticTrackingDataset", NUM_TRACKLETS=args.tracklets,
                  FRAMES_PER_TRACKLET=args.frames)
    _, loader = build_dataloader(ds_cfg, cfg["CLASS_NAMES"], args.batch_size, workers=0, training=True)
    batch = to_device(next(iter(loader)), device)
    rows = ablate(cfg, batch, args.iters, device, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print("\n" + format_rows(rows, device.type == "cuda"), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
