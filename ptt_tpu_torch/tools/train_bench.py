"""Training-side performance on one GPU (the JAX package's ``tools/train_bench.py``):

    python3 -m ptt_tpu_torch.tools.train_bench [--iters 32] [--batch_size 48] [--steps_per_dispatch 4]
        [--configs CFG ...] [--set KEY VALUE ...]

For each configuration (``kitti_models/ptt.yaml`` and ``ptt_large.yaml`` by
default), at B = 48 on the synthetic dataset (16 tracklets x 24 frames, as the
JAX tool takes it), from the port's seeded init:

- device step: ``--iters`` steps on one batch already on the device, chained
  without a sync and timed by CUDA events after 4 warm-up steps; on the GPU
  each step is a replay of the train step's CUDA graph, as in the Trainer;
- end-to-end ms/it over one epoch of the loader (``--workers`` processes):
  pipelined, the Trainer's loop (``train/trainer.py`` ``pipelined_steps``:
  batch k+1 uploaded from pinned memory while step k runs, no sync inside);
  blocking (each batch uploaded inside its step, the loss read after it);
  and K-dispatch, the Trainer's loop at OPTIMIZATION.STEPS_PER_DISPATCH = K
  (``--steps_per_dispatch``): K batches a dispatch, one replay of the K-step
  graph (captured before the epoch beside the live one-step graph, in the
  one pool and stream the two share, as the Trainer's do; an epoch's tail
  takes the one-step graph); the pool is printed after each column;
- samples/s: B over the pipelined ms/it;
- GFLOP a step: forward, losses and backward as ``FlopCounterMode`` counts
  them (``utils/profiling.py`` ``train_step_flops``);
- mfu: those FLOPs over the device step, as a share of the card's peak in the
  precision the step runs in (``PEAK_FLOPS``).

The first line names the card and its power limit, then the markdown table of
the JAX tool. ``--device cpu`` runs the same code on the CPU at the size the
caller gives (``--set``, ``--tracklets``), for the tests; its times are the
host's, and it prints no mfu.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

# NVIDIA's H100 SXM data sheet, dense: float32 on the CUDA cores (this package
# keeps TF32 off) and bf16 on the tensor cores (OPTIMIZATION.MIXED_PRECISION)
PEAK_FLOPS = {"float32": 67e12, "bf16": 989e12}


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the CPU."""
    if device.type != "cuda":
        return "device: cpu (host times; no device metric)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return f"device: {torch.cuda.get_device_name(device)}; nvidia-smi name, power.limit: {out.stdout.splitlines()[0]}"


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_ms(fn, device) -> float:
    """ms of ``fn()`` by CUDA events on the GPU (the host's clock on the CPU)."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def bench_config(cfg_file, batch_size, iters, device, set_cfgs=None, workers=8, tracklets=16, frames=24,
                 k: int = 4) -> dict:
    from ..config import cli_config
    from ..data.loader import build_dataloader
    from ..nn import build_network
    from ..train.optim import Optimizer
    from ..train.train_step import BatchUploader, make_multi_step, make_train_step, stack_batches, to_device
    from ..train.trainer import pipelined_steps
    from ..utils.cuda_graph import CaptureContext
    from ..utils.profiling import train_step_flops

    cfg = cli_config(cfg_file, set_cfgs)
    ds_cfg = dict(cfg["DATA_CONFIG"], DATASET="SyntheticTrackingDataset", NUM_TRACKLETS=tracklets,
                  FRAMES_PER_TRACKLET=frames)
    _, loader = build_dataloader(ds_cfg, cfg["CLASS_NAMES"], batch_size, workers=workers, training=True)
    mixed = bool(cfg["OPTIMIZATION"].get("MIXED_PRECISION", False))
    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device=device, train=True)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader), 60)
    context = CaptureContext(device)  # the Trainer's: one pool and stream for both steps' graphs
    step = make_train_step(cfg["MODEL"], device=device, mixed_precision=mixed, context=context)
    multi = make_multi_step(cfg["MODEL"], k, device=device, mixed_precision=mixed, context=context)
    try:
        batch = to_device(next(iter(loader)), device)
        flops = train_step_flops(cfg["MODEL"], model, batch, mixed)

        t0 = time.perf_counter()
        step(model, opt, batch)  # builds the kernels on the first call
        _sync(device)
        first_s = time.perf_counter() - t0
        for _ in range(3):
            step(model, opt, batch)

        # 1. device step: steps on one device batch chained without a sync
        step_ms = device_ms(lambda: [step(model, opt, batch) for _ in range(iters)], device) / iters

        # 2. an epoch of the loader: pipelined (the Trainer's loop), blocking, then K steps a dispatch
        def epoch(number, blocking=False, multi_step=None):
            loader.set_epoch(number)
            _sync(device)
            t0 = time.perf_counter()
            if blocking:
                n = 0
                for b in loader:
                    float(step(model, opt, b)["loss"])
                    n += 1
            else:
                n = len(pipelined_steps(step, model, opt, loader, BatchUploader(device), multi_step=multi_step))
            _sync(device)
            return (time.perf_counter() - t0) * 1e3 / n

        pipelined_ms = epoch(1)
        blocking_ms = epoch(2, blocking=True)
        pool_mb = [pool_megabytes(step.steps)]
        multi(model, opt, stack_batches([batch] * k))  # the K-step graph's capture, beside the one-step graph
        k_dispatch_ms = epoch(3, multi_step=multi)
        pool_mb.append(pool_megabytes(multi))
    finally:
        loader.close()
        step.steps.close()
        multi.close()
    precision = "bf16" if mixed else "float32"
    return {"cfg": cfg["TAG"], "device": device.type, "batch": batch_size, "precision": precision,
            "first_step_s": first_s, "pool_mb": pool_mb,
            "device_ms": step_ms, "pipelined_ms": pipelined_ms, "k": k, "k_dispatch_ms": k_dispatch_ms,
            "blocking_ms": blocking_ms,
            "samples_s": batch_size / (pipelined_ms / 1e3), "gflops_per_step": flops / 1e9,
            "mfu_pct": 100 * flops / (step_ms / 1e3) / PEAK_FLOPS[precision] if device.type == "cuda" else None}


def pool_megabytes(steps):
    """MB reserved by the pool of a TrainStep's captured graphs, which its
    context shares (None on the CPU)."""
    graphs = [entry.graph for entry in steps.graphs.values() if entry.graph is not None]
    return graphs[0].pool_bytes() / 2**20 if graphs else None


def format_rows(rows) -> str:
    lines = ["| Config | Batch | Precision | Step GFLOP | Device step | E2E ms/it (pipelined) "
             f"| E2E ms/it (K-dispatch, K={rows[0]['k']}) | E2E ms/it (blocking) | Samples/s "
             "| MFU (vs the precision's peak) |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        on_card = r["device"] == "cuda"
        mfu = f"{r['mfu_pct']:.1f}% of {PEAK_FLOPS[r['precision']] / 1e12:g} TFLOP/s" if on_card else "n/a (cpu)"
        step = f"{r['device_ms']:.1f} ms" if on_card else f"n/a (cpu; host {r['device_ms']:.1f} ms)"
        lines.append(f"| {r['cfg']} | {r['batch']} | {r['precision']} | {r['gflops_per_step']:.1f} "
                     f"| {step} | {r['pipelined_ms']:.1f} | {r['k_dispatch_ms']:.1f} | {r['blocking_ms']:.1f} "
                     f"| {r['samples_s']:.0f} | {mfu} |")
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="training-side performance of the port on one GPU")
    parser.add_argument("--iters", type=int, default=32)
    parser.add_argument("--batch_size", type=int, default=48)
    parser.add_argument("--workers", type=int, default=8, help="the loader's worker processes")
    parser.add_argument("--tracklets", type=int, default=16, help="synthetic tracklets (x --frames x 4 items)")
    parser.add_argument("--frames", type=int, default=24)
    parser.add_argument("--steps_per_dispatch", type=int, default=4, help="K of the K-dispatch column")
    parser.add_argument("--configs", nargs="*", default=["tools/cfgs/kitti_models/ptt.yaml",
                                                         "tools/cfgs/kitti_models/ptt_large.yaml"])
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="config keys to override in every configuration")
    args = parser.parse_args(argv)

    from .. import resolve_device

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    rows = [bench_config(c, args.batch_size, args.iters, device, args.set_cfgs, args.workers, args.tracklets,
                         args.frames, args.steps_per_dispatch) for c in args.configs]
    for r in rows:
        pools = "" if r["pool_mb"][0] is None else \
            f"; the graphs' pool: {r['pool_mb'][0]:.0f} MB with the one-step graph, {r['pool_mb'][1]:.0f} MB " \
            f"with the {r['k']}-step graph beside it"
        print(f"{r['cfg']}: first step {r['first_step_s']:.1f} s (kernels built on the first call, then the "
              f"capture){pools}", flush=True)
    print(format_rows(rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
