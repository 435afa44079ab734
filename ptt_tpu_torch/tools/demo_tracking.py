"""Demo and smoke CLI (the JAX package's ``tools/demo_tracking.py``): build the
loader and the network, print the parameter counts, the forward's FLOPs per
module and per layer (``utils/profiling.py``), then run one train step (the
kernels built on the first call) and one steady step, with their times.

    python3 -m ptt_tpu_torch.tools.demo_tracking [--cfg_file tools/cfgs/kitti_models/ptt.yaml]
        [--batch_size 8] [--real_data] [--device cuda] [--set KEY VALUE ...]

The synthetic dataset by default, so it needs no data; ``--real_data`` reads
the dataset of the configuration. It runs on the GPU unless ``--device cpu``
is given (the tests), where the times are the host's.
"""

from __future__ import annotations

import argparse
import time

import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="parameter counts, FLOPs and one train step of the tracker")
    parser.add_argument("--cfg_file", type=str, default="tools/cfgs/kitti_models/ptt.yaml")
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--real_data", action="store_true", help="the configuration's dataset instead of synthetic")
    parser.add_argument("--workers", type=int, default=2, help="the loader's worker processes")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from .. import resolve_device
    from ..config import cli_config
    from ..data.loader import build_dataloader
    from ..nn import build_network
    from ..train.optim import Optimizer
    from ..train.train_step import make_train_step, to_device
    from ..utils.profiling import (count_parameters, format_cost_table, format_layer_table, per_layer_flops,
                                   per_module_flops)
    from .train_bench import card_line

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    cfg = cli_config(args.cfg_file, args.set_cfgs)
    ds_cfg = dict(cfg["DATA_CONFIG"])
    if not args.real_data:
        ds_cfg.update(DATASET="SyntheticTrackingDataset", NUM_TRACKLETS=2, FRAMES_PER_TRACKLET=8)
    dataset, loader = build_dataloader(ds_cfg, cfg["CLASS_NAMES"], args.batch_size, workers=args.workers,
                                       training=True)
    try:
        print(f"dataset: {len(dataset)} samples", flush=True)
        batch = to_device(next(iter(loader)), device)
    finally:
        loader.close()

    t0 = time.perf_counter()
    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device=device, train=True)
    print(f"init: {time.perf_counter() - t0:.1f}s", flush=True)

    counts = count_parameters(model)
    print(f"parameters: {counts['total']:,}")
    for name, n in counts["per_module"].items():
        print(f"  {name:<24} {n:>10,}")

    eval_batch = {k: batch[k] for k in ("search_points", "template_points")}
    rows = per_module_flops(model, eval_batch)
    print(f"forward (batch {args.batch_size}): {sum(c['flops'] for _, c in rows) / 1e9:.2f} GFLOP "
          "(FlopCounterMode: matrix products only, plain path)")
    print(format_cost_table(rows))
    print(format_layer_table(per_layer_flops(model, eval_batch)), flush=True)

    mixed = bool(cfg["OPTIMIZATION"].get("MIXED_PRECISION", False))
    step = make_train_step(cfg["MODEL"], device=device, mixed_precision=mixed)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader), 1)
    t0 = time.perf_counter()
    loss = float(step(model, opt, batch)["loss"])
    print(f"one train step: {time.perf_counter() - t0:.1f}s (kernels built on the first call), loss {loss:.4f}")
    t0 = time.perf_counter()
    float(step(model, opt, batch)["loss"])
    print(f"steady train step: {(time.perf_counter() - t0) * 1e3:.1f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
