"""Prepare the hot programs ahead of time (the JAX package's ``tools/warmup.py``)::

    python3 -m ptt_tpu_torch.tools.warmup [--train] [--batch_size 48]

On the GPU:

1. builds every kernel library (``ops/_build.build()``, one ``nvcc`` a source)
   and the native host library (``native.build()``, g++);
2. runs the benchmark tracker once (``bench_setup.build_bench_setup``: B = 8,
   T = 64, N = 2048), its frame step captured as a CUDA graph;
3. runs the host evaluator's B = 1 forward once, captured (``TrackStep``);
4. with ``--train``, one train step at ``--batch_size`` (48), captured
   (``TrainStep``).

Each prints its seconds. What persists: the libraries, in the build directory
(``build/ptt_tpu_torch/``), which every later process loads as they are. What
does not: the CUDA graphs, which live in this process and cannot be saved.
So ``--seed-out``, which in the JAX tool copies the compiled executables into
a committed ``cache_seeds/``, is refused: the kernels are built from the
repository's sources on the machine that runs them, and a graph cannot be
written to a file. Without a GPU the tool exits non-zero and runs nothing.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

SEED_OUT_REFUSAL = ("--seed-out has no counterpart here: the CUDA kernels are built from the repository's sources "
                    "on the machine that runs them (build/ptt_tpu_torch/), and a CUDA graph lives in its process "
                    "and cannot be saved, so there is nothing to ship in a cache_seeds/ directory")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="build the kernels and run the hot programs once")
    parser.add_argument("--train", action="store_true", help="also capture the train step")
    parser.add_argument("--batch_size", type=int, default=48)
    parser.add_argument("--seed-out", type=str, default=None, help="refused: see the module's docstring")
    parser.add_argument("--device", type=str, default="cuda", help="a CUDA device; graphs exist on no other")
    args = parser.parse_args(argv)
    if args.seed_out is not None:
        print(SEED_OUT_REFUSAL, file=sys.stderr)
        return 2
    if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
        print("warmup builds the CUDA kernels and captures CUDA graphs; it needs a GPU and none is available",
              file=sys.stderr)
        return 1

    from .. import native, resolve_device
    from ..eval.device_loop import DeviceTrackingEvaluator
    from ..eval.evaluator import TrackStep
    from ..ops import _build
    from .bench_setup import build_bench_setup
    from .train_bench import _sync, card_line

    device = resolve_device(args.device)
    print(card_line(device), flush=True)

    t0 = time.perf_counter()
    _build.build()
    native.build()
    print(f"kernel and native libraries: {time.perf_counter() - t0:.1f}s "
          f"({len(_build.build_log)} nvcc builds run, in {_build.BUILD_DIR})", flush=True)

    cfg, model, tracklets, max_points = build_bench_setup(device=device)
    t0 = time.perf_counter()
    ev = DeviceTrackingEvaluator(cfg, model, max_points=max_points, batch_size=len(tracklets), device=device)
    ev.track_batch(tracklets)
    print(f"tracker, B = {len(tracklets)}, T = {len(tracklets[0][0])}, N = {max_points} (eager step, capture, "
          f"replays): {time.perf_counter() - t0:.1f}s", flush=True)
    ev.close()

    data_cfg = cfg["DATA_CONFIG"]
    t0 = time.perf_counter()
    step = TrackStep(model)
    step(torch.zeros(1, int(data_cfg["SEARCH_INPUT_SIZE"]), 3, device=device),
         torch.zeros(1, int(data_cfg["TEMPLATE_INPUT_SIZE"]), 3, device=device))
    _sync(device)
    print(f"B = 1 forward (eager, capture): {time.perf_counter() - t0:.1f}s", flush=True)
    step.graphs.clear()

    if args.train:
        from ..data.loader import build_dataloader
        from ..nn import build_network
        from ..train.optim import Optimizer
        from ..train.train_step import make_train_step, to_device

        ds_cfg = dict(data_cfg, DATASET="SyntheticTrackingDataset", NUM_TRACKLETS=4, FRAMES_PER_TRACKLET=12)
        _, loader = build_dataloader(ds_cfg, cfg["CLASS_NAMES"], args.batch_size, workers=0, training=True)
        batch = to_device(next(iter(loader)), device)
        torch.manual_seed(0)
        train_model = build_network(cfg["MODEL"], device=device, train=True)
        opt = Optimizer(train_model.parameters(), cfg["OPTIMIZATION"], len(loader), 1)
        train_step = make_train_step(cfg["MODEL"], device=device,
                                     mixed_precision=bool(cfg["OPTIMIZATION"].get("MIXED_PRECISION", False)))
        t0 = time.perf_counter()
        float(train_step(train_model, opt, batch)["loss"])
        print(f"train step, batch {args.batch_size} (eager, capture): {time.perf_counter() - t0:.1f}s", flush=True)
        train_step.steps.close()

    print(f"persists: the kernel and native libraries in {_build.BUILD_DIR}; does not persist: the CUDA graphs, "
          "which live in this process", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
