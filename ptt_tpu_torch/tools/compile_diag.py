"""The cold start of the benchmark tracker, phase by phase (the JAX package's
``tools/compile_diag.py``, whose phases are trace and lower, compile, and
the first execution)::

    python3 -m ptt_tpu_torch.tools.compile_diag [--no-kernels] [--build-dir D] [--device cuda]

On the benchmark workload (``bench_setup.build_bench_setup``: ``ptt.yaml``,
8 x 64 frames, ``max_points`` 2048, one batch of 8):

- build: the kernels' ``nvcc`` builds (``ops/_build.py``; none when their
  libraries are in the build directory);
- model to device: the tracker built and its weights placed on the device;
- first eager step: the batch's first frame step, run eagerly as the graphed
  tracker runs it (it loads the libraries and meets every kernel's first
  launch);
- capture: the frame step captured as a CUDA graph;
- first replay: the graph's first replay.

``--no-kernels`` runs the plain PyTorch path (``nn.set_use_kernels``; no
build), as the JAX tool's ``--no-fused``. ``--build-dir D`` builds into and
loads from D (``_build.set_build_dir``), as the JAX tool's ``--cache-dir``: an
empty directory gives a cold build, the default ``build/`` a warm one.
``--device cpu`` runs the eager step alone (no nvcc, no graph). Prints one
summary line; ``--set`` and the size flags narrow the workload.
"""

from __future__ import annotations

import argparse
import time

import torch


def diagnose(device, kernels: bool = True, build_dir=None, set_cfgs=None, tracklets: int = 8, frames: int = 64,
             max_points: int = 2048) -> dict:
    """Seconds of each phase (None where the phase does not run)."""
    from ..eval.device_loop import DeviceTrackingEvaluator
    from ..nn import set_use_kernels
    from ..ops import _build
    from ..utils import cuda_graph
    from .bench_setup import build_bench_setup
    from .train_bench import _sync

    times = {"build": None, "capture": None, "first_replay": None}
    if build_dir is not None:
        _build.set_build_dir(build_dir)
    if kernels and device.type == "cuda":
        t0 = time.perf_counter()
        _build.build()
        times["build"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cfg, model, trks, max_points = build_bench_setup(tracklets, frames, max_points, device=device,
                                                     set_cfgs=set_cfgs)
    _sync(device)
    times["model_to_device"] = time.perf_counter() - t0
    set_use_kernels(model, kernels)

    ev = DeviceTrackingEvaluator(cfg, model, max_points=max_points, batch_size=len(trks), device=device)
    batch = ev._pack(trks)
    B, T, N = batch["pcs"].shape[:3]
    s = ev.loop.allocate(B, T, N, batch["pcs"].dtype, batch["gt_boxes"] is not None, device)
    ev.generator.manual_seed(ev.seed)
    ev.loop.load(s, batch["pcs"], batch["counts"], batch["init_boxes"], batch["wlhs"],
                 *ev.loop.draw(ev.generator, B, T, device), batch["gt_boxes"])
    ev.loop.start(s)
    _sync(device)
    t0 = time.perf_counter()
    if device.type == "cuda":
        graph = cuda_graph.StepGraph(lambda: ev.loop.step(s), device)  # the eager step, then the capture
        times["first_eager_step"] = time.perf_counter() - t0 - graph.capture_s
        times["capture"] = graph.capture_s
        t0 = time.perf_counter()
        graph.replay()
        _sync(device)
        times["first_replay"] = time.perf_counter() - t0
        graph.release()
    else:
        ev.loop.step(s)
        times["first_eager_step"] = time.perf_counter() - t0
    return times


def summary_line(times: dict, kernels: bool, build_dir) -> str:
    def sec(key, digits=1):
        return "-" if times[key] is None else f"{times[key]:.{digits}f}s"

    replay = "-" if times["first_replay"] is None else f"{times['first_replay'] * 1e3:.1f} ms"
    return (f"kernels={'on' if kernels else 'off'} build_dir={build_dir or 'build/ptt_tpu_torch'}: "
            f"nvcc build {sec('build')}, model to device {sec('model_to_device')}, "
            f"first eager step {sec('first_eager_step', 2)}, capture {sec('capture', 2)}, first replay {replay}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="the benchmark tracker's cold start, phase by phase")
    parser.add_argument("--no-kernels", action="store_true", help="the plain PyTorch path (no nvcc build)")
    parser.add_argument("--build-dir", type=str, default=None,
                        help="build into and load from this directory (empty: a cold build)")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--tracklets", type=int, default=8)
    parser.add_argument("--frames", type=int, default=64)
    parser.add_argument("--max_points", type=int, default=2048)
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    from .. import resolve_device

    device = resolve_device(args.device)
    times = diagnose(device, not args.no_kernels, args.build_dir, args.set_cfgs, args.tracklets, args.frames,
                     args.max_points)
    print(summary_line(times, not args.no_kernels, args.build_dir), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
