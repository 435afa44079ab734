"""The benchmark of ``ptt_tpu_torch``: one cell of ``BENCHMARK.json``, one run.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: the cell's entry in ``BENCHMARK.json`` names its
configuration (``configs`` -> a file under ``benchmark/configs/``) and its
traffic (``benchmark/traffic/<traffic>.json``, whose ``kind`` names the
module ``benchmark/mixes/<kind>.py`` and whose ``limits`` are the limits of
the numbers the check compares); each per-layer metric is read by
``benchmark/metrics/<metric>.py``.

A run: set-up (imports, the kernels' build or load, the data and weights from
the seed, the program's objects, warm-up and graph capture), the measured
window of ``--seconds``, with ``--trace 1`` one profiler window in its middle;
then the device's peak memory is read, the program's state freed, and the
check against the plain reference run. The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit, which also end standard
error. Exits 2 with no result without CUDA or with fewer cards than the cell
asks for, and 3 if a module of JAX or of the JAX package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "benchmark"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ptt_tpu")


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's record of its
    start where there is one, else since this module began."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench: dict | None = None) -> SimpleNamespace:
    """The cell ``name`` of ``BENCHMARK.json`` with its configuration,
    traffic and metric entries."""
    bench = bench if bench is not None else json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r}; BENCHMARK.json has {', '.join(cells)}")
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    applies = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    layers = [m for m in bench["per_layer"] if name in m.get("workloads", [name])]
    return SimpleNamespace(cell=cell, config=json.loads((ROOT / config_entry["file"]).read_text()),
                           traffic=json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
                           end_to_end=applies, per_layer=layers)


def mark(phase: str) -> None:
    """Say on standard error how far into the process a set-up phase ended."""
    print(f"setup {phase} done at {process_age_s():.3f} s", file=sys.stderr, flush=True)


def run_cell(spec: SimpleNamespace, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """One run of a cell (``load_cell``) on ``device``; returns the result."""
    import torch

    from benchmark import trace as btrace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if trace:
        btrace.setup_env()
    cuda = torch.device(device).type == "cuda"
    mix = importlib.import_module(f"benchmark.mixes.{spec.traffic['kind']}")
    ctx = SimpleNamespace(config=spec.config, traffic=spec.traffic, seed=int(seed), device=device, mark=mark)
    mark("imports")
    state = mix.setup(ctx)
    setup_s = process_age_s()
    e2e = state.window(seconds, trace)
    failed, attempted = state.failures()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    state.release()
    numbers = state.check()
    limits = spec.traffic["limits"]
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = (set(numbers) == set(limits) and failed == 0
               and all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values()))
    values = dict(e2e, setup_s=setup_s)
    metrics = {}
    layer = state.layer_readings()
    if layer.get("flops_per_step"):
        print(f"reference FLOPs a step {layer['flops_per_step']!r}", file=sys.stderr)
    for m in (spec.per_layer if trace else spec.end_to_end):
        if trace:
            reader = load_file(HERE / "metrics" / f"{m['name']}.py", "benchmark.metrics." + m["name"].replace(".", "_"))
            value = reader.read(layer)
        else:
            value = values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(torch.device(device)) if cuda else "cpu",
           "count": int(spec.cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed), "metrics": metrics,
              "device": dev}
    traced = layer.get("traced")
    if trace and traced is not None:
        w = traced.window
        dev["busy_s"] = btrace.device_busy_us(traced.events, w.start_us, w.end_us) / 1e6
        dev["window_s"] = w.dur_us / 1e6
        dev["profiler_retakes"] = traced.retakes
        result["breakdown"] = btrace.breakdown(traced.events, w)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    spec = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec.cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {spec.cell['chips']} CUDA device(s), this machine has {found}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
