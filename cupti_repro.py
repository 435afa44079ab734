"""A trace of CUDA graph replays that dies inside ``cudaGraphLaunch``, on a
GPU, and the histories around it that do not::

    python3 cupti_repro.py                # every case of CASES, one process each
    python3 cupti_repro.py CASE           # one case in this process (settings from the environment)

A case is a sequence of steps joined by ``+``, run in order in one process;
``replay`` traces two replays of ptt_synth.yaml's train step graph (B = 48,
the trained asset) captured by ``train``:

- ``small``: a trace of one small kernel (CUPTI set up);
- ``ghost``: a graph of three matmuls captured, two replays traced, then the
  graph destroyed;
- ``tracker``: ptt.yaml's frame step graph on the benchmark batch captured, one
  batch of replays traced, then the evaluator closed (its graph destroyed);
- ``train``: the train step's graph captured (its first dispatch), in a
  ``CaptureContext`` as a Trainer's are;
- ``det`` / ``detkeep`` / ``rel``: a second train step's graph, in a pool of
  its own, captured under deterministic algorithms and replayed, then
  released (``det``) or kept (``detkeep``); ``rel`` as ``det`` without
  deterministic algorithms;
- ``sep``: a third train step's graph in a pool of its own, kept;
- ``multi4``: the K = 4 step's graph captured into ``train``'s pool;
- ``eager`` / ``eageru``: two eager train steps, traced / not;
- ``phase21``: ``chip_smoke.py``'s phase 21 whole, in place of ``replay``.

``pure`` is the history of ``small+train+det+multi4+replay`` in plain
PyTorch (an MLP's train step); ``puresmall`` traces one small kernel more
before its last trace. A case prefixed ``port:`` traces through the
port's ``utils/profiling.py`` ``device_window`` instead of
``torch.profiler`` itself, which sets ``TEARDOWN_CUPTI=0`` and refuses the
trace the history makes unsafe. Kineto's settings come from the environment
(``TEARDOWN_CUPTI``, ``DISABLE_CUPTI_LAZY_REINIT``); ``main`` runs each
case with those of its entry. A case prints ``CASE ... passed`` with the
kernels of its last trace or ``CASE ... refused``, or dies (faulthandler's
stack).
"""

import faulthandler
import os
import subprocess
import sys
import time

import torch
from torch.profiler import DeviceType, ProfilerActivity, profile

REPO = os.path.dirname(os.path.abspath(__file__))
PORT = False  # trace through the port's device_window (a ``port:`` case)
T0 = {"TEARDOWN_CUPTI": "0"}
CASES = (("small+train+det+multi4+replay", T0),
         ("train+det+multi4+replay", T0),
         ("small+train+rel+multi4+replay", T0),
         ("small+train+detkeep+multi4+replay", T0),
         ("small+train+det+multi4+replay", {}),
         ("pure", T0),
         ("port:small+train+det+multi4+replay", {}))


def traced(fn) -> int:
    """``fn()`` under torch.profiler; the device's kernel launches it saw."""
    torch.cuda.synchronize()
    if PORT:
        from ptt_tpu_torch.utils.profiling import device_window

        with device_window() as window:
            fn()
            torch.cuda.synchronize()
        return sum(e.kind == "kernel" for e in window.events)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages() if e.device_type == DeviceType.CUDA)



def pure(prime: bool) -> int:
    """The same history in plain PyTorch: an MLP's train step (forward,
    backward, a capturable Adam) captured as graph 1; a second step's graph
    captured under deterministic algorithms in a pool of its own, replayed,
    destroyed; four steps captured as graph 4 in graph 1's pool on its
    stream; then two replays of graph 1 traced (after a trace of one small
    kernel if ``prime``). CUPTI is set up by a first trace before all of it."""
    faulthandler.enable()
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(256, 1024), torch.nn.ReLU(), torch.nn.Linear(1024, 256)).cuda()
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, capturable=True)
    x, idx = torch.randn(4096, 256, device="cuda"), torch.randint(0, 4096, (4096,), device="cuda")

    def step():
        out = model(x.index_select(0, idx))
        out.gather(1, idx[:, None] % 256).square().mean().backward()
        opt.step()
        opt.zero_grad(set_to_none=False)

    small = lambda: torch.ones(8, device="cuda").add_(1)  # noqa: E731
    traced(small)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            step()
    torch.cuda.current_stream().wait_stream(stream)
    g1, pool = torch.cuda.CUDAGraph(), torch.cuda.graph_pool_handle()
    with torch.cuda.graph(g1, pool=pool, stream=stream):
        step()
    torch.use_deterministic_algorithms(True, warn_only=True)
    det = torch.cuda.CUDAGraph()
    with torch.cuda.graph(det):
        step()
    torch.use_deterministic_algorithms(False)
    det.replay()
    torch.cuda.synchronize()
    det.reset()
    g4 = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g4, pool=pool, stream=stream):
        for _ in range(4):
            step()
    g4.replay()
    torch.cuda.synchronize()
    if prime:
        traced(small)
    seen = traced(lambda: [g1.replay() for _ in range(2)])
    print(f"CASE pure{'small' if prime else ''} with TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')}: passed, "
          f"{seen} device launches in its last trace", flush=True)
    return 0


def case(name) -> int:
    global PORT
    if name.startswith("pure"):
        return pure(name == "puresmall")
    faulthandler.enable()
    sys.path.insert(0, REPO)
    if name.startswith("port:"):
        from ptt_tpu_torch.utils.profiling import TraceRefused

        PORT = True
        try:
            return steps(name[len("port:"):])
        except TraceRefused as exc:
            print(f"CASE {name}: refused: {exc}", flush=True)
            return 0
    return steps(name)


def steps(name) -> int:
    import chip_smoke as cs
    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.ops import _build
    from ptt_tpu_torch.tools.bench_setup import agreement_setup
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_multi_step, make_train_step, stack_batches
    from ptt_tpu_torch.utils.cuda_graph import CaptureContext

    _build.build()
    device = torch.device("cuda")
    cfg = ptt_synth_config()
    loader, batches = cs.train_batches(cfg["DATA_CONFIG"], 4, seed=21, workers=0)
    loader.close()
    weights = state_dict_from_npz(cs.ASSET)
    model = build_network(cfg["MODEL"], device=device, train=True)
    model.load_state_dict(weights, strict=True)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], 100)
    context = CaptureContext(device)
    step = make_train_step(cfg["MODEL"], device=device, context=context)
    seen = None
    for part in name.split("+"):
        if part == "small":
            seen = traced(lambda: torch.ones(8, device=device).add_(1))
        elif part == "ghost":
            a = torch.randn(1024, 1024, device=device)
            graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                (a @ a @ a).sum()
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(graph):
                (a @ a @ a).sum()
            seen = traced(lambda: [graph.replay() for _ in range(2)])
            graph.reset()
            del graph
        elif part == "tracker":
            tcfg, tmodel, _, _ = agreement_setup(device)
            bench = cs.bench_tracklets()
            ev = DeviceTrackingEvaluator(tcfg, tmodel, max_points=2048, batch_size=8, device=device)
            ev.finish_batch(ev.dispatch_batch(bench))
            seen = traced(lambda: ev.finish_batch(ev.dispatch_batch(bench)))
            ev.close()
            del ev, tmodel
        elif part == "train":
            step(model, opt, batches[0])
        elif part in ("det", "detkeep", "rel"):
            torch.use_deterministic_algorithms(part != "rel", warn_only=True)
            try:
                det = make_train_step(cfg["MODEL"], device=device)
                det(model, opt, batches[0])
                det(model, opt, batches[1])
            finally:
                torch.use_deterministic_algorithms(False)
            if part != "detkeep":
                det.steps.close()
        elif part == "sep":
            sep = make_train_step(cfg["MODEL"], device=device)
            sep(model, opt, batches[0])
        elif part == "multi4":
            multi4 = make_multi_step(cfg["MODEL"], 4, device=device, context=context)
            multi4(model, opt, stack_batches(batches[:4]))
        elif part in ("eager", "eageru"):
            eager = make_train_step(cfg["MODEL"], device=device, graph=False)
            if part == "eager":
                seen = traced(lambda: [eager(model, opt, b) for b in batches[:2]])
            else:
                [eager(model, opt, b) for b in batches[:2]]
        elif part == "replay":
            seen = traced(lambda: [step(model, opt, b) for b in batches[:2]])
        elif part == "phase21":
            step.steps.close()
            del model, opt, step
            cs.train_graph_phase(device, cs.gpu_line())
            cs.stop_children()
        else:
            raise ValueError(part)
        torch.cuda.synchronize()
    print(f"CASE {name} with TEARDOWN_CUPTI={os.environ.get('TEARDOWN_CUPTI')} DISABLE_CUPTI_LAZY_REINIT="
          f"{os.environ.get('DISABLE_CUPTI_LAZY_REINIT')}: passed, {seen} device launches in its last trace", flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", flush=True)
        return 1
    failed = 0
    env = {k: v for k, v in os.environ.items() if k not in ("TEARDOWN_CUPTI", "DISABLE_CUPTI_LAZY_REINIT")}
    for name, settings in CASES:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, os.path.abspath(__file__), name], cwd=REPO, env={**env, **settings},
                             capture_output=True, text=True, timeout=300)
        lines = [ln for ln in (out.stdout + out.stderr).splitlines()
                 if ln.startswith(("CASE", "Fatal", "  File")) and "site-packages" not in ln]
        print(f"{name} {settings or 'default'}: rc {out.returncode}, {time.perf_counter() - t0:.1f} s; "
              + " | ".join(lines[:7]), flush=True)
        failed += out.returncode != 0
    print(f"{failed} of {len(CASES)} cases died", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(case(sys.argv[1]) if len(sys.argv) > 1 else main())
