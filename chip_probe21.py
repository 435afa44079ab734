"""The segmentation fault of ``chip_smoke.py`` phase 21c (PERF.md §7 q. 7),
and the tracker's two host scorers, on a GPU machine::

    python3 chip_probe21.py native|numpy|noprof|scorer_ab

``native``, ``numpy`` and ``noprof`` run ``chip_smoke.py``'s ``main`` up to
phase 21c with phase 21 back in the main process (where it once ran), one
variant a process, and exit after 21c's four traced loops of the Trainer:

- ``native``: as ``chip_smoke.py`` runs, the C++ scorer of ``native/``;
- ``numpy``: every ``DeviceTrackingEvaluator`` scores with numpy, so the
  native library is never loaded (each line says whether it was);
- ``noprof``: the native scorer, 21c's four loops not under torch.profiler.

A crash prints faulthandler's stack and exits non-zero; a pass prints
``PROBE <variant>: 21c's four traced loops passed``.

``scorer_ab``: frames/s of ``ptt.yaml``'s benchmark workload (8 x 64 frames,
``max_points`` 2048, trained asset) on one evaluator, the C++ and the numpy
scorer alternated (native, numpy, numpy, native, 3 times) at a window of 2,
then 4, pipelined batches.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch

import chip_smoke as cs
from ptt_tpu_torch.eval import device_loop
from ptt_tpu_torch.ops import _build


def scorer_ab() -> int:
    from ptt_tpu_torch.tools.bench_setup import agreement_setup

    _build.build()
    cfg, model, _, _ = agreement_setup("cuda")
    bench = cs.bench_tracklets()
    ev = device_loop.DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=torch.device("cuda"))
    for native in (True, False):  # warm-up
        ev._native_score = native
        cs.bench_rate(ev, bench, 1)
    res = {}
    for window in (2, 4):
        for _ in range(3):
            for native in (True, False, False, True):
                ev._native_score = native
                res.setdefault(f"window {window} {'native' if native else 'numpy'}", []).append(
                    cs.bench_rate(ev, bench, window))
    for k, v in res.items():
        print(k, " ".join(f"{x:.1f}" for x in v), "median", f"{sorted(v)[len(v) // 2]:.1f}")
    print("card", cs.gpu_line())
    ev.close()
    return 0


def phase21_inline(variant: str) -> int:
    if variant == "numpy":
        init = device_loop.DeviceTrackingEvaluator.__init__

        def numpy_init(self, *a, **k):
            init(self, *a, **k)
            self._native_score = False

        device_loop.DeviceTrackingEvaluator.__init__ = numpy_init
    traced_run, n_traced = cs.traced_run, [0]

    def traced(fn, prelude):
        if variant == "noprof":
            torch.cuda.synchronize()
            prelude()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out = {"wall_ms": (time.perf_counter() - t0) * 1e3, "host_ms": None, "busy_ms": None,
                   "idle_share": None, "launches": None}
        else:
            out = traced_run(fn, prelude)
        n_traced[0] += 1
        print(f"PROBE traced loop {n_traced[0]} done: {json.dumps(out)}", flush=True)
        if n_traced[0] == 4:
            print(f"PROBE {variant}: 21c's four traced loops passed in the main process; native loaded: "
                  f"{'native' in _build._loaded}", flush=True)
            cs.stop_children()
            os._exit(0)
        return out

    def phase21_here():
        print(f"PROBE {variant}: phase 21 in the main process; native loaded: {'native' in _build._loaded}",
              flush=True)
        return cs.train_graph_phase(torch.device("cuda"), cs.gpu_line())

    cs.traced_run = traced
    cs.phase21_process = phase21_here
    return cs.main()


if __name__ == "__main__":  # the loaders' fork server imports this file again
    arg = sys.argv[1]
    sys.exit(scorer_ab() if arg == "scorer_ab" else phase21_inline(arg))
