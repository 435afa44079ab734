"""The tracker's two host scorers on a GPU machine::

    python3 chip_probe21.py scorer_ab

``scorer_ab``: frames/s of ``ptt.yaml``'s benchmark workload (8 x 64 frames,
``max_points`` 2048, trained asset) on one evaluator, the C++ and the numpy
scorer alternated (native, numpy, numpy, native, 3 times) at a window of 2,
then 4, pipelined batches.
"""

import os
import sys

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


if __name__ == "__main__":
    if sys.argv[1:] != ["scorer_ab"]:
        sys.exit("usage: python3 chip_probe21.py scorer_ab")
    sys.exit(scorer_ab())
