"""Host evaluator against device tracker, split by cause (the JAX package's
``tools/parity_decomposition.py``)::

    python3 -m ptt_tpu_torch.tools.parity_decomposition [--device cuda]

The trained asset on ``ptt.yaml`` with the 8 x 24 agreement tracklets (seed
11) through the host evaluator (``eval/evaluator.py``, its own numpy
resample stream and the native crop) and the device tracker
(``eval/device_loop.py``, ``max_points`` 1024, batch 8), one row each, in the
JAX tool's order:

- deployed: host against device with the int16 upload;
- quantization alone: the device tracker with the float32 upload against the
  int16 one (the same draws);
- RNG stream alone: host against device with the float32 upload;
- TEST.REF_BOX previous_gt and current_gt: host against device;
- TEST.SHAPE_AGGREGATION all: host against device.

Prints the card's name and power limit, the asset's recorded host numbers,
then a markdown table of Success/Precision and their absolute differences.
``--device cpu`` runs it on the CPU; ``decompose`` is the work, which the
tests call at a small size.
"""

from __future__ import annotations

import argparse
import sys

ROW_NAMES = (
    "deployed: host vs device (int16 upload)",
    "quantization alone: device f32 vs device int16",
    "RNG stream alone: host vs device (f32 upload)",
    "REF_BOX=previous_gt: host vs device",
    "REF_BOX=current_gt: host vs device",
    "SHAPE_AGGREGATION=all: host vs device",
)


def decompose(cfg, model, tracklets, device, max_points: int = 1024, batch_size: int = 8, log=None) -> list:
    """The six rows (name, (succ, prec) of A, (succ, prec) of B, |dSucc|,
    |dPrec|) for ``model`` (on ``device``) over ``tracklets``."""
    from ..eval.device_loop import DeviceTrackingEvaluator
    from ..eval.evaluator import TrackingEvaluator

    def with_test(**overrides):
        return dict(cfg, TEST=dict(cfg["TEST"], **overrides))

    def host_eval(c):
        ev = TrackingEvaluator(c, model, device=device)
        for trk in tracklets:
            ev.test_tracklet(*trk)
        ev.close()
        s = ev.summary()
        return s["success"], s["precision"]

    def device_eval(c, quantize=True):
        ev = DeviceTrackingEvaluator(c, model, max_points=max_points, batch_size=batch_size, device=device,
                                     quantize=quantize)
        ev.track_batch(tracklets)
        ev.close()
        s = ev.summary()
        return s["success"], s["precision"]

    rows = []

    def row(a, b):
        name = ROW_NAMES[len(rows)]
        rows.append((name, a, b, abs(a[0] - b[0]), abs(a[1] - b[1])))
        if log is not None:
            log(f"  {name}: {a[0]:.2f}/{a[1]:.2f} vs {b[0]:.2f}/{b[1]:.2f}")

    base_host = host_eval(cfg)
    dev_qon = device_eval(cfg, quantize=True)
    dev_qoff = device_eval(cfg, quantize=False)
    row(base_host, dev_qon)
    row(dev_qoff, dev_qon)
    row(base_host, dev_qoff)
    for mode in ("previous_gt", "current_gt"):
        c = with_test(REF_BOX=mode)
        row(host_eval(c), device_eval(c))
    c = with_test(SHAPE_AGGREGATION="all")
    row(host_eval(c), device_eval(c))
    return rows


def format_rows(rows) -> str:
    lines = ["| Configuration | A Succ/Prec | B Succ/Prec | |ΔSucc| | |ΔPrec| |", "|---|---|---|---|---|"]
    lines += [f"| {name} | {a[0]:.2f} / {a[1]:.2f} | {b[0]:.2f} / {b[1]:.2f} | {ds:.2f} | {dp:.2f} |"
              for name, a, b, ds, dp in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="host evaluator against device tracker, split by cause")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from .. import resolve_device
    from .bench_setup import agreement_setup
    from .train_bench import card_line

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    cfg, model, tracklets, meta = agreement_setup(device)
    print(f"checkpoint: epoch {meta['epoch']}, recorded host Succ/Prec "
          f"{float(meta['host_success']):.2f}/{float(meta['host_precision']):.2f}", flush=True)
    rows = decompose(cfg, model, tracklets, device, log=lambda msg: print(msg, file=sys.stderr, flush=True))
    print("\n" + format_rows(rows), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
