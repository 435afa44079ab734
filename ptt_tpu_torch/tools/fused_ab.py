"""The CUDA kernels against their plain PyTorch versions, at the level of the
metrics (the JAX package's ``tools/fused_ab.py``, whose switch is
``pallas_sa.DISABLE_FUSED``; here ``nn.set_use_kernels``)::

    python3 -m ptt_tpu_torch.tools.fused_ab

On the GPU, with the trained asset on ``ptt.yaml`` and the 8 x 24 agreement
tracklets (seed 11):

1. the device tracker (``DeviceTrackingEvaluator``, ``max_points`` 1024, batch
   8) with the kernels and without them, the same weights, tracklets and
   seed: Success and Precision of each, and the differences;
2. one forward of a batch of real crops (each tracklet's frame-1 search
   region around its frame-0 box, the reference evaluator's crop with the
   0.6-length slack, and its frame-0 template), with the kernels and without
   them: the largest absolute difference of ``pred_box_data``, the mean
   relative difference, how many of the 8 argmax proposals flip, and the
   largest difference of the selected boxes.

Prints the card's name and power limit, then a markdown table. The kernels
exist on the GPU alone: without one it exits non-zero and runs nothing.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def crop_batch(cfg, tracklets, device) -> dict:
    """Search and template crops of each tracklet's first two frames, stacked."""
    from ..core import geometry as geo

    data_cfg = cfg["DATA_CONFIG"]
    searches, templates = [], []
    for pcs, boxes, _ in tracklets:
        s, _, _ = geo.crop_center_pc(np.asarray(pcs[1], np.float64), boxes[0], gt_box=boxes[1],
                                     offset=float(data_cfg.get("SEARCH_BB_OFFSET", 0.0)),
                                     scale=float(data_cfg.get("SEARCH_BB_SCALE", 1.25)))
        searches.append(geo.regularize_pc(s, int(data_cfg["SEARCH_INPUT_SIZE"]), istrain=False))
        t = geo.get_model([pcs[0]], [boxes[0]], offset=float(data_cfg.get("MODEL_BB_OFFSET", 0.0)),
                          scale=float(data_cfg.get("MODEL_BB_SCALE", 1.25)))
        templates.append(geo.regularize_pc(t, int(data_cfg["TEMPLATE_INPUT_SIZE"]), istrain=False))
    return {"search_points": torch.tensor(np.stack(searches), dtype=torch.float32, device=device),
            "template_points": torch.tensor(np.stack(templates), dtype=torch.float32, device=device)}


def forward_ab(kernel_out: np.ndarray, plain_out: np.ndarray) -> dict:
    """The divergence of two (B, P, 5) ``pred_box_data`` arrays."""
    rows = np.arange(kernel_out.shape[0])
    arg_k, arg_p = kernel_out[:, :, 4].argmax(1), plain_out[:, :, 4].argmax(1)
    return {"max_abs": float(np.abs(kernel_out - plain_out).max()),
            "mean_rel": float(np.abs(kernel_out - plain_out).mean() / (np.abs(plain_out).mean() + 1e-9)),
            "flips": int((arg_k != arg_p).sum()),
            "box_delta": float(np.abs(kernel_out[rows, arg_k, :4] - plain_out[rows, arg_p, :4]).max())}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="metric-level A/B of the CUDA kernels against the plain path")
    parser.add_argument("--device", type=str, default="cuda", help="a CUDA device; the kernels run on no other")
    args = parser.parse_args(argv)
    if torch.device(args.device).type != "cuda" or not torch.cuda.is_available():
        print("fused_ab compares the CUDA kernels with their plain versions and needs a GPU; none is available",
              file=sys.stderr)
        return 1

    from .. import resolve_device
    from ..eval.device_loop import DeviceTrackingEvaluator
    from ..nn import set_use_kernels
    from .bench_setup import agreement_setup
    from .train_bench import card_line

    device = resolve_device(args.device)
    print(card_line(device), flush=True)
    cfg, model, tracklets, _ = agreement_setup(device)

    results = {}
    for kernels in (True, False):
        set_use_kernels(model, kernels)
        ev = DeviceTrackingEvaluator(cfg, model, max_points=1024, batch_size=8, device=device)
        ev.track_batch(tracklets)
        results[kernels] = ev.summary()
        ev.close()
        print(f"kernels={kernels}: Succ/Prec {results[kernels]['success']:.2f}/{results[kernels]['precision']:.2f}",
              file=sys.stderr)

    batch = crop_batch(cfg, tracklets, device)
    outs = {}
    with torch.no_grad():
        for kernels in (True, False):
            set_use_kernels(model, kernels)
            outs[kernels] = model(dict(batch))["pred_box_data"].cpu().numpy()
    set_use_kernels(model, True)
    ab = forward_ab(outs[True], outs[False])
    a, b = results[True], results[False]
    n = len(tracklets)
    print(f"\n| Measurement | kernels | plain | delta |\n|---|---|---|---|\n"
          f"| eval Success ({a['frames']} frames) | {a['success']:.2f} | {b['success']:.2f} "
          f"| {abs(a['success'] - b['success']):.2f} |\n"
          f"| eval Precision | {a['precision']:.2f} | {b['precision']:.2f} "
          f"| {abs(a['precision'] - b['precision']):.2f} |\n"
          f"| forward pred_box_data max abs diff | | | {ab['max_abs']:.4g} |\n"
          f"| forward mean rel diff | | | {ab['mean_rel']:.4g} |\n"
          f"| argmax-proposal flips (of {n}) | | | {ab['flips']} |\n"
          f"| selected-box max abs diff | | | {ab['box_delta']:.4g} |", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
