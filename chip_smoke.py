"""Drive the PyTorch port (``ptt_tpu_torch``) on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:
  1. device and build: the card's name and power limit, then the CUDA kernels of
     ``ptt_tpu_torch/csrc`` compiled from source (one nvcc per file, in parallel);
  2. every kernel against its plain PyTorch version on the card, at each shape the
     tracker's forward gives it (B = 8), with time, bound and error per call;
  3. the whole forward at full ``ptt.yaml`` width on the trained weights of
     ``tests/assets/ptt_synth_trained.npz``, kernel path against plain path;
  4. the device tracker (``DeviceTrackingEvaluator``) on 8 x 24 synthetic
     tracklets with the trained weights: Success/Precision, launch counts, then
     frames/s over pipelined batches of the benchmark workload (8 x 64 frames).
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a GPU it exits 1 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(REPO, "tests", "assets", "ptt_synth_trained.npz")

# published H100 SXM peaks (dense): float32 on CUDA cores, device memory
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
SA_RTOL = SA_ATOL = 1e-4  # kernel vs plain: float32 sums in another order


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, with CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------- bounds (least time)


def fps_bound(xyz, npoint):
    B, N, _ = xyz.shape
    nbytes = 4 * (B * N * 3 + B * npoint)
    ops = 10 * B * N * npoint  # per point and round: 3 sub, 3 mul, 2 add, min, compare
    return nbytes, ops


def sa_bound(xyz, new_xyz, features, radius, nsample, weights, biases, point_ops):
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    cf = 0 if features is None else features.shape[-1]
    widths = [w.shape[1] for w in weights]
    nbytes = 4 * (B * N * (3 + cf) + B * M * 3 + sum(w.numel() for w in weights)
                  + sum(b.numel() for b in biases) + B * M * widths[-1])
    # the ball query scans each center's points up to its nsample-th hit
    d2 = point_ops.square_distance(new_xyz, xyz)
    hits = (d2 < point_ops.radius_sq(radius)).cumsum(-1)
    reached = hits >= nsample
    scanned = torch.where(reached.any(-1), reached.float().argmax(-1) + 1, torch.full_like(hits[..., 0], N))
    ops = 14 * int(scanned.sum())
    h1 = widths[0]
    ops += 2 * B * N * (3 + cf) * h1 + 2 * B * M * 3 * h1  # layer 0 over points, center offsets
    ops += 2 * B * M * nsample * h1  # gather + offset + relu
    for k, c in zip(widths[:-1], widths[1:]):
        ops += 2 * B * M * nsample * k * c + 2 * B * M * nsample * c
    ops += B * M * nsample * widths[-1]  # max over the neighbourhood
    return nbytes, ops


def bound_ms(nbytes, ops):
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------------- the phases


def first_step_batch(tracklets, cfg, device):
    """The search and template clouds of the tracker's first step for each
    tracklet (crop around the frame-0 box, resample), as the main path makes them."""
    from ptt_tpu_torch.eval import device_loop as dl

    data = cfg["DATA_CONFIG"]
    gen = torch.Generator(device=device).manual_seed(0)
    searches, templates = [], []
    for pcs, boxes, _ in tracklets:
        box = torch.tensor(dl.DeviceTrackingEvaluator.box_to_vec(boxes[0]), device=device)[None]
        wlh = torch.tensor(boxes[0].wlh, dtype=torch.float32, device=device)[None]
        p0 = torch.tensor(pcs[0], device=device)[None]
        p1 = torch.tensor(pcs[1], device=device)[None]
        ones0 = torch.ones(p0.shape[:2], dtype=torch.bool, device=device)
        ones1 = torch.ones(p1.shape[:2], dtype=torch.bool, device=device)
        tc, tm = dl.crop_canonical(p0, ones0, box, wlh, data["MODEL_BB_OFFSET"], data["MODEL_BB_SCALE"])
        sc, sm = dl.crop_canonical(p1, ones1, box, wlh, data["SEARCH_BB_OFFSET"] + 0.6 * wlh[:, 1],
                                   data["SEARCH_BB_SCALE"])
        sm &= dl.precrop_mask(p1, box, wlh, data["SEARCH_BB_OFFSET"], data["SEARCH_BB_SCALE"])
        searches.append(dl.masked_resample(sc, sm, data["SEARCH_INPUT_SIZE"], gen)[0])
        templates.append(dl.masked_resample(tc, tm, data["TEMPLATE_INPUT_SIZE"], gen)[0])
    return {"search_points": torch.cat(searches), "template_points": torch.cat(templates)}


def capture_kernel_calls(model, batch):
    """Run the forward once on the kernel path and record every FPS and SA call."""
    from ptt_tpu_torch.ops import fps, sa

    calls = {"fps": [], "sa": []}
    orig_fps, orig_sa = fps.furthest_point_sample, sa.fused_sa_inference

    def rec_fps(xyz, npoint):
        calls["fps"].append(((xyz.clone(), npoint), {}))
        return orig_fps(xyz, npoint)

    def rec_sa(*args, **kwargs):
        calls["sa"].append((args, kwargs))
        return orig_sa(*args, **kwargs)

    fps.furthest_point_sample, sa.fused_sa_inference = rec_fps, rec_sa
    try:
        with torch.no_grad():
            model(batch)
    finally:
        fps.furthest_point_sample, sa.fused_sa_inference = orig_fps, orig_sa
    return calls


def check_kernels(calls):
    from ptt_tpu_torch.ops import fps, point_ops, sa

    rows = {"fps": [], "sa": []}
    for (xyz, npoint), _ in calls["fps"]:
        got = fps.furthest_point_sample(xyz, npoint)
        ref = point_ops.furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"FPS kernel differs from its plain version at {tuple(xyz.shape)} -> {npoint}: "
                 f"{int((got != ref).sum())} indices")
        ms = cuda_ms(lambda: fps.furthest_point_sample(xyz, npoint), 20)
        plain_ms = cuda_ms(lambda: point_ops.furthest_point_sample(xyz, npoint), 3, warmup=1)
        b, kind = bound_ms(*fps_bound(xyz, npoint))
        rows["fps"].append(dict(shape=f"{tuple(xyz.shape)}->{npoint}", err=0.0, ms=ms, plain_ms=plain_ms,
                                bound_ms=b, bound_by=kind, mismatch=0))
    for args, kwargs in calls["sa"]:
        xyz, new_xyz, features, radius, nsample, weights, biases = args
        B, M = new_xyz.shape[:2]
        idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
        got = sa.fused_sa_inference(*args, **kwargs, idx_out=idx)
        ref = sa.fused_sa_plain(*args, **kwargs)
        ref_idx = point_ops.ball_query(radius, nsample, xyz, new_xyz)
        torch.cuda.synchronize()
        mismatch = int((idx != ref_idx).sum())
        err = float((got - ref).abs().max())
        shape = f"{tuple(xyz.shape)}->{M} ns{nsample} r{radius} C{[w.shape[0] for w in weights] + [weights[-1].shape[1]]}"
        log(f"  sa {shape}: max |kernel - plain| {err:.3e}, ball-query membership disagreements {mismatch}")
        if mismatch:
            fail(f"SA kernel's ball query differs from point_ops.ball_query at {shape}")
        if not torch.allclose(got, ref, rtol=SA_RTOL, atol=SA_ATOL):
            fail(f"SA kernel differs from its plain version at {shape} beyond rtol/atol {SA_RTOL}")
        ms = cuda_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 20)
        plain_ms = cuda_ms(lambda: sa.fused_sa_plain(*args, **kwargs), 10)
        b, kind = bound_ms(*sa_bound(xyz, new_xyz, features, radius, nsample, weights, biases, point_ops))
        rows["sa"].append(dict(shape=shape, err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=kind,
                               mismatch=mismatch))
    for name, rs in rows.items():
        for r in rs:
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
    return rows


def profile_batch(ev, tracklets, n_frames):
    """One batch of the tracker under torch.profiler: host time to enqueue it,
    wall time, the device's busy and idle shares, and the kernels by device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        handle = ev.dispatch_batch(tracklets)
        t_enqueue = time.perf_counter() - t0
        ev.finish_batch(handle)
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    steps = len(tracklets[0][0]) - 1
    log(f"[5] profile of one batch ({n_frames} frames, {steps} frame steps): wall {wall * 1e3:.1f} ms, "
        f"host enqueue {t_enqueue * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}% busy, {100 - 100 * busy_us / 1e6 / wall:.1f}% idle), "
        f"{sum(e.count for e in kernels)} device operations")
    if busy_us == 0:
        log("  the profiler saw no device time: busy share not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.convert import npz_metadata, state_dict_from_npz
    from ptt_tpu_torch.data.synthetic import make_tracklets
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network, set_use_kernels
    from ptt_tpu_torch.ops import _build, fps, sa

    t_start = time.perf_counter()
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = gpu_line()
    log(f"device: {kind}; nvidia-smi name, power.limit: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")

    # 1. build
    t0 = time.perf_counter()
    _build.build()
    log(f"[1] kernels built in {time.perf_counter() - t0:.1f} s")
    for name, (sec, out) in _build.build_log.items():
        info = [ln.strip() for ln in out.splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu ({sec:.1f} s): " + " | ".join(info))

    cfg = ptt_config()
    model = build_network(cfg["MODEL"], device=device)
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    meta = npz_metadata(ASSET)
    agreement = make_tracklets({"NUM_TRACKLETS": 8, "FRAMES_PER_TRACKLET": 24, "SYNTH_SEED": 11})

    # 2. kernels against plain versions at the forward's shapes
    batch = first_step_batch(agreement, cfg, device)
    calls = capture_kernel_calls(model, batch)
    if len(calls["fps"]) != 2 or len(calls["sa"]) != 7:
        fail(f"the forward made {len(calls['fps'])} FPS and {len(calls['sa'])} SA calls, not 2 and 7")
    log(f"[2] kernels vs plain versions at the forward's shapes (B = 8), SA rtol = atol = {SA_RTOL}")
    rows = check_kernels(calls)
    summary = {name: dict(launches_per_frame=len(rs), max_abs_err=max(r["err"] for r in rs),
                          ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs))
               for name, rs in rows.items()}
    log("kernels " + json.dumps(summary))

    # 3. whole forward, kernel path against plain path
    with torch.no_grad():
        out_k = model(batch)
        set_use_kernels(model, False)
        out_p = model(batch)
        set_use_kernels(model, True)
    for key in ("search_inds", "template_inds"):
        if not torch.equal(out_k[key], out_p[key]):
            fail(f"forward: {key} differ between kernel and plain paths")
    box_err = float((out_k["pred_box_data"] - out_p["pred_box_data"]).abs().max())
    same_best = torch.equal(out_k["pred_box_data"][..., 4].argmax(1), out_p["pred_box_data"][..., 4].argmax(1))
    log(f"[3] forward B=8: max |pred_box_data kernel - plain| {box_err:.3e}, same best proposal {same_best}")
    if not (box_err <= 2e-3 and same_best and torch.isfinite(out_k["pred_box_data"]).all()):
        fail("forward: kernel path does not match the plain path")

    # 4. the tracker on the trained weights
    ev = DeviceTrackingEvaluator(cfg, model, max_points=1024, batch_size=8, device=device)
    fps.launches = sa.launches = 0
    t0 = time.perf_counter()
    results = ev.track_batch(agreement)
    torch.cuda.synchronize()
    launches = {"fps": fps.launches, "sa": sa.launches}
    s = ev.summary()
    steps = 32 - 1  # 24 frames pad to the 32-frame bucket; frame 0 is the given box
    log(f"[4] tracker: {s['frames']} frames in {time.perf_counter() - t0:.2f} s (first batch); "
        f"Success {s['success']:.2f} Precision {s['precision']:.2f}; recorded host "
        f"{meta['host_success']:.2f}/{meta['host_precision']:.2f} "
        f"(delta {s['success'] - meta['host_success']:+.2f}/{s['precision'] - meta['host_precision']:+.2f}); "
        f"launches {launches} over {steps} frame steps")
    centers = np.array([[b.center for b in trk] for trk in results])
    if s["frames"] != 192 or not np.isfinite(centers).all():
        fail("tracker: wrong frame count or non-finite boxes")
    if s["success"] < 50.0:
        fail(f"tracker: Success {s['success']:.2f} < 50")
    if launches != {"fps": 2 * steps, "sa": 7 * steps}:
        fail(f"tracker: launches {launches}, expected 2 and 7 per frame step over {steps} steps")

    bench = make_tracklets({"NUM_TRACKLETS": 8, "FRAMES_PER_TRACKLET": 64,
                            "POINTS_PER_FRAME": 600, "CLUTTER_POINTS": 400})
    ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device)
    n_frames = sum(len(t[0]) for t in bench)

    def run(n_batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        in_flight = None
        for _ in range(n_batches):
            handle = ev.dispatch_batch(bench)
            if in_flight is not None:
                ev.finish_batch(in_flight)
            in_flight = handle
        ev.finish_batch(in_flight)
        return n_batches * n_frames / (time.perf_counter() - t0)

    run(1)  # warm-up
    rates = [run(4) for _ in range(3)]
    set_use_kernels(model, False)
    plain_rate = run(1)
    set_use_kernels(model, True)
    log(f"[4] throughput, 8 x 64-frame tracklets, 4 pipelined batches per run: "
        f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f}); "
        f"plain path {plain_rate:.1f} frames/s; card {card}")
    profile_batch(ev, bench, n_frames)

    record = {"kernels": []}
    for name, src, replaces in (("fps", "ptt_tpu_torch/csrc/fps.cu", "ptt_tpu/ops/pallas_fps.py:37"),
                                ("sa", "ptt_tpu_torch/csrc/sa.cu", "ptt_tpu/ops/pallas_sa.py:82")):
        rs = rows[name]
        bms = sum(r["bound_ms"] for r in rs)
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": summary[name]["max_abs_err"],
            "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"], "bound_ms": bms,
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"], "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
