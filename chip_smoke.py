"""Drive the PyTorch port (``ptt_tpu_torch``) on one CUDA GPU and check it.

    python3 chip_smoke.py

Phases, each of which stops the run with a non-zero exit when it fails:
  1. device and build: the card's name and power limit, then the CUDA kernels of
     ``ptt_tpu_torch/csrc`` compiled from source (one nvcc per file, in parallel);
  2. every kernel against its plain PyTorch version on the card, at each shape the
     tracker's forward gives it (B = 8), with time, bound and error per call; per
     SA shape also the neighbour table, layer 0 against its plain version, the
     plain emulation of the tensor-core tail, and two hard cases (the trained
     weights scaled until activations reach ~1e3, and random weights); FPS also
     at the two shapes of a B = 48 train step and on hard clouds (identical
     points, exact ties in every round, ragged N, npoint == N, every compiled
     form), with the bound that counts its chain of rounds: the cycle counts
     below, held under what a probe kernel reads for each primitive on this card;
  3. the whole forward at full ``ptt.yaml`` width on the trained weights of
     ``tests/assets/ptt_synth_trained.npz``, kernel path against plain path;
  4. the device tracker (``DeviceTrackingEvaluator``) on 8 x 24 synthetic
     tracklets with the trained weights: Success/Precision, launch counts, then
     frames/s over pipelined batches of the benchmark workload (8 x 64 frames);
  5. a profile of one tracker batch: device busy and idle shares, top kernels;
  6. the training kernels (``csrc/group.cu``, forward and backward) against
     their plain versions at the 7 shapes of a ptt_synth train step (B = 48):
     forward bit-equal to its plain version, neighbour table, dZ and the four
     input gradients, two backward runs bit-equal and equal to the documented
     summation order; with time by events and on the device, device time per
     kernel, bound and the index_add_ yardstick;
     the same checks on a heavy-duplication cloud (resampled from 32 points), and
     the forward at ragged shapes no stage has (a short last tile, odd widths);
  7. training at full width from the trained weights, B = 48: 5 steps on the
     kernel path, each also taken by the plain path from the same state with
     the same FPS picks, both FPS calls of each step held against the plain
     FPS; the plain path's own 5 steps, reported beside two witnesses (the
     plain path again, and from weights moved by one ulp); launch counts per
     step, ms per step with and without the loader, a profile of the step, and
     ``Trainer`` for one epoch, a checkpoint and a resume;
  8. ``ptt_large.yaml`` at its full width (2048 / 1024-point clouds, two 2-layer
     4-head transformers) on the port's own seeded init: its 2 FPS and 7 SA
     calls against their plain versions (SA also on the two hard weight sets),
     the forward against the plain path, the tracker on the benchmark workload
     with 2 FPS and 7 SA launches a frame step, frames/s and a profile;
  9. the same for ``p2b_synth.yaml`` (P2B: no transformers, 'sequence' sampling
     in the backbone, so 1 FPS and 7 SA launches a step);
  10. on the trained weights and the agreement tracklets, every TEST.REF_BOX x
     TEST.SHAPE_AGGREGATION mode through ``eval_one_epoch_device``, and the host
     evaluator (``eval_one_epoch``), each on the kernel and the plain path from
     the same seed and within 1.0 of each other; the host evaluator also within
     1.0 of the asset's recorded host Success/Precision;
  11. the test CLI (``python3 -m ptt_tpu_torch.tools.test_tracking``), run as a
     subprocess on KITTI-format trees written to a temporary directory: the
     agreement tracklets as scenes 0000-0007 with the trained asset, device and
     host paths within 1.0 of phase 10's; then scene 0019 of 150 sweeps of
     120,000 points with 4 cars, at the default max_points 16384, twice (the
     first run builds the tracklet database, the second reads it): frames/s,
     the database's size, 2 FPS + 7 SA launches a frame step, the two runs'
     boxes equal, and the first frame step's resampled rows against the CPU's;
  12. the train CLI at B = 48 on a scene of 4 cars x 60 such sweeps from the
     trained asset, one epoch, then resumed for a second, each scored by
     TRAIN.WITH_EVAL on a shorter test scene; ms a step with the KITTI loader,
     2 FPS + 7 + 7 group launches a step; ``--eval_all`` over both
     checkpoints; a reference-layout ``.pth`` loaded as ``--ckpt`` loads it,
     its forward bit-equal to the asset's;
  13. ``ptt_waymo.yaml`` (8192 / 2048-point clouds, stage 0 to 2048 / 1024
     centers) as phases 8-9 take a configuration, the FPS calls also against
     the kernel's round in plain PyTorch (``furthest_point_sample_packed``);
     then (13b) the test CLI with it on phase 11b's scene 0019;
  14. ``ptt_waymo.yaml`` training at B = 48 on synthetic items resampled to
     8192 / 2048 points: the group kernels at its 7 shapes and on a
     heavy-duplication cloud, as phase 6 checks them, then train steps:
     launches, ms a step, peak memory;
  15. mixed precision and the optimizers: one bf16 step on the kernel path and
     one on the plain path from the same state with the same FPS picks, within
     a stated band; bf16 and float32 step times alternated; the train CLI on
     ``p2b_synth_strong.yaml`` (bf16 from the file) and on ``ptt_synth.yaml``
     once per OPTIMIZER, finite losses;
  16. the agreement tracklets written as a nuScenes release, scored by the
     test CLI on ``nuscenes_models/ptt.yaml`` with the trained asset, within
     1.0 of phase 10's numbers.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a GPU it exits 1 and prints no result.
"""

from __future__ import annotations

import copy
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
ASSET = os.path.join(REPO, "tests", "assets", "ptt_synth_trained.npz")

# published H100 SXM peaks (dense): float32 on CUDA cores, device memory, and
# the SM clock behind the first (132 SMs x 128 lanes x 2 x 1.98 GHz)
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
PEAK_CLOCK = 1.98e9
SMS = 132
# Least cycles from one dependent step to the next, for the bound of a chain that
# no rate shortens (FPS). Each is set under what ptt_tpu_torch/csrc/fps.cu's probe
# kernel reads on an NVIDIA H100 80GB HBM3 at 700 W (a chain of float adds 4.48
# cycles a step, warp shuffles 24.0, redux.sync 44.2, shared-memory loads 29.0,
# a store and load of one word 33.4, a barrier of 1 / 4 / 16 warps 14.6 / 20.6 /
# 45.0; SM clock 1.995 GHz). Phase 2 prints the probe's readings on the card it
# runs on and fails if one of these constants is above its reading.
CYC_ALU = 4
CYC_SHFL = 23
CYC_REDUX = 42
CYC_SMEM = 28
CYC_BAR = 14
SA_RTOL = SA_ATOL = 1e-4  # kernel vs plain: float32 sums in another order
# group kernels vs plain versions, relative to each tensor's largest entry: the
# forward adds Z[j] + O[m] where the plain version multiplies the grouped
# offsets, dZ sums rows in another order, and the input gradients go through
# the fold algebra instead of autograd of the composite
GROUP_FWD_TOL = 1e-5
GROUP_BWD_TOL = 1e-5
GROUP_GRAD_TOL = 5e-4
TRAIN_B = 48
SEED = 0  # torch.manual_seed of the configurations without trained weights


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


def queued_ms(fn, iters: int) -> float:
    """Device time of one call: the stream is first held busy (~0.1 s) so that
    the host has enqueued every call before the first one starts; the events
    around them then read device time only, where ``cuda_ms`` reads the larger
    of host and device time."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn, iters: int, names):
    """Device time of one call by kernel, from torch.profiler: for each of
    ``names`` the summed time of the kernels whose name contains it, per call.
    A window in which the profiler reports no device time is taken again; the
    run fails when five in a row are empty."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    fn()
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = dict.fromkeys(names, 0.0)
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA:
                for n in names:
                    if n in e.key:
                        out[n] += e.self_device_time_total / iters / 1e3
        if any(out.values()):
            return out
    fail(f"torch.profiler reported no device time for {names} in five windows")


def by_kernel(parts) -> str:
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items())


# ---------------------------------------------------------------- bounds (least time)


def fps_bound(xyz, npoint):
    B, N, _ = xyz.shape
    nbytes = 4 * (B * N * 3 + B * npoint)
    ops = 10 * B * N * npoint  # per point and round: 3 sub, 3 mul, 2 add, min, compare
    return nbytes, ops


def fps_round_cycles(n, redux=True):
    """Least cycles of one FPS round over n points, for the block size and the
    reduction forms that make it least: round k needs round k - 1's choice, so
    whatever the design, a round reads the chosen point (one shared-memory
    load), updates distances (a chain of sub, mul, add, add, min; a warp's p
    points a thread at 10 instructions each share a scheduler's slots with the other
    warps of its SM quarter), takes the argmax over a warp (5 levels of shuffle,
    compare, select, or with ``redux`` a redux.sync for the largest value, a
    compare and a redux.sync for its lowest index) and, with several warps,
    crosses one barrier (store, barrier, load) and reduces the warps' results:
    by shuffle levels, by the redux pair, or by every thread comparing all of
    them itself (compare and select a level). Returns (cycles, warps)."""
    shfl_level = CYC_SHFL + 2 * CYC_ALU
    redux_pair = 2 * CYC_REDUX + CYC_ALU
    best = None
    for warps in (1, 2, 4, 8, 16, 32):
        p = -(-n // (32 * warps))
        levels = warps.bit_length() - 1
        in_warp = [5 * shfl_level] + ([redux_pair] if redux else [])
        cycles = CYC_SMEM + 5 * CYC_ALU + 10 * p * -(-warps // 4) + min(in_warp)
        if warps > 1:
            across = [levels * shfl_level, levels * 2 * CYC_ALU] + ([redux_pair] if redux else [])
            cycles += 2 * CYC_SMEM + CYC_BAR + min(across)
        if best is None or cycles < best[0]:
            best = (cycles, warps)
    return best


def fps_chain_bound_ms(xyz, npoint, clock=PEAK_CLOCK):
    """The bound that counts FPS's chain, from the inputs: npoint - 1 dependent
    rounds of ``fps_round_cycles`` at the SM clock (the published boost clock, or
    the card's own reading where that is higher); batch rows run side by side,
    one wave of blocks per SMS rows."""
    B, N, _ = xyz.shape
    return -(-B // SMS) * (npoint - 1) * fps_round_cycles(N)[0] / clock * 1e3


def check_fps_constants(probe):
    """The probe's readings beside the constants of the latency bound; fails when
    a constant is above its reading (the bound would no longer be one)."""
    pairs = (("float add", CYC_ALU, probe["alu"]), ("shuffle", CYC_SHFL, probe["shfl"]),
             ("redux.sync", CYC_REDUX, probe["redux"]), ("shared-memory load", CYC_SMEM, probe["smem_load"]),
             ("barrier", CYC_BAR, min(probe["barrier_1"], probe["barrier_4"], probe["barrier_16"])))
    log("  fps probe, cycles a dependent step on this card (constant in use): "
        + ", ".join(f"{name} {read:.2f} ({const})" for name, const, read in pairs)
        + f"; ballot {probe['ballot']:.2f}, store and load of one word {probe['smem_store_load']:.2f}, barrier of 1 / 4 / 16 "
        f"warps {probe['barrier_1']:.2f} / {probe['barrier_4']:.2f} / {probe['barrier_16']:.2f}; SM clock "
        f"{probe['clock_ghz']:.3f} GHz (bound computed at {max(PEAK_CLOCK, probe['clock_ghz'] * 1e9) / 1e9:.3f})")
    for name, const, read in pairs:
        if const > read:
            fail(f"FPS latency bound: the least-cycle constant of a {name} ({const}) is above this card's reading {read:.2f}")


def scanned_points(xyz, new_xyz, radius, nsample, point_ops):
    """Points the ball query scans: each center's points up to its nsample-th hit."""
    N = xyz.shape[1]
    d2 = point_ops.square_distance(new_xyz, xyz)
    hits = (d2 < point_ops.radius_sq(radius)).cumsum(-1)
    reached = hits >= nsample
    return int(torch.where(reached.any(-1), reached.float().argmax(-1) + 1,
                           torch.full_like(hits[..., 0], N)).sum())


def group_fwd_bound(xyz, new_xyz, H, radius, nsample, point_ops):
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    nbytes = 4 * (B * N * 3 + B * M * 3 + B * N * H + B * M * H + B * nsample * M * H + B * M * nsample)
    ops = 14 * scanned_points(xyz, new_xyz, radius, nsample, point_ops) + B * nsample * M * H
    return nbytes, ops


def group_bwd_bound(B, N, M, nsample, H):
    nbytes = 4 * (B * nsample * M * H + B * M * nsample + B * N * H)
    return nbytes, B * nsample * M * H


def sa_bound(xyz, new_xyz, features, radius, nsample, weights, biases, point_ops):
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    cf = 0 if features is None else features.shape[-1]
    widths = [w.shape[1] for w in weights]
    nbytes = 4 * (B * N * (3 + cf) + B * M * 3 + sum(w.numel() for w in weights)
                  + sum(b.numel() for b in biases) + B * M * widths[-1])
    ops = 14 * scanned_points(xyz, new_xyz, radius, nsample, point_ops)
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


def sa_hard_cases(args, kwargs):
    """Two more weight sets for one SA call: the trained weights with layer 0 and
    every later bias scaled by s, which scales the whole ReLU network by s, with
    s chosen so that the output reaches ~1e3; and random weights (He-scaled
    normal, unit normal biases) from a seed."""
    from ptt_tpu_torch.ops import sa

    xyz, new_xyz, features, radius, nsample, weights, biases = args
    peak = float(sa.fused_sa_plain(*args, **kwargs).abs().max())
    s = 1e3 / max(peak, 1e-6)
    scaled = ([weights[0] * s] + list(weights[1:]), [b * s for b in biases])
    gen = torch.Generator(device=xyz.device).manual_seed(7)
    rand_w = [torch.randn(w.shape, device=w.device, generator=gen) * (2.0 / w.shape[0]) ** 0.5 for w in weights]
    rand_b = [torch.randn(b.shape, device=b.device, generator=gen) for b in biases]
    return {"scaled to 1e3": scaled, "random weights": (rand_w, rand_b)}


def fps_hard_cases(device):
    """Clouds that try FPS's tie handling and every compiled form: (label, xyz, npoint)."""
    gen = torch.Generator(device=device).manual_seed(3)
    extent = torch.tensor([2.2, 1.0, 0.8], device=device)

    def cloud(B, N):
        return (torch.rand((B, N, 3), device=device, generator=gen) * 2 - 1) * extent

    def resampled(B, N, distinct):
        pick = torch.randint(0, distinct, (B, N), device=device, generator=gen)
        return torch.gather(cloud(B, distinct), 1, pick[..., None].expand(B, N, 3)).contiguous()

    return [("N identical points", cloud(2, 1).expand(2, 640, 3).contiguous(), 64),
            ("resampled from 8 distinct points", resampled(4, 1024, 8), 256),
            ("resampled from 8 distinct points, 1 warp", resampled(4, 128, 8), 128),
            ("ragged N = 1000", cloud(4, 1000), 300), ("ragged N = 100", cloud(4, 100), 100),
            ("npoint == N", cloud(3, 512), 512), ("N = 129, the 8-warp form nearly empty", cloud(2, 129), 129),
            ("N = 2048, the 16-warp form", cloud(4, 2048), 512),
            ("ragged N = 1500, 16 warps, ties", resampled(2, 1500, 8), 400), ("N = 1", cloud(2, 1), 1),
            ("N = 2049, the 16 x 16 form nearly empty", cloud(4, 2049), 512),
            ("N = 8192, the 16 x 16 form", cloud(2, 8192), 2048),
            ("8192 identical points", cloud(2, 1).expand(2, 8192, 3).contiguous(), 256),
            ("8192 resampled from 8 distinct points", resampled(2, 8192, 8), 300),
            ("ragged N = 5000, the 16 x 16 form", resampled(2, 5000, 600), 1000)]


def fps_clock(device):
    """The SM clock of the FPS latency bound: the published boost clock, or the
    card's own reading where that is higher; first the compiled forms and the
    probe's cycle counts are checked."""
    from ptt_tpu_torch.ops import fps

    for limit, warps, pts in fps.KERNEL_FORMS:
        if fps.built_form(limit) != (warps, pts):
            fail(f"FPS: csrc/fps.cu runs N = {limit} in the form {fps.built_form(limit)}, ops/fps.py says {(warps, pts)}")
    probe = fps.latency_probe(device)
    check_fps_constants(probe)
    return max(PEAK_CLOCK, probe["clock_ghz"] * 1e9)


def check_fps(calls, device, clock, extras=True):
    """FPS: the forward's captured calls (the record's rows), and with ``extras``
    the two shapes of a B = 48 train step and the hard cases, each against the
    plain version; time by events and on the device, the latency bound, the share."""
    from ptt_tpu_torch.ops import fps, point_ops

    gen = torch.Generator(device=device).manual_seed(4)
    extent = torch.tensor([2.2, 1.0, 0.8], device=device)
    train = [(f"train step, B = {TRAIN_B}", (torch.rand((B, N, 3), device=device, generator=gen) * 2 - 1) * extent, m)
             for B, N, m in ((2 * TRAIN_B, 1024, 512), (TRAIN_B, 128, 64))] if extras else []
    rows = []
    for label, xyz, npoint in [("frame step", x, m) for (x, m), _ in calls] + train:
        got = fps.furthest_point_sample(xyz, npoint)
        ref = point_ops.furthest_point_sample(xyz, npoint)
        packed = fps.furthest_point_sample_packed(xyz, npoint, *fps.kernel_form(xyz.shape[1])) if label == "frame step" \
            else ref
        torch.cuda.synchronize()
        shape = f"{tuple(xyz.shape)}->{npoint}"
        if not torch.equal(got, ref):
            fail(f"FPS kernel differs from its plain version at {shape} ({label}): {int((got != ref).sum())} indices")
        if not torch.equal(got, packed):
            fail(f"FPS kernel differs from furthest_point_sample_packed at {shape} ({label})")
        ms = cuda_ms(lambda: fps.furthest_point_sample(xyz, npoint), 20)
        dev_ms = queued_ms(lambda: fps.furthest_point_sample(xyz, npoint), 20)
        plain_ms = cuda_ms(lambda: point_ops.furthest_point_sample(xyz, npoint), 3, warmup=1)
        rate_ms, kind = bound_ms(*fps_bound(xyz, npoint))
        chain = fps_chain_bound_ms(xyz, npoint, clock)
        cycles, warps = fps_round_cycles(xyz.shape[1])
        log(f"  fps {shape} ({label}), form {fps.kernel_form(xyz.shape[1])}: kernel {ms:.4f} ms by events around the wrapper, "
            f"{dev_ms:.4f} ms on the device (calls queued behind a busy stream), plain {plain_ms:.3f} ms, library_ms none; "
            f"bound by latency {chain:.4f} ms ({npoint - 1} dependent rounds of at least {cycles} cycles, at {warps} "
            f"warps a row, {cycles / clock * 1e6:.3f} us a round; the kernel's round {dev_ms / npoint * 1e3:.3f} us), "
            f"by rates {rate_ms:.5f} ms ({kind}); {100 * max(rate_ms, chain) / ms:.0f}% reached by events, "
            f"{100 * max(rate_ms, chain) / dev_ms:.0f}% on the device")
        if max(rate_ms, chain) > min(ms, dev_ms):
            fail(f"FPS at {shape}: the kernel is faster than its bound; the bound's cycle counts are too high")
        # the record's bound_by has two words; the chain is a count of dependent
        # operations, and bound_term says that latency, not a rate, sets it
        rows.append(dict(shape=shape, label=label, err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=max(rate_ms, chain), bound_by="operations" if chain >= rate_ms else kind,
                         bound_term="latency" if chain >= rate_ms else "rate", rate_bound_ms=rate_ms, mismatch=0))
    for label, xyz, npoint in fps_hard_cases(device) if extras else []:
        got = fps.furthest_point_sample(xyz, npoint)
        ref = point_ops.furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        log(f"  fps {tuple(xyz.shape)}->{npoint} ({label}), form {fps.kernel_form(xyz.shape[1])}: equal to plain {same}")
        if not same:
            fail(f"FPS kernel differs from its plain version on the hard case '{label}': {int((got != ref).sum())} indices")
    for n in (fps.MAX_POINTS + 1, 2 * fps.MAX_POINTS) if extras else ():
        try:
            fps.furthest_point_sample(torch.zeros((1, n, 3), device=device), 8)
        except ValueError:
            continue
        fail(f"FPS: the wrapper did not refuse N = {n}, beyond its largest form")
    return rows[:len(calls)], rows[len(calls):]


def check_kernels(calls, clock, extras=True):
    """Every captured FPS and SA call against its plain version (FPS's extra
    cases with ``extras``); returns the rows of the record by kernel."""
    from ptt_tpu_torch.ops import point_ops, sa

    frame_rows = check_fps(calls["fps"], calls["sa"][0][0][0].device, clock, extras)[0] if calls["fps"] else []
    rows = {"fps": frame_rows, "sa": []}
    for args, kwargs in calls["sa"]:
        xyz, new_xyz, features, radius, nsample, weights, biases = args
        B, M = new_xyz.shape[:2]
        shape = f"{tuple(xyz.shape)}->{M} ns{nsample} r{radius} C{[w.shape[0] for w in weights] + [weights[-1].shape[1]]}"
        widths = [w.shape[1] for w in weights]
        if sa.smem_bytes(xyz.shape[1], nsample, widths) != sa.kernel_smem_bytes(xyz.shape[1], nsample, widths):
            fail(f"ops/sa.py smem_bytes differs from csrc/sa.cu's at {shape}")
        ref_idx = point_ops.ball_query(radius, nsample, xyz, new_xyz)
        cases = {"trained weights": (weights, biases), **sa_hard_cases(args, kwargs)}
        for case, (ws, bs) in cases.items():
            idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
            case_args = (xyz, new_xyz, features, radius, nsample, ws, bs)
            got = sa.fused_sa_inference(*case_args, **kwargs, idx_out=idx)
            ref = sa.fused_sa_plain(*case_args, **kwargs)
            emu = sa.fused_sa_split(*case_args, **kwargs)
            torch.cuda.synchronize()
            mismatch = int((idx != ref_idx).sum())
            peak = float(ref.abs().max())
            case_err, emu_err = float((got - ref).abs().max()), float((emu - ref).abs().max())
            log(f"  sa {shape}, {case}: max |kernel - plain| {case_err:.3e} ({case_err / peak:.2e} of the largest "
                f"entry {peak:.3e}), plain emulation of the split tail {emu_err:.3e}, ball-query membership "
                f"disagreements {mismatch}")
            if mismatch:
                fail(f"SA kernel's ball query differs from point_ops.ball_query at {shape}")
            if case == "trained weights":
                err = case_err
                if not torch.allclose(got, ref, rtol=SA_RTOL, atol=SA_ATOL):
                    fail(f"SA kernel differs from its plain version at {shape} beyond rtol/atol {SA_RTOL}")
            elif not (case_err <= SA_RTOL * peak and torch.isfinite(got).all()):
                fail(f"SA kernel differs from its plain version at {shape}, {case}, beyond {SA_RTOL} of the largest entry")
        # layer 0 as the kernels left it against its plain version
        _, z, off = sa._launch(xyz, new_xyz, features, weights[0].float().contiguous(), biases[0].float().contiguous(),
                               weights[1:], biases[1:], radius, nsample, kwargs.get("normalize_xyz", True),
                               kwargs.get("use_xyz", True), None)
        z_ref, off_ref = sa._first_layer(xyz, new_xyz, features, radius, weights[0], biases[0],
                                         kwargs.get("normalize_xyz", True), kwargs.get("use_xyz", True))
        l0_err = max(relerr(z, z_ref), relerr(off, off_ref))
        if l0_err > GROUP_FWD_TOL:
            fail(f"SA layer 0 differs from its plain version at {shape}: {l0_err:.2e} of the largest entry")
        ms = cuda_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 20)
        dev_ms = queued_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 20)
        parts = kernel_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 10, ("sa_pre_kernel", "sa_kernel"))
        plain_ms = cuda_ms(lambda: sa.fused_sa_plain(*args, **kwargs), 10)
        b, kind = bound_ms(*sa_bound(xyz, new_xyz, features, radius, nsample, weights, biases, point_ops))
        log(f"    layer 0 rel err {l0_err:.2e}; device time by kernel (profiler; sa_kernel starts beside "
            f"sa_pre_kernel and waits for it): {by_kernel(parts)}")
        rows["sa"].append(dict(shape=shape, err=err, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                               bound_ms=b, bound_by=kind, mismatch=mismatch))
    for name, rs in rows.items():
        for r in rs:
            log(f"  {name} {r['shape']}: kernel {r['ms']:.4f} ms"
                + (f" by events around the wrapper, {r['device_ms']:.4f} ms on the device (calls queued behind a busy "
                   f"stream)" if "device_ms" in r else "")
                + f", plain {r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r.get('bound_term', r['bound_by'])}, "
                f"{100 * r['bound_ms'] / r['ms']:.0f}% reached by events"
                + (f", {100 * r['bound_ms'] / r['device_ms']:.0f}% on the device" if "device_ms" in r else "") + ")")
    return rows


def profile_batch(ev, tracklets, n_frames, tag="[5]"):
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
    log(f"{tag} profile of one batch ({n_frames} frames, {steps} frame steps): wall {wall * 1e3:.1f} ms, "
        f"host enqueue {t_enqueue * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}% busy, {100 - 100 * busy_us / 1e6 / wall:.1f}% idle), "
        f"{sum(e.count for e in kernels)} device operations")
    if busy_us == 0:
        log("  the profiler saw no device time: busy share not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:8.2f} ms  {e.count:6d}x  {e.key[:90]}")
    own = {name: [e for e in kernels if name in e.key] for name in ("fps_kernel", "sa_pre_kernel", "sa_kernel")}
    log("  the port's kernels in that batch: " + ", ".join(
        f"{name} {sum(e.self_device_time_total for e in es) / 1e3:.2f} ms in {sum(e.count for e in es)} launches "
        f"({100 * sum(e.self_device_time_total for e in es) / max(busy_us, 1):.1f}% of the busy time)"
        for name, es in own.items()))


def bench_tracklets():
    """The benchmark workload: 8 synthetic tracklets of 64 frames (600 object,
    400 clutter and 120 pole points a frame), the JAX ``bench.py`` workload."""
    from ptt_tpu_torch.data.synthetic import make_tracklets

    return make_tracklets({"NUM_TRACKLETS": 8, "FRAMES_PER_TRACKLET": 64, "POINTS_PER_FRAME": 600,
                           "CLUTTER_POINTS": 400})


def first_frames(tracklets, n):
    """The tracklets cut to their first ``n`` frames (one 32-frame bucket for n = 32)."""
    return [(pcs[:n], boxes[:n], annos[:n]) for pcs, boxes, annos in tracklets]


def bench_rate(ev, tracklets, n_batches):
    """Frames/s of ``n_batches`` batches of ``tracklets``, two deep: batch k + 1
    is enqueued before the host scores batch k."""
    n_frames = sum(len(t[0]) for t in tracklets)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    in_flight = None
    for _ in range(n_batches):
        handle = ev.dispatch_batch(tracklets)
        if in_flight is not None:
            ev.finish_batch(in_flight)
        in_flight = handle
    ev.finish_batch(in_flight)
    return n_batches * n_frames / (time.perf_counter() - t0)


def check_forward(model, batch, tag, trained=False):
    """The whole forward on the kernel path against the plain path: sample
    indices equal, pred_box_data within 2e-3, the same best proposal. The plain
    path takes the kernel path's FPS picks (each FPS call also held against
    the plain FPS on the kernel's own input): the box head samples the votes,
    which the two paths round differently, so on seeded weights a near-tie
    among them could make the plain FPS pick another center; how many picks it
    would change, and the free-running plain path's difference, are printed
    beside. With ``trained`` (the trained weights) the plain path's own FPS must
    change no pick and the free-running plain path must stay within 2e-3 too."""
    from ptt_tpu_torch.nn import set_use_kernels
    from ptt_tpu_torch.ops import fps, point_ops

    with torch.no_grad():
        with FpsReplay(fps, point_ops) as replay:
            out_k = model(batch)
            replay.start()
            set_use_kernels(model, False)
            out_p = model(batch)
        free = model(batch)
        set_use_kernels(model, True)
    for key in ("search_inds", "template_inds"):
        if not torch.equal(out_k[key], out_p[key]):
            fail(f"{tag} forward: {key} differ between kernel and plain paths")
    box_err = float((out_k["pred_box_data"] - out_p["pred_box_data"]).abs().max())
    free_err = float((out_k["pred_box_data"] - free["pred_box_data"]).abs().max())
    same_best = torch.equal(out_k["pred_box_data"][..., 4].argmax(1), out_p["pred_box_data"][..., 4].argmax(1))
    log(f"{tag} forward B={batch['search_points'].shape[0]}: max |pred_box_data kernel - plain| {box_err:.3e} with "
        f"the kernel's FPS picks (FPS = plain on the kernel's input at {replay.checked}; picks the plain path's own "
        f"FPS would change {replay.changed}; free-running plain path {free_err:.3e}), same best proposal {same_best}")
    if not (box_err <= 2e-3 and same_best and torch.isfinite(out_k["pred_box_data"]).all()):
        fail(f"{tag} forward: kernel path does not match the plain path")
    if trained and (sum(replay.changed) or not free_err <= 2e-3):
        fail(f"{tag} forward: the free-running plain path parts from the kernel path (FPS picks changed "
             f"{replay.changed}, max |pred_box_data| difference {free_err:.3e})")


def config_phase(tag, name, cfg, device, card, clock, n_fps, agreement, bench):
    """Phases 8 and 9: one more configuration at its full published width, on
    the port's own seeded init (no trained weights exist for it): every FPS
    and SA call of the first frame step's forward against its plain version,
    the forward against the plain path, then the tracker on the benchmark
    workload: launches per frame step, frames/s, a profile of one batch.
    Returns (rows by kernel, launches of one batch)."""
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network, set_use_kernels
    from ptt_tpu_torch.ops import fps, sa

    torch.manual_seed(SEED)
    model = build_network(cfg["MODEL"], device=device)
    data = cfg["DATA_CONFIG"]
    batch = first_step_batch(agreement, cfg, device)
    calls = capture_kernel_calls(model, batch)
    log(f"{tag} {name} at full width (search {data['SEARCH_INPUT_SIZE']}, template {data['TEMPLATE_INPUT_SIZE']} "
        f"points), the port's own init from torch.manual_seed({SEED}); a forward made {len(calls['fps'])} FPS and "
        f"{len(calls['sa'])} SA calls; kernels vs plain versions at its shapes (B = 8), SA rtol = atol = {SA_RTOL}")
    if (len(calls["fps"]), len(calls["sa"])) != (n_fps, 7):
        fail(f"{tag} {name}: the forward made {len(calls['fps'])} FPS and {len(calls['sa'])} SA calls, "
             f"not {n_fps} and 7")
    rows = check_kernels(calls, clock, extras=False)
    check_forward(model, batch, tag)
    del calls

    ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device)
    fps.launches = sa.launches = 0
    results = ev.track_batch(bench)
    torch.cuda.synchronize()
    launches = {"fps": fps.launches, "sa": sa.launches}
    steps = len(bench[0][0]) - 1
    centers = np.array([[b.center for b in trk] for trk in results])
    log(f"{tag} {name} tracker, one batch of the benchmark workload: launches {launches} over {steps} frame steps "
        f"({n_fps} FPS and 7 SA calls a step expected); boxes finite {bool(np.isfinite(centers).all())}")
    if launches != {"fps": n_fps * steps, "sa": 7 * steps}:
        fail(f"{tag} {name} tracker: launches {launches}, expected {n_fps} and 7 per frame step over {steps} steps")
    if not np.isfinite(centers).all():
        fail(f"{tag} {name} tracker: non-finite boxes")
    rates = [bench_rate(ev, bench, 4) for _ in range(3)]
    set_use_kernels(model, False)
    plain_rate = bench_rate(ev, first_frames(bench, 32), 1)
    set_use_kernels(model, True)
    log(f"{tag} {name} throughput, 8 x 64-frame tracklets, 4 pipelined batches per run: "
        f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f}); plain path "
        f"{plain_rate:.1f} frames/s (one batch cut to 32 frames); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; card {card}")
    profile_batch(ev, bench, sum(len(t[0]) for t in bench), tag)
    del ev, model
    torch.cuda.empty_cache()
    return rows, launches


def check_sa_limit(device):
    """Phase 8: the SA kernel at the largest cloud its wrapper passes for a
    stage of 64-wide stored layers (the 64-row block and the cloud fill shared
    memory), against its plain version; the next multiple of 4 is refused, and
    at both the wrapper's copy of the block's shared memory is the library's."""
    from ptt_tpu_torch.ops import point_ops, sa

    n, limit = 13652, 13656
    gen = torch.Generator(device=device).manual_seed(8)
    xyz = torch.rand((1, n, 3), device=device, generator=gen) * 2
    new_xyz = xyz[:, :64].contiguous()
    widths = [3, 64, 64, 128]
    ws = [torch.randn((a, b), device=device, generator=gen) * (2.0 / a) ** 0.5 for a, b in zip(widths, widths[1:])]
    bs = [torch.randn((b,), device=device, generator=gen) for b in widths[1:]]
    idx = torch.empty((1, 64, 32), dtype=torch.int32, device=device)
    got = sa.fused_sa_inference(xyz, new_xyz, None, 0.3, 32, ws, bs, idx_out=idx)
    ref = sa.fused_sa_plain(xyz, new_xyz, None, 0.3, 32, ws, bs)
    mismatch = int((idx != point_ops.ball_query(0.3, 32, xyz, new_xyz)).sum())
    err = float((got - ref).abs().max())
    for size in (n, limit):
        if sa.smem_bytes(size, 32, widths[1:]) != sa.kernel_smem_bytes(size, 32, widths[1:]):
            fail(f"ops/sa.py smem_bytes differs from csrc/sa.cu's at N = {size}")
    log(f"[8] sa at the wrapper's outer limit (1, {n}, 3)->64 ns32 C{widths}, {sa.smem_bytes(n, 32, widths[1:])} bytes "
        f"of shared memory a block: max |kernel - plain| {err:.3e}, ball-query membership disagreements {mismatch}")
    if mismatch or not torch.allclose(got, ref, rtol=SA_RTOL, atol=SA_ATOL):
        fail(f"SA kernel differs from its plain version at N = {n}, the wrapper's outer limit")
    try:
        sa.fused_sa_inference(torch.zeros((1, limit, 3), device=device), new_xyz, None, 0.3, 32, ws, bs)
    except ValueError:
        return
    fail(f"SA: the wrapper did not refuse N = {limit}, beyond its outer limit")


MODES = [(ref, agg) for ref in ("previous_result", "previous_gt", "current_gt")
         for agg in ("firstandprevious", "first", "previous", "all")]


def modes_phase(cfg, model, meta, agreement, device):
    """Phase 10, on the trained asset over the agreement tracklets: every
    TEST.REF_BOX x TEST.SHAPE_AGGREGATION mode through ``eval_one_epoch_device``
    on the kernel path and on the plain path from the same generator seed,
    each pair within 1.0; then the host evaluator (``eval_one_epoch``) on both
    paths, within 1.0 of each other and of the asset's recorded host numbers.
    Both write ``track_result.txt``; its lines are counted. Returns the kernel
    path's Success/Precision of the deployed mode ("device") and of the host
    evaluator ("host")."""
    from ptt_tpu_torch.eval.device_loop import eval_one_epoch_device
    from ptt_tpu_torch.eval.evaluator import eval_one_epoch
    from ptt_tpu_torch.nn import set_use_kernels

    out_dir = os.path.join(REPO, "build", "chip_smoke_eval")
    quiet = logging.getLogger("chip_smoke.eval")
    quiet.setLevel(logging.WARNING)

    def result_lines(path):
        with open(os.path.join(out_dir, path, "final_result", "data", "track_result.txt")) as f:
            return sum(1 for _ in f)

    def both(fn):
        got = {}
        for path in ("kernel", "plain"):
            set_use_kernels(model, path == "kernel")
            shutil.rmtree(out_dir, ignore_errors=True)
            t0 = time.perf_counter()
            got[path] = fn(os.path.join(out_dir, path)) + (time.perf_counter() - t0, result_lines(path))
        set_use_kernels(model, True)
        return got

    frames = sum(len(t[0]) for t in agreement)
    deployed = None
    for ref, agg in MODES:
        mcfg = copy.deepcopy(cfg)
        mcfg["TEST"].update(REF_BOX=ref, SHAPE_AGGREGATION=agg)
        got = both(lambda d: eval_one_epoch_device(mcfg, model, [agreement], logger=quiet, max_points=1024,
                                                   batch_size=8, result_dir=d, device=device)[:2])
        (ks, kp, kt, kn), (ps, pp, pt, pn) = got["kernel"], got["plain"]
        log(f"[10] REF_BOX {ref}, SHAPE_AGGREGATION {agg}: kernel path Success {ks:.2f} Precision {kp:.2f} "
            f"({kt:.2f} s), plain path {ps:.2f}/{pp:.2f} ({pt:.2f} s), delta {ks - ps:+.2f}/{kp - pp:+.2f}; "
            f"track_result.txt lines {kn}, {pn}")
        if not (abs(ks - ps) <= 1.0 and abs(kp - pp) <= 1.0):
            fail(f"[10] mode {ref}/{agg}: the kernel path is not within 1.0 of the plain path")
        if kn != frames or pn != frames:
            fail(f"[10] mode {ref}/{agg}: track_result.txt holds {kn} / {pn} lines, not {frames}")
        if (ref, agg) == ("previous_result", "firstandprevious"):
            deployed = (ks, kp)
    got = both(lambda d: eval_one_epoch(cfg, model, [agreement], logger=quiet, result_dir=d, device=device))
    (ks, kp, kt, kn), (ps, pp, pt, pn) = got["kernel"], got["plain"]
    log(f"[10] host evaluator (eval_one_epoch, one forward a frame at B = 1): kernel path Success {ks:.2f} "
        f"Precision {kp:.2f} ({frames} frames in {kt:.2f} s, {(frames - len(agreement)) / kt:.1f} tracked frames/s), "
        f"plain path {ps:.2f}/{pp:.2f} ({pt:.2f} s); recorded host {meta['host_success']:.2f}/"
        f"{meta['host_precision']:.2f} (delta {ks - meta['host_success']:+.2f}/{kp - meta['host_precision']:+.2f}); "
        f"track_result.txt lines {kn}, {pn}")
    shutil.rmtree(out_dir, ignore_errors=True)
    if not (abs(ks - ps) <= 1.0 and abs(kp - pp) <= 1.0):
        fail("[10] host evaluator: the kernel path is not within 1.0 of the plain path")
    if not (abs(ks - meta["host_success"]) <= 1.0 and abs(kp - meta["host_precision"]) <= 1.0):
        fail("[10] host evaluator: not within 1.0 of the asset's recorded host Success/Precision")
    if kn != frames or pn != frames:
        fail(f"[10] host evaluator: track_result.txt holds {kn} / {pn} lines, not {frames}")
    return {"device": deployed, "host": (ks, kp)}


def relerr(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def train_batches(data_cfg, n, seed=0):
    """The first ``n`` batches of TRAIN_B synthetic train items of an epoch,
    built by the port's loader (8 threads)."""
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset

    loader = DataLoader(SyntheticTrackingDataset(data_cfg), TRAIN_B, shuffle=True, drop_last=True,
                        seed=seed, num_workers=8)
    out = []
    for batch in loader:
        out.append(batch)
        if len(out) == n:
            break
    return loader, out


def capture_group_calls(model, batch, device):
    """One train-mode forward on the kernel path, recording the inputs of every
    grouped_first_linear call (the model's BatchNorm statistics move; pass a copy)."""
    from ptt_tpu_torch.ops import group
    from ptt_tpu_torch.train.train_step import to_device

    calls = []
    orig = group.grouped_first_linear

    def rec(xyz, new_xyz, features, w1, radius, nsample, normalize_xyz=True, use_xyz=True):
        calls.append(dict(xyz=xyz.detach().clone(), new_xyz=new_xyz.detach().clone(),
                          features=None if features is None else features.detach().clone(),
                          w1=w1.detach().clone(), radius=radius, nsample=nsample,
                          normalize_xyz=normalize_xyz, use_xyz=use_xyz))
        return orig(xyz, new_xyz, features, w1, radius, nsample, normalize_xyz, use_xyz)

    group.grouped_first_linear = rec
    try:
        with torch.no_grad():
            model.train()(to_device(batch, device))
    finally:
        group.grouped_first_linear = orig
    return calls


def input_grads(fn, call, probe):
    """Gradients of sum(fn(...) * probe) with respect to xyz, new_xyz, features
    and w1 (features skipped when absent)."""
    ts = {k: call[k].clone().requires_grad_(True) for k in ("xyz", "new_xyz", "features", "w1")
          if call[k] is not None}
    out = fn(ts["xyz"], ts["new_xyz"], ts.get("features"), ts["w1"], call["radius"], call["nsample"],
             call["normalize_xyz"], call["use_xyz"])
    (out * probe).sum().backward()
    return {k: t.grad for k, t in ts.items()}


BWD_KERNELS = ("group_csr_kernel", "group_sum_kernel", "group_combine_kernel")


def heavy_duplication_call(call):
    """The call with its cloud resampled from its first 32 points and the centers
    on the first M copies, so that many rows share a few first hits; in batch
    row 0 point 0 is the only copy of its location and every center sits on it,
    so that most of the row's M * ns rows land on that one point."""
    xyz = call["xyz"]
    B, N, _ = xyz.shape
    M = call["new_xyz"].shape[1]
    gen = torch.Generator(device=xyz.device).manual_seed(5)
    pick = torch.randint(0, 32, (B, N), device=xyz.device, generator=gen)
    pick[0] = 1 + pick[0] % 31
    pick[0, 0] = 0
    heavy = torch.gather(xyz[:, :32], 1, pick[..., None].expand(B, N, 3)).contiguous()
    centers = heavy[:, :M].clone()
    centers[0] = heavy[0, 0]
    return dict(call, xyz=heavy, new_xyz=centers, label="heavy duplication")


def check_group_forward_ragged(device):
    """The forward at shapes no stage of the model has: a last tile of fewer than
    8 centers, rows that leave threads of a group idle, fewer rows than one
    tile, a cloud off every multiple; D and idx equal to the plain version's."""
    from ptt_tpu_torch.ops import group

    gen = torch.Generator(device=device).manual_seed(6)
    for B, N, M, ns, H in ((4, 300, 77, 12, 48), (2, 1000, 3, 4, 4), (3, 130, 64, 20, 260), (2, 37, 37, 8, 64)):
        xyz = torch.rand((B, N, 3), device=device, generator=gen)
        new_xyz = xyz[:, :M].contiguous()
        new_xyz[:, 0] += 9.0  # an empty ball
        z = torch.randn((B, N, H), device=device, generator=gen)
        off = torch.randn((B, M, H), device=device, generator=gen)
        d, idx = group.group_forward(xyz, new_xyz, z, off, 0.25, ns)
        d_ref, idx_ref = group.group_forward_plain(xyz, new_xyz, z, off, 0.25, ns)
        torch.cuda.synchronize()
        same = torch.equal(d, d_ref) and torch.equal(idx, idx_ref)
        log(f"  group forward {N}->{M} ns{ns} H{H} (ragged): D and idx equal to the plain version's {same}")
        if not same:
            fail(f"group forward differs from its plain version at the ragged shape {N}->{M} ns{ns} H{H}")
    for n, ns, h in ((1024, 32, 66), (1024, 6, 64), (20000, 32, 64)):
        try:
            group.group_forward(torch.zeros((1, n, 3), device=device), torch.zeros((1, 8, 3), device=device),
                                torch.zeros((1, n, h), device=device), torch.zeros((1, 8, h), device=device), 0.3, ns)
        except ValueError:
            continue
        fail(f"group forward: the wrapper did not refuse N = {n}, nsample = {ns}, H = {h}")


def check_group_kernels(calls):
    """Phase 6: each captured call through both kernels and their plain versions."""
    from ptt_tpu_torch.ops import group, point_ops

    check_group_forward_ragged(calls[0]["xyz"].device)

    rows = []
    gen = torch.Generator(device=calls[0]["xyz"].device).manual_seed(1)
    for c in calls:
        xyz, new_xyz, feats, w1 = c["xyz"], c["new_xyz"], c["features"], c["w1"]
        r, ns = c["radius"], c["nsample"]
        B, N, _ = xyz.shape
        M, H = new_xyz.shape[1], w1.shape[1]
        shape = f"{N}->{M} ns{ns} H{H} C{0 if feats is None else feats.shape[-1]}" + (f" ({c['label']})" if "label" in c else "")
        z, off = group.fold_inputs(xyz, new_xyz, feats, w1, r, c["normalize_xyz"], c["use_xyz"])
        d, idx = group.group_forward(xyz, new_xyz, z, off, r, ns)
        d_exact, _ = group.group_forward_plain(xyz, new_xyz, z, off, r, ns)
        ref_idx = point_ops.ball_query(r, ns, xyz, new_xyz)
        with torch.no_grad():
            d_full = group.grouped_first_linear(xyz, new_xyz, feats, w1, r, ns, c["normalize_xyz"], c["use_xyz"])
            d_plain = group.grouped_first_linear_plain(xyz, new_xyz, feats, w1, r, ns,
                                                       c["normalize_xyz"], c["use_xyz"])
        dd = torch.randn(d.shape, device=d.device, generator=gen)
        dz = group.group_backward(dd, idx, N)
        dz_again = group.group_backward(dd, idx, N)
        dz_plain = group.group_backward_plain(dd, idx, N)
        order = group.kernel_order(H)
        if order != group.documented_order(H):
            fail(f"group backward: csrc/group.cu sums in the order {order} (chunk, ranges, rows per load) at H = {H}, "
                 f"its documentation says {group.documented_order(H)}")
        dz_ordered = group.group_backward_ordered(dd, idx, N, order)
        gk = input_grads(group.grouped_first_linear, c, dd)
        gp = input_grads(group.grouped_first_linear_plain, c, dd)
        torch.cuda.synchronize()
        mismatch = int((idx != ref_idx).sum())
        fwd_err, bwd_err = relerr(d_full, d_plain), relerr(dz, dz_plain)
        fwd_abs = float((d - d_exact).abs().max())
        grad_err = {k: relerr(gk[k], gp[k]) for k in gp}
        log(f"  group {shape}: forward bit-equal to group_forward_plain {torch.equal(d, d_exact)}, to the composite rel err "
            f"{fwd_err:.2e} (abs {float((d_full - d_plain).abs().max()):.2e}), "
            f"idx disagreements {mismatch}, dZ rel err {bwd_err:.2e} (abs {float((dz - dz_plain).abs().max()):.2e}), "
            f"dZ bit-equal on repeat {torch.equal(dz, dz_again)} and to the documented order "
            f"{torch.equal(dz, dz_ordered)}, most rows on one point {int(torch.bincount(idx.reshape(B, -1)[0].long()).max())}, "
            f"input grads rel err "
            + ", ".join(f"{k} {v:.2e}" for k, v in grad_err.items()))
        if mismatch:
            fail(f"group forward's neighbour table differs from point_ops.ball_query at {shape}")
        if not torch.equal(d, d_exact):
            fail(f"group forward is not bit-equal to group_forward_plain on the same Z and O at {shape}")
        if fwd_err > GROUP_FWD_TOL or not torch.equal(d, d_full):
            fail(f"group forward differs from the composite (grouped_first_linear_plain) at {shape}")
        if bwd_err > GROUP_BWD_TOL:
            fail(f"group backward differs from index_add_ at {shape}")
        if not torch.equal(dz, dz_again):
            fail(f"group backward is not bit-equal on repeat at {shape}")
        if not torch.equal(dz, dz_ordered):
            fail(f"group backward does not sum in its documented order (group_backward_ordered) at {shape}")
        if max(grad_err.values()) > GROUP_GRAD_TOL:
            fail(f"group input gradients differ from the composite's autograd at {shape}: {grad_err}")

        del d_exact, d_full, d_plain
        fwd_ms = cuda_ms(lambda: group.group_forward(xyz, new_xyz, z, off, r, ns), 20)
        fwd_dev_ms = queued_ms(lambda: group.group_forward(xyz, new_xyz, z, off, r, ns), 20)
        fwd_parts = kernel_ms(lambda: group.group_forward(xyz, new_xyz, z, off, r, ns), 10, ("group_fwd_kernel",))
        fwd_plain_ms = cuda_ms(lambda: group.group_forward_plain(xyz, new_xyz, z, off, r, ns), 5)
        fill_ms = queued_ms(lambda: d.zero_(), 20)  # stores of D's bytes alone: what the memory takes for them
        bwd_ms = cuda_ms(lambda: group.group_backward(dd, idx, N), 20)
        bwd_dev_ms = queued_ms(lambda: group.group_backward(dd, idx, N), 20)
        parts = kernel_ms(lambda: group.group_backward(dd, idx, N), 10, BWD_KERNELS)
        bwd_plain_ms = cuda_ms(lambda: group.group_backward_plain(dd, idx, N), 5)
        flat = (idx.long() + N * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
        src = dd.permute(0, 2, 1, 3).reshape(B * M * ns, H).contiguous()
        acc = torch.zeros(B * N, H, device=dd.device)
        lib_ms = cuda_ms(lambda: acc.index_add_(0, flat, src), 20)
        fb, fkind = bound_ms(*group_fwd_bound(xyz, new_xyz, H, r, ns, point_ops))
        bb, bkind = bound_ms(*group_bwd_bound(B, N, M, ns, H))
        rows.append(dict(shape=shape, heavy="label" in c, bwd_device_ms=bwd_dev_ms, fwd_device_ms=fwd_dev_ms, fwd_fill_ms=fill_ms, fwd_err=fwd_abs,
                         bwd_err=float((dz - dz_plain).abs().max()), fwd_ms=fwd_ms, fwd_plain_ms=fwd_plain_ms,
                         fwd_bound=fb, fwd_by=fkind, bwd_ms=bwd_ms, bwd_plain_ms=bwd_plain_ms, lib_ms=lib_ms,
                         bwd_bound=bb, bwd_by=bkind))
        log(f"    forward {fwd_ms:.4f} ms by events around the wrapper, {fwd_dev_ms:.4f} ms on the device (calls queued "
            f"behind a busy stream), by kernel (profiler): {by_kernel(fwd_parts)} (plain {fwd_plain_ms:.4f}, a fill of D "
            f"{fill_ms:.4f}, bound {fb:.4f} {fkind}, {100 * fb / fwd_ms:.0f}% reached by events, {100 * fb / fwd_dev_ms:.0f}% on "
            f"the device)")
        if fb > min(fwd_ms, fwd_dev_ms):
            fail(f"group forward at {shape}: the kernel is faster than its bound")
        log(f"    backward {bwd_ms:.4f} ms "
            f"by events around the wrapper, {bwd_dev_ms:.4f} ms on the device (calls queued behind a busy stream); by "
            f"kernel (profiler): {by_kernel(parts)} (plain {bwd_plain_ms:.4f}, index_add_ {lib_ms:.4f}, bound {bb:.4f} "
            f"{bkind}, {100 * bb / bwd_ms:.0f}% reached by events, {100 * bb / bwd_dev_ms:.0f}% on the device)")
        if bwd_dev_ms >= lib_ms:
            log(f"    NOTE: the backward is not faster than index_add_ at {shape}")
    return rows


def median_step_ms(step, model, opt, batches):
    """Wall time of each step, from taking its batch to the device's end."""
    times = []
    it = iter(batches)
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = next(it, None)
        if batch is None:
            break
        step(model, opt, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def profile_train(step, model, opt, batch, n_steps=3):
    """A few train steps under torch.profiler: wall time, device busy and idle
    shares, and the kernels by device time."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(model, opt, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    log(f"[7] profile of {n_steps} train steps: wall {wall * 1e3 / n_steps:.1f} ms/step, device busy "
        f"{busy_us / 1e3 / n_steps:.1f} ms/step ({100 * busy_us / 1e6 / wall:.1f}% busy, "
        f"{100 - 100 * busy_us / 1e6 / wall:.1f}% idle), {sum(e.count for e in kernels) // n_steps} device "
        f"operations per step")
    if busy_us == 0:
        log("  the profiler saw no device time: busy share not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3 / n_steps:8.2f} ms/step  {e.count // n_steps:5d}x  {e.key[:90]}")
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CPU and e.self_device_time_total > 0]
    log("[7] the same steps by operator (device time of the kernels each operator launched itself):")
    for e in sorted(ops, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3 / n_steps:8.2f} ms/step  {e.count // n_steps:5d}x  {e.key[:90]}")


class FpsReplay:
    """Within the block, the FPS kernel's inputs and results are recorded; after
    ``start()``, the plain FPS returns them in the same order. Each replayed
    call also runs the plain version on the kernel's own input, which must give
    the kernel's result, and on the plain step's input, whose picks that differ
    from the kernel's are counted in ``changed`` (the discrete choice the replay
    holds fixed)."""

    def __init__(self, fps, point_ops):
        self.fps, self.point_ops = fps, point_ops
        self.kernel, self.plain = fps.furthest_point_sample, point_ops.furthest_point_sample
        self.recorded = []
        self.checked, self.changed = [], []

    def __enter__(self):
        def record(xyz, npoint):
            out = self.kernel(xyz, npoint)
            self.recorded.append((xyz.clone(), out))
            return out

        self.fps.furthest_point_sample = record
        return self

    def start(self):
        def replay(xyz, npoint):
            if not self.recorded:
                fail("FPS replay: the plain step made more FPS calls than the kernel step")
            ref_xyz, out = self.recorded.pop(0)
            if ref_xyz.shape != xyz.shape or out.shape[1] != npoint:
                fail("FPS replay: the plain step's FPS calls do not match the kernel step's")
            shape = f"{tuple(xyz.shape)}->{npoint}"
            if not torch.equal(self.plain(ref_xyz, npoint), out):
                fail(f"FPS kernel differs from its plain version at {shape} in training")
            self.checked.append(shape)
            own = out if torch.equal(ref_xyz, xyz) else self.plain(xyz, npoint)
            self.changed.append(int((own != out).sum()))
            return out

        self.fps.furthest_point_sample = self.kernel
        self.point_ops.furthest_point_sample = replay

    def __exit__(self, *exc):
        self.fps.furthest_point_sample, self.point_ops.furthest_point_sample = self.kernel, self.plain
        if exc[0] is None and self.recorded:
            fail("FPS replay: the plain step made fewer FPS calls than the kernel step")


def train_phase(cfg, device, card):
    """Phases 6 and 7. Returns the launch counts of the kernel path's 5 steps
    and phase 6's rows."""
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
    from ptt_tpu_torch.nn import build_network, set_use_kernels
    from ptt_tpu_torch.ops import fps, group, point_ops, sa
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step
    from ptt_tpu_torch.train.trainer import Trainer

    model_cfg, optim_cfg = cfg["MODEL"], cfg["OPTIMIZATION"]
    t0 = time.perf_counter()
    loader, batches = train_batches(cfg["DATA_CONFIG"], 5)
    log(f"[6] dataset {len(loader.dataset)} train items, {len(loader)} steps per epoch; 5 batches of "
        f"{TRAIN_B} built in {time.perf_counter() - t0:.1f} s")
    weights = state_dict_from_npz(ASSET)
    step = make_train_step(model_cfg, device=device)

    def fresh(use_kernels):
        model = build_network(model_cfg, device=device, train=True)
        model.load_state_dict(weights, strict=True)
        set_use_kernels(model, use_kernels)
        return model, Optimizer(model.parameters(), optim_cfg, len(loader))

    # 6. group kernels at the train step's shapes
    calls = capture_group_calls(fresh(True)[0], batches[0], device)
    if len(calls) != 7:
        fail(f"a train forward made {len(calls)} grouped_first_linear calls, not 7")
    log(f"[6] group kernels vs plain versions at the train step's shapes (B = {TRAIN_B}), rel tol forward "
        f"{GROUP_FWD_TOL}, dZ {GROUP_BWD_TOL}, input grads {GROUP_GRAD_TOL}")
    group_rows = check_group_kernels(calls + [heavy_duplication_call(calls[0])])
    del calls
    group_rows = [r for r in group_rows if not r["heavy"]]
    fwd_sums = [sum(r[k] for r in group_rows) for k in ("fwd_ms", "fwd_device_ms", "fwd_bound", "fwd_fill_ms")]
    log(f"[6] group forward, the 7 shapes summed: {fwd_sums[0]:.4f} ms by events around the wrapper, {fwd_sums[1]:.4f} ms "
        f"on the device, bound {fwd_sums[2]:.4f} ms ({100 * fwd_sums[2] / fwd_sums[0]:.0f}% reached by events, "
        f"{100 * fwd_sums[2] / fwd_sums[1]:.0f}% on the device); a fill of the 7 D tensors {fwd_sums[3]:.4f} ms; "
        f"library_ms none")
    log("[6] group backward, the 7 shapes summed: "
        f"{sum(r['bwd_ms'] for r in group_rows):.4f} ms by events around the wrapper, "
        f"{sum(r['bwd_device_ms'] for r in group_rows):.4f} ms on the device, index_add_ "
        f"{sum(r['lib_ms'] for r in group_rows):.4f} ms, bound {sum(r['bwd_bound'] for r in group_rows):.4f} ms "
        f"({100 * sum(r['bwd_bound'] for r in group_rows) / sum(r['bwd_ms'] for r in group_rows):.0f}% reached by "
        f"events, {100 * sum(r['bwd_bound'] for r in group_rows) / sum(r['bwd_device_ms'] for r in group_rows):.0f}% "
        f"on the device)")

    # 7. the training main path: 5 steps on the kernels; before each, the plain
    # path takes the same step from the same state (weights, statistics, Adam)
    # with the kernel step's FPS picks, so that a near-tie among the votes,
    # which differ by rounding, cannot make the two steps pick other points
    model, opt = fresh(True)
    same_model, same_opt = fresh(False)
    fps.launches = sa.launches = group.fwd_launches = group.bwd_launches = 0
    kernel_losses, per_step, stepwise, checked, changed = [], [], [], [], []
    for batch in batches:
        same_model.load_state_dict(model.state_dict())
        same_opt.load_state_dict(opt.state_dict())
        before = (fps.launches, group.fwd_launches, group.bwd_launches)
        with FpsReplay(fps, point_ops) as replay:
            k = step(model, opt, batch)
            replay.start()
            p = step(same_model, same_opt, batch)
        per_step.append(tuple(a - b for a, b in zip((fps.launches, group.fwd_launches, group.bwd_launches), before)))
        kernel_losses.append(float(k["loss"]))
        stepwise.append(tuple(abs(float(k[m]) - float(p[m])) / abs(float(p[m])) for m in ("loss", "grad_norm")))
        checked.append(replay.checked)
        changed.append(replay.changed)
    launches = {"fps": fps.launches, "sa": sa.launches, "group_fwd": group.fwd_launches,
                "group_bwd": group.bwd_launches}
    del same_model, same_opt
    def rel(xs, ys):
        return [f"{abs(a - b) / abs(b):.1e}" for a, b in zip(xs, ys)]

    plain_model, plain_opt = fresh(False)
    plain_losses = [float(step(plain_model, plain_opt, b)["loss"]) for b in batches]
    # witnesses for the free runs: the plain path again from the same start, and
    # from the same weights moved by one ulp each
    again_model, again_opt = fresh(False)
    again_losses = [float(step(again_model, again_opt, b)["loss"]) for b in batches]
    nudged_model, nudged_opt = fresh(False)
    with torch.no_grad():
        for prm in nudged_model.parameters():
            prm.copy_(torch.nextafter(prm, torch.full_like(prm, float("inf"))))
    nudged_losses = [float(step(nudged_model, nudged_opt, b)["loss"]) for b in batches]
    del again_model, again_opt, nudged_model, nudged_opt
    log(f"[7] 5 train steps from the trained weights, kernel path losses "
        f"{[f'{x:.6f}' for x in kernel_losses]}; the plain path from the same state with the same FPS picks "
        f"at each step, rel diff (loss, grad_norm) {[(f'{x:.1e}', f'{y:.1e}') for x, y in stepwise]}; "
        f"launches per step (fps, group fwd, group bwd) {per_step}, totals {launches}")
    log(f"[7] FPS kernel = plain on the kernel step's own input at {checked[0]} in each step; picks the plain "
        f"step's own FPS would change, per step and call: {changed}")
    log(f"[7] the plain path running free from the same start: losses {[f'{x:.6f}' for x in plain_losses]}, "
        f"rel diff to the kernel path {rel(kernel_losses, plain_losses)}")
    log(f"[7] witnesses, rel diff to that plain run: the plain path again {rel(again_losses, plain_losses)}; "
        f"from weights moved by 1 ulp {rel(nudged_losses, plain_losses)}")
    if not all(np.isfinite(kernel_losses)):
        fail("training: non-finite loss on the kernel path")
    if max(stepwise[0]) > 1e-4 or max(max(x) for x in stepwise[1:]) > 5e-3:
        fail("training: from the same state, kernel and plain steps differ beyond rel 1e-4 (step 0 loss and "
             "grad_norm) / 5e-3 (steps 1-4)")
    if any(len(c) != 2 for c in checked):
        fail(f"training: FPS held against its plain version at {checked}, not at both calls of every step")
    if any(c != (2, 7, 7) for c in per_step) or launches["sa"] != 0:
        fail(f"training: launches per step {per_step} (sa {launches['sa']}), expected (2, 7, 7) and no SA")

    # time per step: one pre-made batch, then the loader
    median_step_ms(step, model, opt, batches[:2])  # warm-up
    premade_ms = median_step_ms(step, model, opt, [batches[0]] * 20)
    loader.set_epoch(1)
    it = iter(loader)
    median_step_ms(step, model, opt, [next(it) for _ in range(2)])
    loader_ms = median_step_ms(step, model, opt, (next(it) for _ in range(20)))
    del it
    plain_ms = median_step_ms(step, plain_model, plain_opt, [batches[0]] * 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[7] train step at B = {TRAIN_B}, median of 20 after warm-up: {premade_ms:.1f} ms on one pre-made batch, "
        f"{loader_ms:.1f} ms with the loader (8 threads); plain path {plain_ms:.1f} ms; peak device memory "
        f"{peak:.1f} GiB; card {card}")
    profile_train(step, model, opt, batches[0])
    del plain_model, plain_opt

    # Trainer: one epoch on a small set, checkpoint, resume, one more step
    out_dir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    small = dict(cfg["DATA_CONFIG"], NUM_TRACKLETS=8, FRAMES_PER_TRACKLET=6)
    logger = logging.getLogger("chip_smoke")

    def trainer(total_epochs):
        net = copy.deepcopy(model)
        small_loader = DataLoader(SyntheticTrackingDataset(small), TRAIN_B, shuffle=True, drop_last=True, num_workers=8)
        return Trainer(net, model_cfg, optim_cfg, small_loader, out_dir, logger, total_epochs=total_epochs,
                       device=device)

    first = trainer(1).resume()
    first.train()
    n_iters = first.accumulated_iter
    resumed = trainer(2).resume()
    same = all(torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                                 first.model.state_dict().values()))
    metrics = resumed.train_step(resumed.model, resumed.optimizer, batches[1])
    loss = float(metrics["loss"])
    log(f"[7] Trainer: 1 epoch of {n_iters} steps, checkpoint epochs {first.ckpt.epochs()}; resumed at epoch "
        f"{resumed.start_epoch} step {resumed.accumulated_iter}, weights equal {same}; one more step loss "
        f"{loss:.4f}, optimizer count {resumed.optimizer.count}")
    shutil.rmtree(out_dir, ignore_errors=True)
    if (resumed.start_epoch, resumed.accumulated_iter) != (1, n_iters) or not same or not np.isfinite(loss) \
            or resumed.optimizer.count != n_iters + 1:
        fail("Trainer: checkpoint resume did not continue where the first run stopped")
    return launches, group_rows


# ------------------------------------------------- KITTI-format trees (phases 11, 12)

# velodyne -> camera: cam_x = -velo_y, cam_y = -velo_z, cam_z = velo_x (a
# permutation, so a label centre goes there and back exactly); R_rect identity
KITTI_V2C = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, 0.0], [1.0, 0.0, 0.0, 0.0]])
KITTI_CALIB = "\n".join([
    "P0: 700 0 600 0 0 700 180 0 0 0 1 0",
    "P1: 700 0 600 0 0 700 180 0 0 0 1 0",
    "P2: 700 0 600 44 0 700 180 0.1 0 0 1 0.003",
    "P3: 700 0 600 0 0 700 180 0 0 0 1 0",
    "R_rect 1 0 0 0 1 0 0 0 1",
    "Tr_velo_cam " + " ".join(str(v) for v in KITTI_V2C.reshape(-1)),
    "Tr_imu_velo 1 0 0 0 0 1 0 0 0 0 1 0",
])
SENSOR_HEIGHT = 1.73  # an HDL-64E's height above the ground, as on KITTI's car
DONT_CARE = "-1 DontCare -1 -1 -10 219.31 188.49 245.50 218.56 -1000 -1000 -1000 -10 -1 -1 -1"


def label_row(frame: int, track_id: int, box) -> str:
    """The KITTI label_02 row of a car with the velodyne-frame ``box``: the
    box's bottom centre in the camera frame, rotation_y = -(yaw + pi/2), every
    number at full precision."""
    w, l, h = (float(v) for v in box.wlh)
    yaw = float(np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0]))
    x, y, z = (float(v) for v in KITTI_V2C @ np.array([*box.center[:2], box.center[2] - h / 2, 1.0]))
    return f"{frame} {track_id} Car 0 0 0.0 500 150 700 300 {h!r} {w!r} {l!r} {x!r} {y!r} {z!r} {-(yaw + np.pi / 2)!r}"


def write_kitti_scene(root, scene: str, clouds, tracks: dict) -> None:
    """One scene of a KITTI tracking tree under ``root``: ``clouds`` (one (N, 3)
    array a frame) as ``training/velodyne/<scene>/<frame>.bin`` with an
    intensity column, ``tracks`` ({track_id: {frame: box}}) and a DontCare row
    a frame as ``training/label_02/<scene>.txt``, and the calibration."""
    velo = os.path.join(root, "training", "velodyne", scene)
    for sub in ("label_02", "calib"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    os.makedirs(velo, exist_ok=True)
    rows = []
    for f, pc in enumerate(clouds):
        pc = np.asarray(pc, np.float32)
        np.concatenate([pc, np.full((len(pc), 1), 0.5, np.float32)], 1).tofile(os.path.join(velo, f"{f:06}.bin"))
        rows += [label_row(f, tid, boxes[f]) for tid, boxes in tracks.items() if f in boxes]
        rows.append(f"{f} {DONT_CARE}")
    with open(os.path.join(root, "training", "label_02", f"{scene}.txt"), "w") as fh:
        fh.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "training", "calib", f"{scene}.txt"), "w") as fh:
        fh.write(KITTI_CALIB + "\n")


def sweep_scene(rng, n_frames: int, track_frames, n_points: int = 120_000):
    """A scene at KITTI's frame size: ``n_frames`` sweeps of ``n_points`` points
    each from 64 beams (elevations -24.8 to +2 degrees, as an HDL-64E's) over
    the ground plane and walls, with car k driving on a circle around the
    sensor in frames 0 .. track_frames[k] - 1, its visible faces sampled at a
    density that falls with range, and poles around it.
    Returns (clouds, {k: {frame: box}})."""
    from ptt_tpu_torch.core.geometry import Box, Quaternion
    from ptt_tpu_torch.data.synthetic import _sample_box_surface

    n_beams = 64
    elev = np.deg2rad(np.linspace(-24.8, 2.0, n_beams))
    n_az = n_points // n_beams
    cars = [dict(radius=8.0 + 4.0 * k, angle=rng.uniform(-np.pi, np.pi), step=rng.uniform(0.2, 0.35),
                 wlh=np.array([1.8, 4.4, 1.6]) * rng.uniform(0.9, 1.1, 3)) for k in range(len(track_frames))]
    clouds, tracks = [], {k: {} for k in range(len(track_frames))}
    for f in range(n_frames):
        az = (np.arange(n_az) / n_az * 2 * np.pi + rng.uniform(0, 2 * np.pi / n_az))[None, :]
        el = elev[:, None] + rng.normal(0, 1e-3, (n_beams, n_az))
        ground = el < -0.02
        rng_m = np.where(ground, SENSOR_HEIGHT / np.tan(-np.minimum(el, -0.02)), rng.uniform(20, 60, el.shape))
        rng_m = np.minimum(rng_m, 120.0) + rng.normal(0, 0.02, el.shape)
        pts = np.stack([rng_m * np.cos(el) * np.cos(az), rng_m * np.cos(el) * np.sin(az),
                        np.where(ground, -SENSOR_HEIGHT, rng_m * np.sin(el))], -1).reshape(-1, 3)
        extra = []
        for k, car in enumerate(cars):
            if f >= track_frames[k]:
                continue
            theta = car["angle"] + f * car["step"] / car["radius"]
            center = [car["radius"] * np.cos(theta), car["radius"] * np.sin(theta), -SENSOR_HEIGHT + car["wlh"][2] / 2]
            box = Box(center, car["wlh"], Quaternion(axis=[0, 0, 1], angle=theta + np.pi / 2))
            tracks[k][f] = box
            extra.append(_sample_box_surface(rng, box, int(min(3000, 60000 / car["radius"] ** 2))))
            poles = box.center[:2] + rng.uniform(-6, 6, (20, 2))
            extra.append(np.column_stack([np.repeat(poles, 10, 0), rng.uniform(-SENSOR_HEIGHT, 1.0, 200)]))
        extra = np.concatenate(extra) if extra else np.zeros((0, 3))
        keep = rng.choice(len(pts), n_points - len(extra), replace=False)
        clouds.append(np.concatenate([pts[keep], extra]).astype(np.float32))
    return clouds, tracks


NUSCENES_TABLES = ("scene", "sample", "sample_data", "sample_annotation", "instance", "ego_pose",
                   "calibrated_sensor", "category", "log")


def write_nuscenes_tree(root, tracklets, category: str = "vehicle.trailer", version: str = "v1.0-trainval") -> None:
    """Tracklets as a nuScenes release under ``root``: tracklet t is scene t of
    the 'val' split (the test split of nuscenes_models/ptt.yaml), one instance
    of ``category`` with an annotation a frame chained by ``next``, and a
    LIDAR_TOP sweep a frame (x, y, z, intensity, ring rows); the sensor and
    ego poses are the identity, so the dataset reads back the same clouds and
    boxes."""
    from ptt_tpu_torch.data.nuscenes_splits import get_split_scenes

    scenes = get_split_scenes("val")
    os.makedirs(os.path.join(root, version), exist_ok=True)
    os.makedirs(os.path.join(root, "samples", "LIDAR_TOP"), exist_ok=True)
    identity = {"translation": [0.0, 0.0, 0.0], "rotation": [1.0, 0.0, 0.0, 0.0]}
    tables = {name: [] for name in NUSCENES_TABLES}
    tables["log"].append({"token": "log0"})
    tables["category"].append({"token": "cat0", "name": category})
    tables["calibrated_sensor"].append(dict(identity, token="cs0"))
    tables["ego_pose"].append(dict(identity, token="ego0"))
    for t, (pcs, boxes, _) in enumerate(tracklets):
        tables["scene"].append({"token": f"scene{t}", "name": scenes[t], "log_token": "log0"})
        annos = [f"anno{t}_{f}" for f in range(len(pcs))]
        for f, (pc, box) in enumerate(zip(pcs, boxes)):
            fname = f"samples/LIDAR_TOP/{scenes[t]}_{f:03d}.bin"
            scan = np.zeros((len(pc), 5), np.float32)
            scan[:, :3] = pc
            scan.tofile(os.path.join(root, fname))
            tables["sample_data"].append({"token": f"sd{t}_{f}", "sample_token": f"sample{t}_{f}", "filename": fname,
                                          "ego_pose_token": "ego0", "calibrated_sensor_token": "cs0",
                                          "is_key_frame": True})
            tables["sample"].append({"token": f"sample{t}_{f}", "scene_token": f"scene{t}", "timestamp": 1000 * f,
                                     "data": {"LIDAR_TOP": f"sd{t}_{f}"}})
            tables["sample_annotation"].append({
                "token": annos[f], "sample_token": f"sample{t}_{f}", "instance_token": f"inst{t}",
                "translation": [float(x) for x in box.center], "size": [float(x) for x in box.wlh],
                "rotation": [float(x) for x in box.orientation.elements], "num_lidar_pts": len(pc),
                "prev": annos[f - 1] if f else "", "next": annos[f + 1] if f + 1 < len(pcs) else ""})
        tables["instance"].append({"token": f"inst{t}", "category_token": "cat0", "first_annotation_token": annos[0],
                                   "nbr_annotations": len(pcs)})
    for name, rows in tables.items():
        with open(os.path.join(root, version, f"{name}.json"), "w") as fh:
            json.dump(rows, fh)


def run_cli(module: str, args, timeout: float = 600):
    """Run ``python3 -m ptt_tpu_torch.tools.<module> args`` from the repo root and
    return (its ``summary`` record, wall seconds, its log). Fails the run when
    the CLI fails."""
    cmd = [sys.executable, "-m", f"ptt_tpu_torch.tools.{module}", *map(str, args)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    text = out.stdout + out.stderr
    if out.returncode != 0:
        log(text[-4000:])
        fail(f"{module} {' '.join(map(str, args))} exited with {out.returncode}")
    records = [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]
    if not records:
        fail(f"{module}: no summary line in its log")
    return records[-1], wall, text


def result_file(extra_tag: str, eval_tag: str = "default", epoch=None) -> str:
    base = os.path.join(REPO, "output", "kitti_models", "ptt", extra_tag, "eval", eval_tag)
    return os.path.join(base, *([f"epoch_{epoch}"] if epoch is not None else []), "final_result", "data",
                        "track_result.txt")


def line_count(path) -> int:
    with open(path) as fh:
        return sum(1 for _ in fh)


def resample_rows_check(cfg, model, root, device):
    """Phase 11b: the first frame step of the first batch at max_points 16384,
    in this process: the device's resampled rows (search, and the
    firstandprevious template over the 32,768-row union) against
    ``masked_resample`` on the CPU given the same picks."""
    from ptt_tpu_torch.data.kitti import KittiTrackingDataset
    from ptt_tpu_torch.eval import device_loop as dl

    data_cfg = dict(cfg["DATA_CONFIG"], DATA_PATH=root)
    ds = KittiTrackingDataset(data_cfg, cfg["CLASS_NAMES"], training=False)
    first = [(pcs[:2], boxes[:2], annos[:2]) for pcs, boxes, annos in (ds[i] for i in range(len(ds)))]
    orig, seen = dl.masked_resample, []

    def recording(pts, mask, n_out, generator=None, picks=None):
        if picks is None:
            picks = dl.uniform_picks(mask.sum(-1), n_out, generator)
        out = orig(pts, mask, n_out, picks=picks)
        if len(seen) < 2:
            seen.append((pts.shape[1], out[0].cpu(), orig(pts.cpu(), mask.cpu(), n_out, picks=picks.cpu())[0]))
        return out

    dl.masked_resample = recording
    try:
        dl.DeviceTrackingEvaluator(cfg, model, max_points=16384, batch_size=8, device=device).track_batch(first)
    finally:
        dl.masked_resample = orig
    rows = [n for n, _, _ in seen]
    same = [torch.equal(a, b) for _, a, b in seen]
    log(f"[11b] first frame step at max_points 16384: masked_resample over {rows} rows (search, template union), "
        f"device rows equal to the CPU's from the same picks {same}")
    if rows != [16384, 32768] or not all(same):
        fail("[11b] the device's resampled rows differ from masked_resample on the CPU, or the rows are not "
             "16384 and 32768")


def kitti_test_phase(agreement, phase10, model, device, card, tmp):
    """Phase 11: the test CLI, as a subprocess, on KITTI-format trees written
    under ``tmp``: (a) the agreement tracklets, against phase 10's numbers; (b)
    a 150-frame scene of 120,000-point sweeps at the default max_points, left
    in ``tmp/sweeps`` for phase 13b."""
    from ptt_tpu_torch.config import ptt_config

    try:
        root = os.path.join(tmp, "agreement")
        for i, (pcs, boxes, _) in enumerate(agreement):
            write_kitti_scene(root, f"{i:04d}", pcs, {i: dict(enumerate(boxes))})
        frames = sum(len(t[0]) for t in agreement)
        base = ["--ckpt", ASSET, "--max_points", 1024, "--extra_tag", "chip_smoke_11a"]
        sets = ["--set", "DATA_CONFIG.DATA_PATH", root, "DATA_CONFIG.DATA_SPLIT", "test:all"]
        got = {}
        for path, flags in (("device", ["--eval_tag", "device"]), ("host", ["--host_loop", "--eval_tag", "host"])):
            rec, wall, _ = run_cli("test_tracking", base + flags + sets)
            got[path] = rec
            (ref_s, ref_p), lines = phase10[path], line_count(result_file("chip_smoke_11a", path))
            log(f"[11a] test CLI ({path} path) on the agreement tracklets as KITTI scenes 0000-0007: Success "
                f"{rec['success']:.2f} Precision {rec['precision']:.2f}, phase 10 {ref_s:.2f}/{ref_p:.2f} (delta "
                f"{rec['success'] - ref_s:+.2f}/{rec['precision'] - ref_p:+.2f}); {lines} lines of track_result.txt; "
                f"launches {rec['launches']}; CLI wall {wall:.1f} s; card {card}")
            if not (abs(rec["success"] - ref_s) <= 1.0 and abs(rec["precision"] - ref_p) <= 1.0):
                fail(f"[11a] the test CLI's {path} path is not within 1.0 of phase 10's")
            if lines != frames:
                fail(f"[11a] track_result.txt holds {lines} lines, not {frames}")
        steps = 31
        if got["device"]["launches"]["fps"] != 2 * steps or got["device"]["launches"]["sa"] != 7 * steps:
            fail(f"[11a] device path launches {got['device']['launches']}, not 2 and 7 per step over {steps} steps")

        # (b) KITTI's frame size: scene 0019, 150 sweeps, cars of 40, 80, 120, 150 frames
        root = os.path.join(tmp, "sweeps")
        t0 = time.perf_counter()
        clouds, tracks = sweep_scene(np.random.default_rng(19), 150, [40, 80, 120, 150])
        write_kitti_scene(root, "0019", clouds, tracks)
        n_pts = [len(c) for c in clouds]
        log(f"[11b] scene 0019 written: 150 frames of {min(n_pts)}-{max(n_pts)} points "
            f"({os.path.getsize(os.path.join(root, 'training', 'velodyne', '0019', '000000.bin'))} bytes a .bin), "
            f"4 cars of 40, 80, 120, 150 frames, in {time.perf_counter() - t0:.1f} s")
        del clouds
        runs = []
        for run in ("run1", "run2"):
            rec, wall, _ = run_cli("test_tracking", ["--ckpt", ASSET, "--batch_size", 8, "--extra_tag",
                                                     "chip_smoke_11b", "--eval_tag", run, "--set",
                                                     "DATA_CONFIG.DATA_PATH", root])
            runs.append(rec)
            db = [n for n in os.listdir(root) if n.endswith("_torch.pkl")]
            db_bytes = sum(os.path.getsize(os.path.join(root, n)) for n in db)
            log(f"[11b] test CLI {run} ({'builds' if run == 'run1' else 'reads'} the database) at max_points 16384, "
                f"batch 8: Success {rec['success']:.2f} Precision {rec['precision']:.2f}, "
                f"{rec['frames_per_s']:.1f} frames/s, dataset {rec['dataset_seconds']:.1f} s, CLI wall {wall:.1f} s; "
                f"database {db} {db_bytes} bytes; launches {rec['launches']} over 159 frame steps "
                f"({rec['launches']['fps'] / 159:g} FPS + {rec['launches']['sa'] / 159:g} SA a step); card {card}")
        steps = 160 - 1  # 150 frames pad to the 160-frame bucket
        for rec in runs:
            if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
                fail(f"[11b] launches {rec['launches']}, not 2 FPS and 7 SA per step over {steps} steps")
        with open(result_file("chip_smoke_11b", "run1")) as a, open(result_file("chip_smoke_11b", "run2")) as b:
            same = a.read() == b.read()
        log(f"[11b] the two runs' boxes (track_result.txt, {line_count(result_file('chip_smoke_11b', 'run1'))} "
            f"lines) equal: {same}")
        if not same:
            fail("[11b] the first batch's boxes differ between the two runs")
        resample_rows_check(ptt_config(), model, root, device)
    finally:
        for tag in ("chip_smoke_11a", "chip_smoke_11b"):
            shutil.rmtree(os.path.join(REPO, "output", "kitti_models", "ptt", tag), ignore_errors=True)


def kitti_train_phase(model, batch, device, card):
    """Phase 12: the train CLI at B = 48 on scene 0000 (4 cars x 60 frames of
    120,000 points) from the trained asset, one epoch and then a resumed
    second, TRAIN.WITH_EVAL on a shorter scene 0019; ``--eval_all`` over the
    two checkpoints; and a reference-layout .pth loaded with ``--ckpt``'s
    loader, against the asset loaded from the .npz."""
    import tempfile

    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.convert import reference_state_dict, state_dict_from_npz
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.checkpoint import load_params_from_file

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    run_dir = os.path.join(REPO, "output", "kitti_models", "ptt", "chip_smoke_12")
    try:
        root = os.path.join(tmp, "train")
        rng = np.random.default_rng(12)
        write_kitti_scene(root, "0000", *sweep_scene(rng, 60, [60, 60, 60, 60]))
        write_kitti_scene(root, "0019", *sweep_scene(rng, 40, [30, 40]))
        sets = ["--set", "DATA_CONFIG.DATA_PATH", root, "TRAIN.WITH_EVAL.ENABLE", "True",
                "TRAIN.WITH_EVAL.START_EPOCH", "0"]
        runs = []
        for epochs in (1, 2):
            rec, wall, _ = run_cli("train_tracking", ["--pretrained_model", ASSET, "--epochs", epochs, "--workers", 8,
                                                      "--extra_tag", "chip_smoke_12", *sets])
            runs.append(rec)
            n = rec["steps"][1] - rec["steps"][0]
            ev = rec["eval"].get(str(epochs), {})
            log(f"[12] train CLI --epochs {epochs}: epochs {rec['epochs']}, steps {rec['steps']}, checkpoints "
                f"{rec['checkpoints']}; {1e3 * rec['train_seconds'] / max(n, 1):.1f} ms a step with the KITTI loader "
                f"(8 threads, checkpoint included); launches {rec['launches']} "
                f"({ {k: v / max(n, 1) for k, v in rec['launches'].items()} } a step); WITH_EVAL Success "
                f"{ev.get('success', float('nan')):.2f} Precision {ev.get('precision', float('nan')):.2f} "
                f"at {ev.get('frames_per_s', float('nan')):.1f} frames/s; CLI wall {wall:.1f} s; card {card}")
            if rec["epochs"] != [epochs - 1, epochs] or rec["checkpoints"] != list(range(1, epochs + 1)):
                fail(f"[12] --epochs {epochs}: epochs {rec['epochs']}, checkpoints {rec['checkpoints']}")
            if rec["launches"] != {"fps": 2 * n, "sa": 0, "group_fwd": 7 * n, "group_bwd": 7 * n} or n != 20:
                fail(f"[12] {n} steps with launches {rec['launches']}, not 20 steps of 2 FPS + 7 + 7 group")
            if str(epochs) not in rec["eval"]:
                fail(f"[12] TRAIN.WITH_EVAL did not score epoch {epochs}")
        if runs[1]["steps"][0] != runs[0]["steps"][1]:
            fail(f"[12] the resumed run starts at step {runs[1]['steps'][0]}, not {runs[0]['steps'][1]}")
        rec, wall, _ = run_cli("test_tracking", ["--eval_all", "--ckpt_dir", os.path.join(run_dir, "ckpt"),
                                                 "--max_waiting_mins", 0, "--extra_tag", "chip_smoke_12",
                                                 "--set", "DATA_CONFIG.DATA_PATH", root])
        with open(os.path.join(run_dir, "eval", "default", "eval_list.txt")) as fh:
            evals = fh.read().splitlines()
        log(f"[12] test CLI --eval_all: eval_list.txt {evals}; launches {rec['launches']}; CLI wall {wall:.1f} s; "
            f"card {card}")
        if [line.split()[0] for line in evals] != ["1", "2"]:
            fail("[12] --eval_all did not evaluate checkpoints 1 and 2 once each")

        ref_path = os.path.join(tmp, "reference.pth")
        torch.save({"model_state": reference_state_dict(state_dict_from_npz(ASSET)), "epoch": 0}, ref_path)
        from_pth = build_network(ptt_config()["MODEL"], device=device)
        load_params_from_file(ref_path, from_pth, strict=True)
        with torch.no_grad():
            a, b = from_pth(batch)["pred_box_data"], model(batch)["pred_box_data"]
        log(f"[12] a reference-layout .pth of the asset, loaded strict as --ckpt loads it: forward bit-equal to the "
            f"asset's from the .npz {torch.equal(a, b)}")
        if not torch.equal(a, b):
            fail("[12] the reference-layout .pth does not give the .npz's forward")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(run_dir, ignore_errors=True)


# ------------------------------------------------------ ptt_waymo, bf16, optimizers, nuScenes (phases 13-16)


def waymo_cli_phase(root, card):
    """Phase 13b: the test CLI with ptt_waymo.yaml on phase 11b's scene 0019
    (150 sweeps of 120,000 points, max_points 16384, seeded init)."""
    steps = 160 - 1
    rec, wall, text = run_cli("test_tracking", ["--cfg_file", "tools/cfgs/kitti_models/ptt_waymo.yaml", "--batch_size", 8,
                                                "--extra_tag", "chip_smoke_13b", "--set", "DATA_CONFIG.DATA_PATH", root])
    log(f"[13b] test CLI ptt_waymo.yaml on scene 0019 (150 x 120,000-point sweeps, max_points 16384, batch 8, "
        f"seeded init): {rec['frames_per_s']:.1f} frames/s, Success {rec['success']:.2f} Precision "
        f"{rec['precision']:.2f} (seeded weights: not a gate), CLI wall {wall:.1f} s; launches {rec['launches']} over "
        f"{steps} frame steps; the one-device POINT_SHARDING line logged "
        f"{'the point axis' in text and 'is not split' in text}; card {card}")
    if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
        fail(f"[13b] launches {rec['launches']}, not 2 FPS and 7 SA per step over {steps} steps")
    if not ("the point axis" in text and "is not split" in text):
        fail("[13b] the test CLI did not log that POINT_SHARDING splits nothing on one device")
    shutil.rmtree(os.path.join(REPO, "output", "kitti_models", "ptt_waymo"), ignore_errors=True)


def waymo_train_phase(device, card):
    """Phase 14: ptt_waymo.yaml training at B = 48 on synthetic items resampled
    to 8192 / 2048 points, on the port's seeded init: the group kernels at the 7
    shapes of its step and a heavy-duplication cloud, then steps: launches, ms
    a step, peak memory. Returns phase 6's rows at these shapes."""
    from ptt_tpu_torch.config import config_by_path, ptt_synth_config
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.ops import fps, group, sa
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step

    cfg = config_by_path("kitti_models/ptt_waymo.yaml")
    data_cfg = dict(ptt_synth_config()["DATA_CONFIG"], SEARCH_INPUT_SIZE=8192, TEMPLATE_INPUT_SIZE=2048)
    t0 = time.perf_counter()
    loader, batches = train_batches(data_cfg, 3)
    log(f"[14] ptt_waymo.yaml training, B = {TRAIN_B}: 3 batches of synthetic items resampled to 8192 / 2048 points "
        f"built in {time.perf_counter() - t0:.1f} s; the port's init from torch.manual_seed({SEED})")

    def fresh():
        torch.manual_seed(SEED)
        return build_network(cfg["MODEL"], device=device, train=True)

    calls = capture_group_calls(fresh(), batches[0], device)
    if len(calls) != 7:
        fail(f"[14] a ptt_waymo train forward made {len(calls)} grouped_first_linear calls, not 7")
    log(f"[14] group kernels vs plain versions at ptt_waymo's train shapes (B = {TRAIN_B}); CSR ranges of the "
        f"backward at N = 8192: {group.kernel_csr_ranges(8192)} (ops/group.py says {group.csr_ranges(8192)})")
    if group.kernel_csr_ranges(8192) != group.csr_ranges(8192) or \
            group.kernel_csr_ranges(group.BACKWARD_MAX_POINTS + 1) != 0:
        fail("[14] csrc/group.cu's CSR ranges differ from ops/group.py's")
    rows = check_group_kernels(calls + [heavy_duplication_call(calls[0])])
    del calls
    rows = [r for r in rows if not r["heavy"]]

    model = fresh()
    opt = Optimizer(model.parameters(), ptt_synth_config()["OPTIMIZATION"], len(loader))
    step = make_train_step(cfg["MODEL"], device=device)
    torch.cuda.reset_peak_memory_stats()
    fps.launches = sa.launches = group.fwd_launches = group.bwd_launches = 0
    losses = [float(step(model, opt, b)["loss"]) for b in batches]
    launches = {"fps": fps.launches, "sa": sa.launches, "group_fwd": group.fwd_launches, "group_bwd": group.bwd_launches}
    ms = median_step_ms(step, model, opt, [batches[0]] * 5)
    peak = torch.cuda.max_memory_allocated()
    log(f"[14] ptt_waymo train steps at B = {TRAIN_B}: losses {[f'{x:.4f}' for x in losses]}; launches {launches} "
        f"over 3 steps; {ms:.1f} ms a step on one pre-made batch (median of 5); peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); card {card}")
    if not all(np.isfinite(losses)):
        fail("[14] ptt_waymo training: non-finite loss")
    if launches != {"fps": 6, "sa": 0, "group_fwd": 21, "group_bwd": 21}:
        fail(f"[14] ptt_waymo training launches {launches}, not 2 FPS and 7 + 7 group a step")
    del model, opt
    torch.cuda.empty_cache()
    return rows


OPTIMIZER_RUNS = ("adam", "adamw", "sgd", "adam_onecycle")


def phase15_cli_jobs() -> dict:
    """Phase 15's train CLI runs, name -> (arguments, --set pairs): 4 steps of
    B = 48 each (8 tracklets x 6 frames); p2b_synth_strong.yaml as the file
    sets it (bf16), ptt_synth.yaml once per OPTIMIZER. WEIGHT_DECAY stays the
    file's integer 0 (``--set`` keeps a key's type, as the JAX package's does),
    so adamw steps as adam does here; the CPU lockstep covers weight decay."""
    small = ["DATA_CONFIG.NUM_TRACKLETS", "8", "DATA_CONFIG.FRAMES_PER_TRACKLET", "6", "TRAIN.WITH_EVAL.ENABLE", "False"]
    jobs = {"p2b_synth_strong": (["--cfg_file", "tools/cfgs/synthetic_models/p2b_synth_strong.yaml"], small)}
    for name in OPTIMIZER_RUNS:
        jobs[name] = (["--cfg_file", "tools/cfgs/synthetic_models/ptt_synth.yaml"], small + ["OPTIMIZATION.OPTIMIZER", name])
    return jobs
# Kernel path against plain path, one bf16 step from the same state with the same
# FPS picks, relative to the plain step. The kernel path's stages compute in
# float32 after grouped_first_linear, the plain path's in bf16 (as the JAX
# package's two paths do), so they part by bf16 rounding, not by float32's 1e-4.
# BF16_PATHS_RTOL is the band stated in PERF.md before the first run, reported
# beside the reading; the phase fails beyond BF16_FAULT_RTOL, the size of a
# fault (a lost cast or gradient moves the step by O(1)), not of bf16 rounding
# on a trained model whose loss is ~0.007 and gradient norm ~0.08.
BF16_PATHS_RTOL = 5e-2
BF16_FAULT_RTOL = 0.2


def bf16_phase(device, card):
    """Phase 15: one bf16 train step on the kernel path and one on the plain
    path from the same state with the kernel's FPS picks; bf16 and float32
    step times alternated; the train CLI on p2b_synth_strong.yaml (bf16 from
    the file) and on ptt_synth.yaml once per optimizer, subprocesses side by
    side."""
    from concurrent.futures import ThreadPoolExecutor

    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.nn import build_network, set_use_kernels
    from ptt_tpu_torch.ops import fps, point_ops
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step

    cfg = ptt_synth_config()
    loader, batches = train_batches(cfg["DATA_CONFIG"], 1, seed=15)
    weights = state_dict_from_npz(ASSET)

    def fresh(use_kernels):
        model = build_network(cfg["MODEL"], device=device, train=True)
        model.load_state_dict(weights, strict=True)
        set_use_kernels(model, use_kernels)
        return model, Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader))

    step16 = make_train_step(cfg["MODEL"], device=device, mixed_precision=True)
    step32 = make_train_step(cfg["MODEL"], device=device)
    (mk, ok), (mp, op) = fresh(True), fresh(False)
    with FpsReplay(fps, point_ops) as replay:
        k = step16(mk, ok, batches[0])
        replay.start()
        p = step16(mp, op, batches[0])
    m32, o32 = fresh(True)
    f = step32(m32, o32, batches[0])
    rel = {m: abs(float(k[m]) - float(p[m])) / abs(float(p[m])) for m in ("loss", "grad_norm")}
    to_f32 = {m: abs(float(k[m]) - float(f[m])) / abs(float(f[m])) for m in ("loss", "grad_norm")}
    master = all(t.dtype == torch.float32 for t in list(mk.parameters()) + ok.mu + ok.nu)
    log(f"[15] one bf16 step of ptt_synth.yaml from the trained asset, B = {TRAIN_B}: kernel path loss "
        f"{float(k['loss']):.6f} grad_norm {float(k['grad_norm']):.4f}, plain path with the kernel's FPS picks "
        f"{float(p['loss']):.6f} / {float(p['grad_norm']):.4f}: rel diff {rel['loss']:.2e} / {rel['grad_norm']:.2e} "
        f"(stated band {BF16_PATHS_RTOL}: {'held' if max(rel.values()) <= BF16_PATHS_RTOL else 'missed'}; fault "
        f"threshold {BF16_FAULT_RTOL}); the float32 kernel step {float(f['loss']):.6f} / {float(f['grad_norm']):.4f}, "
        f"rel diff to it {to_f32['loss']:.2e} / {to_f32['grad_norm']:.2e}; FPS = plain on the kernel's input at "
        f"{replay.checked}, picks the plain step's own FPS would change {replay.changed}; master parameters and "
        f"optimizer state float32 {master}")
    if max(rel.values()) > BF16_FAULT_RTOL or not np.isfinite(float(k["loss"])) or not master:
        fail("[15] the bf16 kernel and plain steps part by a fault's size, or the master state left float32")

    median_step_ms(step16, mk, ok, [batches[0]] * 2)
    median_step_ms(step32, m32, o32, [batches[0]] * 2)
    times = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        model, opt, step = (m32, o32, step32) if name == "f32" else (mk, ok, step16)
        times[name].append(median_step_ms(step, model, opt, [batches[0]] * 10))
    log(f"[15] train step at B = {TRAIN_B} on one pre-made batch, medians of 10, alternated f32, bf16, bf16, f32: "
        f"f32 {', '.join(f'{t:.1f}' for t in times['f32'])} ms, bf16 {', '.join(f'{t:.1f}' for t in times['bf16'])} ms; "
        f"card {card}")
    del mk, ok, mp, op, m32, o32
    torch.cuda.empty_cache()

    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(run_cli, "train_tracking", args + ["--pretrained_model", ASSET] * (name in OPTIMIZER_RUNS)
                                     + ["--epochs", 1, "--workers", 4, "--extra_tag", f"chip_smoke_15_{name}", "--set",
                                        *sets]) for name, (args, sets) in phase15_cli_jobs().items()}
        results = {name: fut.result() for name, fut in futures.items()}
    for name, (rec, wall, text) in results.items():
        losses = [float(line.split("  loss ", 1)[1].split()[0]) for line in text.splitlines() if "  loss " in line]
        precision = "bf16" if "mixed_precision=bf16" in text else "f32"
        n = rec["steps"][1] - rec["steps"][0]
        log(f"[15] train CLI {name}: {n} steps at B = {TRAIN_B}, {precision}, epoch loss {losses}, "
            f"{1e3 * rec['train_seconds'] / max(n, 1):.1f} ms a step (3 runs side by side), launches {rec['launches']}, "
            f"CLI wall {wall:.1f} s")
        if n < 1 or not losses or not all(np.isfinite(losses)):
            fail(f"[15] the train CLI with {name} did not train finite steps")
        if precision != ("f32" if name in OPTIMIZER_RUNS else "bf16"):
            fail(f"[15] the train CLI with {name} trained in {precision}")
        if name in OPTIMIZER_RUNS and f"optimizer={name} " not in text:
            fail(f"[15] the train CLI run for {name} did not log optimizer={name}")
    for tag in ("p2b_synth_strong", "ptt_synth"):
        shutil.rmtree(os.path.join(REPO, "output", "synthetic_models", tag), ignore_errors=True)


def nuscenes_phase(agreement, phase10, card):
    """Phase 16: the agreement tracklets as a nuScenes release, scored by the
    test CLI on nuscenes_models/ptt.yaml with the trained asset; within 1.0 of
    phase 10's device numbers."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nuscenes_")
    try:
        write_nuscenes_tree(tmp, agreement)
        rec, wall, _ = run_cli("test_tracking", ["--cfg_file", "tools/cfgs/nuscenes_models/ptt.yaml", "--ckpt", ASSET,
                                                 "--max_points", 1024, "--extra_tag", "chip_smoke_16", "--set",
                                                 "DATA_CONFIG.DATA_PATH", tmp])
        ref_s, ref_p = phase10["device"]
        steps = 31
        log(f"[16] test CLI nuscenes_models/ptt.yaml on the agreement tracklets as a nuScenes release (8 val "
            f"scenes, class trailer): Success {rec['success']:.2f} Precision {rec['precision']:.2f}, phase 10 "
            f"{ref_s:.2f}/{ref_p:.2f} (delta {rec['success'] - ref_s:+.2f}/{rec['precision'] - ref_p:+.2f}); "
            f"dataset {rec['dataset_seconds']:.1f} s; launches {rec['launches']}; CLI wall {wall:.1f} s; card {card}")
        if not (abs(rec["success"] - ref_s) <= 1.0 and abs(rec["precision"] - ref_p) <= 1.0):
            fail("[16] the nuScenes test CLI is not within 1.0 of phase 10's")
        if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
            fail(f"[16] launches {rec['launches']}, not 2 and 7 per step over {steps} steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.join(REPO, "output", "nuscenes_models"), ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.config import config_by_path, p2b_synth_config, ptt_config, ptt_large_config, ptt_synth_config
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
    clock = fps_clock(device)
    rows = check_kernels(calls, clock)
    summary = {name: dict(launches_per_frame=len(rs), max_abs_err=max(r["err"] for r in rs),
                          ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
                          bound_ms=sum(r["bound_ms"] for r in rs))
               for name, rs in rows.items()}
    for name in summary:
        summary[name]["device_ms"] = sum(r["device_ms"] for r in rows[name])
    log("kernels " + json.dumps(summary))

    # 3. whole forward, kernel path against plain path
    check_forward(model, batch, "[3]", trained=True)

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

    bench = bench_tracklets()
    ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device)
    n_frames = sum(len(t[0]) for t in bench)
    bench_rate(ev, bench, 1)  # warm-up
    rates = [bench_rate(ev, bench, 4) for _ in range(3)]
    set_use_kernels(model, False)
    plain_rate = bench_rate(ev, first_frames(bench, 32), 1)
    set_use_kernels(model, True)
    log(f"[4] throughput, 8 x 64-frame tracklets, 4 pipelined batches per run: "
        f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f}); "
        f"plain path {plain_rate:.1f} frames/s (one batch cut to 32 frames); card {card}")
    profile_batch(ev, bench, n_frames)
    del ev
    torch.cuda.empty_cache()

    # 6 and 7: the training path
    train_launches, group_rows = train_phase(ptt_synth_config(), device, card)

    # 8 and 9: ptt_large.yaml and p2b_synth.yaml at full width
    check_sa_limit(device)
    large_rows, large_launches = config_phase("[8]", "ptt_large.yaml", ptt_large_config(), device, card, clock, 2,
                                              agreement, bench)
    p2b_rows, p2b_launches = config_phase("[9]", "p2b_synth.yaml (P2B)", p2b_synth_config(), device, card, clock, 1,
                                          agreement, bench)

    # 10. every tracking mode and the host evaluator on the trained weights
    phase10 = modes_phase(cfg, model, meta, agreement, device)

    # 11 and 12: the CLIs on KITTI-format trees; 13 to 16: ptt_waymo, bf16 and the optimizers, nuScenes
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    try:
        kitti_test_phase(agreement, phase10, model, device, card, tmp)
        kitti_train_phase(model, batch, device, card)
        del model
        torch.cuda.empty_cache()
        waymo_rows, waymo_launches = config_phase("[13]", "ptt_waymo.yaml", config_by_path("kitti_models/ptt_waymo.yaml"),
                                                  device, card, clock, 2, agreement, bench)
        waymo_cli_phase(os.path.join(tmp, "sweeps"), card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    waymo_group_rows = waymo_train_phase(device, card)
    bf16_phase(device, card)
    nuscenes_phase(agreement, phase10, card)

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
        record["kernels"][-1]["device_ms"] = summary[name]["device_ms"]
        record["kernels"][-1]["launches_by_path"] = {
            "ptt.yaml tracker (agreement batch)": launches[name],
            "ptt_large.yaml tracker (benchmark batch)": large_launches[name],
            "p2b_synth.yaml tracker (benchmark batch)": p2b_launches[name],
            "ptt_waymo.yaml tracker (benchmark batch)": waymo_launches[name]}
        record["kernels"][-1]["shapes"] = [
            {"config": config, **{k: r[k] for k in ("shape", "err", "ms", "device_ms", "plain_ms", "bound_ms", "bound_by")}}
            for config, rs_ in (("ptt.yaml", rs), ("ptt_large.yaml", large_rows[name]), ("p2b_synth.yaml", p2b_rows[name]),
                                ("ptt_waymo.yaml", waymo_rows[name]))
            for r in rs_]
        if name == "fps":
            record["kernels"][-1].update(bound_term=max(rs, key=lambda r: r["bound_ms"])["bound_term"],
                                         rate_bound_ms=sum(r["rate_bound_ms"] for r in rs))
    for name, replaces, pre in (("group_fwd", "ptt_tpu/ops/pallas_group.py:65", "fwd"),
                                ("group_bwd", "ptt_tpu/ops/pallas_group.py:98", "bwd")):
        record["kernels"].append({
            "name": name, "route": "cuda", "source": "ptt_tpu_torch/csrc/group.cu", "replaces": replaces,
            "launches": train_launches[name], "max_abs_err": max(r[f"{pre}_err"] for r in group_rows),
            "ms": sum(r[f"{pre}_ms"] for r in group_rows), "plain_ms": sum(r[f"{pre}_plain_ms"] for r in group_rows),
            "bound_ms": sum(r[f"{pre}_bound"] for r in group_rows),
            "bound_by": max(group_rows, key=lambda r: r[f"{pre}_bound"])[f"{pre}_by"],
            "library_ms": sum(r["lib_ms"] for r in group_rows) if pre == "bwd" else None,
        })
        record["kernels"][-1]["device_ms"] = sum(r[f"{pre}_device_ms"] for r in group_rows)
        record["kernels"][-1]["shapes"] = [
            {"config": config, "shape": r["shape"], "err": r[f"{pre}_err"], "ms": r[f"{pre}_ms"],
             "device_ms": r[f"{pre}_device_ms"], "plain_ms": r[f"{pre}_plain_ms"], "bound_ms": r[f"{pre}_bound"],
             "bound_by": r[f"{pre}_by"], **({"library_ms": r["lib_ms"]} if pre == "bwd" else {})}
            for config, rs_ in (("ptt_synth.yaml", group_rows), ("ptt_waymo.yaml", waymo_group_rows)) for r in rs_]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
