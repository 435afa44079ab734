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
     ``Trainer`` for one epoch, a checkpoint and a resume.
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
            ("ragged N = 1500, 16 warps, ties", resampled(2, 1500, 8), 400), ("N = 1", cloud(2, 1), 1)]


def check_fps(calls, device):
    """Phase 2, FPS: the forward's two captured calls (the record's rows), the two
    shapes of a B = 48 train step, and the hard cases, each against the plain
    version; time by events and on the device, the latency bound, the share."""
    from ptt_tpu_torch.ops import fps, point_ops

    for limit, warps, pts in fps.KERNEL_FORMS:
        if fps.built_form(limit) != (warps, pts):
            fail(f"FPS: csrc/fps.cu runs N = {limit} in the form {fps.built_form(limit)}, ops/fps.py says {(warps, pts)}")
    probe = fps.latency_probe(device)
    check_fps_constants(probe)
    clock = max(PEAK_CLOCK, probe["clock_ghz"] * 1e9)
    gen = torch.Generator(device=device).manual_seed(4)
    extent = torch.tensor([2.2, 1.0, 0.8], device=device)
    train = [(f"train step, B = {TRAIN_B}", (torch.rand((B, N, 3), device=device, generator=gen) * 2 - 1) * extent, m)
             for B, N, m in ((2 * TRAIN_B, 1024, 512), (TRAIN_B, 128, 64))]
    rows = []
    for label, xyz, npoint in [("frame step", x, m) for (x, m), _ in calls] + train:
        got = fps.furthest_point_sample(xyz, npoint)
        ref = point_ops.furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        shape = f"{tuple(xyz.shape)}->{npoint}"
        if not torch.equal(got, ref):
            fail(f"FPS kernel differs from its plain version at {shape} ({label}): {int((got != ref).sum())} indices")
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
    for label, xyz, npoint in fps_hard_cases(device):
        got = fps.furthest_point_sample(xyz, npoint)
        ref = point_ops.furthest_point_sample(xyz, npoint)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        log(f"  fps {tuple(xyz.shape)}->{npoint} ({label}), form {fps.kernel_form(xyz.shape[1])}: equal to plain {same}")
        if not same:
            fail(f"FPS kernel differs from its plain version on the hard case '{label}': {int((got != ref).sum())} indices")
    for n in (fps.MAX_POINTS + 1, 4096):
        try:
            fps.furthest_point_sample(torch.zeros((1, n, 3), device=device), 8)
        except ValueError:
            continue
        fail(f"FPS: the wrapper did not refuse N = {n}, beyond its largest form")
    return rows[:len(calls)], rows[len(calls):]


def check_kernels(calls):
    from ptt_tpu_torch.ops import point_ops, sa

    frame_rows, _ = check_fps(calls["fps"], calls["fps"][0][0][0].device)
    rows = {"fps": frame_rows, "sa": []}
    for args, kwargs in calls["sa"]:
        xyz, new_xyz, features, radius, nsample, weights, biases = args
        B, M = new_xyz.shape[:2]
        shape = f"{tuple(xyz.shape)}->{M} ns{nsample} r{radius} C{[w.shape[0] for w in weights] + [weights[-1].shape[1]]}"
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
    own = {name: [e for e in kernels if name in e.key] for name in ("fps_kernel", "sa_pre_kernel", "sa_kernel")}
    log("  the port's kernels in that batch: " + ", ".join(
        f"{name} {sum(e.self_device_time_total for e in es) / 1e3:.2f} ms in {sum(e.count for e in es)} launches "
        f"({100 * sum(e.self_device_time_total for e in es) / max(busy_us, 1):.1f}% of the busy time)"
        for name, es in own.items()))


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
    from ptt_tpu_torch.train.optim import Adam
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
        return model, Adam(model.parameters(), optim_cfg, len(loader))

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


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.config import ptt_config, ptt_synth_config
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
                          ms=sum(r["ms"] for r in rs), plain_ms=sum(r["plain_ms"] for r in rs),
                          bound_ms=sum(r["bound_ms"] for r in rs))
               for name, rs in rows.items()}
    for name in summary:
        summary[name]["device_ms"] = sum(r["device_ms"] for r in rows[name])
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
    del ev, model
    torch.cuda.empty_cache()

    # 6 and 7: the training path
    train_launches, group_rows = train_phase(ptt_synth_config(), device, card)

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
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
