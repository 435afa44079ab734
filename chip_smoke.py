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
  4. the device tracker (``DeviceTrackingEvaluator``, every frame step a replay
     of its captured CUDA graph) on 8 x 24 synthetic tracklets with the trained
     weights: Success/Precision, launch counts (by the wrappers' counters, which
     a replay advances by what its capture counted, then by the device under
     the profiler in a batch of replays; the vector attention's fused calls,
     2 a frame step, equal to the kNN searches, none refused), then frames/s
     over pipelined
     batches of the benchmark workload (8 x 64 frames);
  5. a profile of one tracker batch: device busy and idle shares, top kernels,
     the device's launch counts;
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
     step; the loader: the host's cores, one item's ms, a batch by threads
     (the loader before its processes) alone and beside train steps, by the
     loader's processes; ms per step on one pre-made batch against the loader
     through the Trainer's loop, alternated; a profile of the step and one of
     5 loader-fed steps (each batch's pinned host-to-device copy on a side
     stream beside the step's kernels, the device's idle share); the
     Trainer's loop against steps uploading their own batch, from one state
     (equal under deterministic algorithms; the kernels that make the step
     not deterministic named); and ``Trainer`` for one epoch, a checkpoint
     and a resume;
  8. ``ptt_large.yaml`` at its full width (2048 / 1024-point clouds, two 2-layer
     4-head transformers) on the port's own seeded init: its 2 FPS and 7 SA
     calls against their plain versions (SA also on the two hard weight sets),
     the forward against the plain path, the tracker on the benchmark workload
     with 2 FPS, 7 SA and 4 fused vector-attention launches a frame step (one
     a transformer layer, equal to the kNN searches), frames/s and a profile;
  9. the same for ``p2b_synth.yaml`` (P2B: no transformers, 'sequence' sampling
     in the backbone, so 1 FPS, 7 SA and no vector-attention launches a step);
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
  12. the KITTI loader on a scene of 4 cars x 60 such sweeps in this process
     (one item's ms, a batch by threads and by processes, the Trainer's loop
     fed by it against one pre-made batch, alternated); the train CLI at B =
     48 on a scene of 4 cars x 30 sweeps from the trained asset, two epochs in one process (the
     second's loop on warm workers), then resumed for a third, each scored by
     TRAIN.WITH_EVAL on a shorter test scene; ms a step with the KITTI loader,
     2 FPS + 7 + 7 group launches a step; ``--eval_all`` over the three
     checkpoints; a reference-layout ``.pth`` loaded as ``--ckpt`` loads it,
     its forward bit-equal to the asset's;
  13. ``ptt_waymo.yaml`` (8192 / 2048-point clouds, stage 0 to 2048 / 1024
     centers) as phases 8-9 take a configuration, the FPS calls also against
     the kernel's round in plain PyTorch (``furthest_point_sample_packed``);
     then (13b) the test CLI with it on phase 11b's scene 0019;
  14. ``ptt_waymo.yaml`` training at B = 48 on synthetic items resampled to
     8192 / 2048 points: the group kernels at its 7 shapes and on a
     heavy-duplication cloud, as phase 6 checks them, then train steps:
     launches, ms a step, peak memory, and ms a step with the loader against
     one pre-made batch, alternated;
  15. mixed precision and the optimizers: one bf16 step on the kernel path and
     one on the plain path from the same state with the same FPS picks, within
     a stated band; bf16 and float32 step times alternated; the train CLI on
     ``p2b_synth_strong.yaml`` (bf16 from the file) and on ``ptt_synth.yaml``
     once per OPTIMIZER, finite losses;
  16. the agreement tracklets written as a nuScenes release, scored by the
     test CLI on ``nuscenes_models/ptt.yaml`` with the trained asset, within
     1.0 of phase 10's numbers;
  17. the captured frame step against the eager loop (the Python loop over
     the same step body), in one call: for ptt.yaml, ptt_large.yaml, P2B and
     ptt_waymo.yaml on the benchmark batch (run with phases 4, 8, 9 and 13) the
     boxes bit-equal (torch.equal) from the same seed, frames/s of both loops
     alternated, host enqueue ms, device busy ms and idle share, the device's
     launch counts, capture ms, graphs cached and pool bytes; on the agreement
     batch all 12 modes bit-equal; the host evaluator's graphed forward against
     its eager forward; a replay after weights are loaded in place into a
     captured model, against the eager loop on those weights; and
     ``set_use_kernels(False)`` after a capture: a new graph that launches no
     FPS or SA kernel.
  18. data parallelism, two ranks sharing the one card on the gloo backend
     (NCCL refuses two ranks on one device), each started by torchrun: (a)
     full-width ptt_synth.yaml training from the trained asset on the kernels,
     global B = 48 (24 a rank; this script is each rank, ``--train-rank DIR``),
     against one process with B = 48 on the same batches from the same state:
     step 0's loss terms, gradient norm, averaged gradient, BatchNorm running
     statistics and parameters within rel 1e-4, steps 1-2 reported (failing
     only at a fault's size), the ranks bit-equal after 3 steps, the ranks'
     kernel launches, ms a step alternated (one process, the ranks, one
     process); (b) the test CLI as two ranks (``--launcher pytorch``) on phase
     11a's tree: the two result files hold 11a's frames, the merged
     Success/Precision within 1.0 of 11a's, each rank's lines equal to one
     process's on its shard.
  19. the training-side tools, as a user runs them: ``python3 -m
     ptt_tpu_torch.tools.train_bench`` (device step, pipelined, blocking and
     K = 4 dispatch ms/it over the loader, samples/s, GFLOP a step and mfu for
     ptt.yaml and ptt_large.yaml at B = 48) and ``python3 -m
     ptt_tpu_torch.tools.demo_tracking`` (parameter counts, FLOPs per module
     and per layer, a train step; run with phase 22's side tools, beside
     phase 16); their output printed; (19b) the
     ptt.yaml forward's matrix products by (M, K, N) with their device time,
     each beside the layers of that product.
  20. (run after 13b) POINT_SHARDING, two gloo ranks on the one card as one
     point group (the ranks of a node), each started by torchrun: (a) at
     ptt_waymo's stage-0 shapes (B = 8; 8192 points, 2048 centers; 2048 and
     1024) ``ball_query``, ``knn``, ``three_nn`` and ``square_distance`` split
     over the ranks torch.equal to unsplit, and the SA kernel on each rank's
     half of the centers, gathered, torch.equal to the unsplit kernel and
     within SA_RTOL of ``fused_sa_plain`` (``chip_smoke.py --point-rank DIR``
     is each rank); (b) the test CLI with ptt_waymo.yaml as the two ranks on
     13b's scene: 13b's result file line for line, its Success/Precision, the
     SA calls that split (4 of 7 a step), bytes gathered, ms a frame step and
     frames/s a rank beside 13b's; (c) the train CLI with ptt_synth_ps.yaml as
     two ranks, 2 data-parallel steps, finite, the training note logged.
  21. (run after 14) the train step as one CUDA graph (``TrainStep``),
     ptt_synth.yaml at B = 48 from the trained asset on the kernels: (a) 5
     replays of the one-step graph against 5 eager steps from one state,
     step 0's loss terms torch.equal, every step's loss and grad_norm and the
     parameters after 1, 4 and 5 steps within 10 x what the eager steps again
     differ by (``torch.gather``'s backward scatters with atomics), 5 distinct
     losses, 2 FPS + 7 + 7 group launches a replay; (b) one replay of the K =
     4 graph (in the one-step graph's pool) against 4 replays of the one-step
     graph and 4 eager steps, its
     table of hyperparameters equal to the optimizer's schedules; (c) ms a
     step of the Trainer's loop over pre-made batches, eager and graphed, K =
     1 and 4, alternated, each also traced (device idle share, the device's
     launches, exactly 2 FPS + 7 + 3 x 7 group kernels a step), capture
     seconds and pool MB; (d) a graphed bf16 step
     against the eager one, and a graphed ptt_waymo.yaml step with its peak
     memory; (e) ``Trainer`` at STEPS_PER_DISPATCH = 4 over 5 steps an epoch
     (one K = 4 dispatch, the tail through the one-step graph), two epochs
     torch.equal to the eager Trainer's under
     deterministic algorithms, exact counts and each step's own loss,
     checkpoints and a resumed epoch; (f) one pool for all of a Trainer's
     train graphs (``utils/cuda_graph.py`` ``CaptureContext``): ptt_large.yaml
     at STEPS_PER_DISPATCH = 4 with a tail of 2, two epochs, bit-equal to the
     eager Trainer under deterministic algorithms, its peak reserved memory
     within 1.15 x a K = 1 graph's; ptt_waymo.yaml at K = 2 with a tail of 1,
     finite, 2 FPS + 7 + 7 group launches a step, step 0 equal to the eager
     Trainer's and later steps within the witness, its peak within 1.15 x
     21d's; ptt_synth.yaml under a BatchNorm schedule that moves every epoch,
     one capture per ``TrainStep``, bit-equal to eager; every graph of a
     Trainer in one pool. With phases 18a and 20c: under a process group the
     step stays eager and says so. Phases 7, 12, 14, 15 and 18a's one process take the eager step
     (``graph=False``) as before; the Trainer (7, 21e), the CLIs and
     ``train_bench`` take the graphed one. The phase runs in a process of its
     own (``chip_smoke.py --phase21``), whose first trace comes after 21a-b's
     captures: in this one, where the phases before set CUPTI up, a trace of
     replays after 21a-b's history (a graph captured under deterministic
     algorithms and released, then one captured into a shared pool) dies
     inside ``cudaGraphLaunch`` (``cupti_repro.py``; PERF.md §6). At its
     end the port's profiler window refuses a trace (``TraceRefused``) once
     21d-e have made that history after 21c's traces.
  22. (run after 19) the JAX package's last modules: (a) at ptt.yaml's
     stage-0 shapes ``square_distance(exact=True)`` and ``group_all``
     torch.equal to the CPU's, ``uniform_resample_idx``'s counts equal, its
     fronts the sorted unique members; (b) CosineSimAug with MLP.BN False at
     full width within 1e-4 of the CPU; the tools as a user runs them: (c)
     ``fused_ab`` (kernels against plain within 1.0), (d)
     ``parity_decomposition --device cuda`` (the deployed row within 2.0 of
     the asset's host numbers), (f) ``warmup --train`` and ``warmup
     --seed-out`` (refused), side by side with phase 19's ``demo_tracking``
     beside phase 16 (their checks are results, not times), then
     (e) ``compile_diag`` cold and warm and (g) ``train_ablate --iters 4``
     one at a time;
  23. (run after 3) ``csrc/tf32x3.cu``, the eval-mode float32 product, at the
     eight products of a frame step (B = 8): error against float64 within
     twice cuBLAS float32's, ms of the kernel, its plain version and the
     library layer (cuBLAS GEMM, BatchNorm, ReLU), its bound, device time of
     its two kernels, and the crossover against the library layer; phase 4
     also counts its 8 launches a frame step.
  24. (run after 23) ``csrc/vattn.cu``, the blocks' eval vector attention
     around fc_gamma, at the four calls of the cells' frame steps (B = 8):
     A equal to the plain version, res and attn within 1e-6 of it, ms of the
     two kernels, of the plain versions and of the blocks' glue as the
     library layers ran it, the bytes bound, and the two kernels' device time.
Every trace goes through the port's profiler window (``utils/profiling.py``
``device_window``, which keeps CUPTI subscribed for the process); a window
without the device's activity, which the profiler still returns now and
then, is taken again, said and counted (``traced_window``; the counts on the
``profiler_windows`` line). The test CLI runs of phases 11, 13b and 16 run
in such a window, and the device's launch counts must equal the wrappers'
and replays' counts. ``[time]`` lines give the seconds so far.
The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Without a GPU it exits 1 and prints no result.
Every process the run starts has ended when it exits, by any path: this process
adopts the orphans of its descendants, and before it exits it shuts down the
loaders' worker processes, stops the fork server and multiprocessing's resource
tracker (which would otherwise outlive it by a moment), then ends and reaps
whatever else is still below it, and logs what it stopped (``stop_children``).
``python3 chip_smoke.py --train-rank DIR`` is phase 18a's rank, and
``--point-rank DIR`` phase 20a's, not a run;
``python3 chip_smoke.py --tf32x3`` runs the build and phase 23 alone,
``--vattn`` the build and phase 24 alone;
``python3 chip_smoke.py --loader-start`` times the loader's start by start
method (``loader_start``), and ``python3 chip_smoke.py --trace-cost`` what a
trace that keeps CUPTI attached costs the graphed work after it
(``trace_cost``), not runs either.
"""

from __future__ import annotations

import atexit
import copy
import ctypes
import faulthandler
import gc
import json
import logging
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ptt_tpu_torch.utils import timer

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
# a train step's loss terms: its forward's, which has no atomics (the backward's gather scatters with them)
LOSS_TERMS = ("centroids_cls_loss", "centroids_reg_loss", "boxes_cls_loss", "boxes_reg_loss", "loss")
LOADER_WORKERS = 8  # the loader's processes in phases 7, 12 and 14, as many as the card's host has cores
SEED = 0  # torch.manual_seed of the configurations without trained weights


def log(msg):
    print(msg, flush=True)


def fail(msg):
    log(f"FAIL: {msg}")
    sys.exit(1)


def launch_counts(*keys) -> dict:
    """The kernel wrappers' launch counts since the last ``timer.reset()``
    (``tools.kernel_launches``), of ``keys`` or of every kernel."""
    from ptt_tpu_torch.tools import kernel_launches

    counts = kernel_launches()
    return {k: counts[k] for k in keys or counts}


def vattn_counts() -> dict:
    """The blocks' vector-attention route since the last ``timer.reset()``
    (``ops/vattn.py``): its fused calls, the kNN searches of the blocks, and
    the CUDA float32 eval-mode calls it refused."""
    return {"vattn": timer.counter("launches.vattn"), "knn": timer.counter("launches.knn"),
            "vattn.plain": timer.counter("vattn.plain")}


def check_vattn_counts(tag, counts, per_step, steps):
    """``vattn_counts()`` of a tracker batch: ``per_step`` fused calls a frame
    step, as many as kNN searches, none refused."""
    if counts != {"vattn": per_step * steps, "knn": per_step * steps, "vattn.plain": 0}:
        fail(f"{tag} tracker: vector attention {counts}, expected {per_step} fused calls and kNN searches a frame "
             f"step over {steps} steps and none refused")


PR_SET_CHILD_SUBREAPER = 36  # prctl option, <linux/prctl.h>
CHILD_GRACE_S = 5.0  # seconds between SIGTERM and SIGKILL for a process left below this one


def adopt_orphans():
    """Make this process the subreaper of its descendants: a process whose
    parent exits before it (a loader worker of a subprocess, say) is
    reparented here rather than to init, so ``stop_children`` still finds it.
    ``stop_children`` then runs at exit, whatever the exit."""
    libc = ctypes.CDLL(None, use_errno=True)
    if libc.prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0) != 0:
        log(f"prctl(PR_SET_CHILD_SUBREAPER): errno {ctypes.get_errno()}; orphans go to init")
    atexit.register(stop_children)


def descendants():
    """(pid, name, state) of every process below this one, from /proc."""
    children = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                stat = fh.read()
        except OSError:
            continue
        name, fields = stat[stat.index("(") + 1:stat.rindex(")")], stat[stat.rindex(")") + 2:].split()
        children.setdefault(int(fields[1]), []).append((int(entry), name, fields[0]))
    found, todo = [], [os.getpid()]
    while todo:
        for child in children.get(todo.pop(), []):
            found.append(child)
            todo.append(child[0])
    return found


def reap():
    """Collect the exit status of every child of this process that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def end_processes(skip=()) -> list:
    """SIGTERM every live process below this one but ``skip``, SIGKILL what
    is left after CHILD_GRACE_S, reap; returns (pid, name) of those it signalled."""
    def live():
        reap()
        return {pid for pid, _, state in descendants() if state != "Z" and pid not in skip}

    alive = live()
    targets = [(pid, name) for pid, name, _ in descendants() if pid in alive]
    for sig in (signal.SIGTERM, signal.SIGKILL):
        for pid in live() & {pid for pid, _ in targets}:
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + CHILD_GRACE_S
        while live() & {pid for pid, _ in targets} and time.monotonic() < deadline:
            time.sleep(0.05)
    reap()
    return targets


_stopped = False


def stop_children():
    """End every process this run started that still runs: the worker
    processes of every loader not yet closed (shut down by their own
    iterator, so that PyTorch does not take their end for a crash), the
    fork server that forked them, anything else below this process, then
    multiprocessing's resource tracker (it ends once no process holds its
    pipe). The fork server and the tracker each end on their own only after
    this process has exited. Logs what it stopped; runs once."""
    global _stopped
    if _stopped:
        return
    _stopped = True
    import multiprocessing.forkserver
    import multiprocessing.resource_tracker
    import multiprocessing.util
    from torch.utils.data.dataloader import _MultiProcessingDataLoaderIter

    pools = [obj for obj in gc.get_objects() if type(obj) is _MultiProcessingDataLoaderIter]
    workers = sum(1 for it in pools for w in it._workers if w.is_alive())
    for it in pools:
        it._shutdown_workers()
    server = multiprocessing.forkserver._forkserver
    had_server = server._forkserver_pid is not None
    server._stop()
    # what multiprocessing does at exit, now: end its other children, run its
    # finalizers (they unlink the loaders' semaphores and tell the tracker)
    multiprocessing.util._exit_function()
    tracker = multiprocessing.resource_tracker._resource_tracker
    tracker_pid = tracker._pid if tracker._fd is not None else None
    others = end_processes(skip={tracker_pid})
    if tracker_pid is not None:  # closing its pipe ends it; end_processes kills it if it does not end in time
        os.close(tracker._fd)
        tracker._fd = tracker._pid = None
    others += [(pid, name) for pid, name in end_processes() if pid != tracker_pid]
    named = lambda procs: ", ".join(f"{name}[{pid}]" for pid, name in procs) or "none"
    log(f"[exit] loader workers shut down: {workers}; fork server stopped: {had_server}; resource tracker "
        f"stopped: {tracker_pid is not None}; other processes ended: {named(others)}; "
        f"left: {named((pid, name) for pid, name, _ in descendants())}")


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


PROFILER_RETAKES = 20  # windows a measurement takes before it reads the profiler's silence as not measured
# this process's profiler windows, and those that came back without the device's activity: under either CUPTI
# setting the profiler has returned such windows now and then, late in a process (PERF.md §6)
profiler_windows = {"windows": 0, "empty": 0}


def traced_window(fn, what, ok=lambda window: bool(window.events), **kwargs):
    """``fn()`` in the port's profiler window (``utils/profiling.py``
    ``device_window(**kwargs)``), taken again after a pause, and said, while
    the window shows no device activity (``ok``); counted in
    ``profiler_windows``. Returns (the window, what ``fn`` returned) and
    whether a window showed the activity, false after PROFILER_RETAKES
    empty ones."""
    from ptt_tpu_torch.utils.profiling import device_window

    for attempt in range(PROFILER_RETAKES):
        if attempt:
            log(f"  the profiler saw no device activity in {what} (window {attempt}); taken again")
            time.sleep(0.5)
        torch.cuda.synchronize()
        profiler_windows["windows"] += 1
        with device_window(**kwargs) as window:
            out = fn()
            torch.cuda.synchronize()
        if ok(window):
            return window, out, True
        profiler_windows["empty"] += 1
    log(f"  the profiler saw no device activity in {what} in {PROFILER_RETAKES} windows: not measured")
    return window, out, False


def kernel_ms(fn, iters: int, names):
    """Device time of one call by kernel, from the port's profiler window
    (``traced_window``): for each of ``names`` the summed time of the kernels
    whose name contains it, per call; None (not measured) if no window shows
    them (the device time of the whole call is ``queued_ms``'s, by CUDA
    events)."""
    def by_name(window):
        return {n: sum(e.dur_us for e in window.events if e.kind == "kernel" and n in e.name) / iters / 1e3
                for n in names}

    fn()
    window, _, seen = traced_window(lambda: [fn() for _ in range(iters)], f"{iters} calls of {names}",
                                    ok=lambda w: any(by_name(w).values()))
    return by_name(window) if seen else None


def by_kernel(parts) -> str:
    if parts is None:
        return "not measured (the profiler saw no device time in 20 windows)"
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


TRACKER_KERNELS = ("fps_kernel", "sa_pre_kernel", "sa_kernel")


def profile_batch(ev, tracklets, n_frames, tag="[5]", quiet=False):
    """One batch of the tracker in the port's profiler window: host time to
    enqueue it, wall time, the device's busy and idle shares, and (unless
    ``quiet``) the kernels by device time. Returns those numbers and the
    device's own count of each tracker kernel's launches (``launches``), which
    a graph replay shows as the eager loop does."""
    def batch():
        t0 = time.perf_counter()
        handle = ev.dispatch_batch(tracklets)
        t_enqueue = time.perf_counter() - t0
        ev.finish_batch(handle)
        return t_enqueue, time.perf_counter() - t0

    window, (t_enqueue, wall), seen = traced_window(batch, f"{tag} a batch of the tracker")
    if not seen:
        fail(f"{tag} the profiler saw no device time in a batch of the tracker")
    events = window.events
    busy_us = sum(e.dur_us for e in events)
    steps = len(tracklets[0][0]) - 1
    stats = {"wall_ms": wall * 1e3, "enqueue_ms": t_enqueue * 1e3, "busy_ms": busy_us / 1e3,
             "idle_pct": 100 - 100 * busy_us / 1e6 / wall, "device_ops": len(events),
             "launches": {name: sum(e.kind == "kernel" and name in e.name for e in events) for name in TRACKER_KERNELS}}
    if quiet:
        return stats
    log(f"{tag} profile of one batch ({n_frames} frames, {steps} frame steps): wall {wall * 1e3:.1f} ms, "
        f"host enqueue {t_enqueue * 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}% busy, {stats['idle_pct']:.1f}% idle), "
        f"{stats['device_ops']} device operations")
    for name, (us, n) in top_names(events, 12):
        log(f"  {us / 1e3:8.2f} ms  {n:6d}x  {name[:90]}")
    own = {name: [e for e in events if e.kind == "kernel" and name in e.name] for name in TRACKER_KERNELS}
    log("  the port's kernels in that batch: " + ", ".join(
        f"{name} {sum(e.dur_us for e in es) / 1e3:.2f} ms in {len(es)} launches "
        f"({100 * sum(e.dur_us for e in es) / busy_us:.1f}% of the busy time)"
        for name, es in own.items()))
    return stats


def top_names(events, n):
    """The ``n`` names of device events with the most device time:
    [(name, (microseconds, count)), ...]."""
    by_name = {}
    for e in events:
        us, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (us + e.dur_us, count + 1)
    return sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]


def check_device_launches(tag, counts, n_fps, steps):
    """The device's own launch counts (``profile_batch``) against n_fps FPS
    and 7 SA calls (each sa_pre_kernel + sa_kernel) a frame step."""
    want = {"fps_kernel": n_fps * steps, "sa_pre_kernel": 7 * steps, "sa_kernel": 7 * steps}
    log(f"{tag} launches the device ran in a batch of replays: {counts} over {steps} frame steps "
        f"({n_fps} FPS and 7 SA calls a step expected)")
    if counts != want:
        fail(f"{tag} the device ran {counts}, not {want}")


def eager(ev):
    """``ev`` (a DeviceTrackingEvaluator) on its eager loop, the Python loop
    over the step body: the witness the captured graph is held against."""
    ev._track = ev._track_eager
    return ev


def graph_stats(ev) -> dict:
    """Capture ms, graphs cached and pool bytes of a DeviceTrackingEvaluator."""
    entries = [e for e in ev.graphs.values() if e.graph is not None]
    return {"graphs": len(ev.graphs), "captures": ev.graphs.captures,
            "capture_ms": [round(e.graph.capture_s * 1e3, 3) for e in entries],
            "pool_bytes": [e.graph.pool_bytes() for e in entries]}


def graph_vs_eager(tag, name, cfg, model, bench, device, card, n_fps):
    """Phase 17 for one configuration on the benchmark batch (8 x 64 frames,
    max_points 2048): the graphed tracker's boxes bit-equal to the eager
    loop's from the same seed; frames/s of both, alternated (eager, graph,
    graph, eager; 2 pipelined batches a run); host enqueue ms, device busy ms
    and idle share of one profiled batch each, the device's launch counts of
    each; capture ms, graphs cached, pool bytes."""
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator

    loops = {"graph": DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device),
               "eager": eager(DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device))}
    boxes, first_s = {}, {}
    for drv, ev in loops.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        boxes[drv] = ev.boxes(ev.dispatch_batch(bench))
        torch.cuda.synchronize()
        first_s[drv] = time.perf_counter() - t0
    same = torch.equal(boxes["graph"], boxes["eager"])
    rates = {"eager": [], "graph": []}
    for drv in ("eager", "graph", "graph", "eager"):
        rates[drv].append(bench_rate(loops[drv], bench, 2))
    n_frames = sum(len(t[0]) for t in bench)
    prof = {drv: profile_batch(ev, bench, n_frames, tag, quiet=True) for drv, ev in loops.items()}
    g = graph_stats(loops["graph"])
    # the host's time to enqueue a graphed batch behind ~0.5 s of queued device work: about
    # the packing alone if the launch queue holds the batch's 63 replays, about the queued
    # work's length if the host waits for room in it
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    handle = loops["graph"].dispatch_batch(bench)
    behind_ms = (time.perf_counter() - t0) * 1e3
    loops["graph"].finish_batch(handle)
    # the host's own work on a batch, beside the device's: packing it, and scoring its boxes
    t0 = time.perf_counter()
    loops["graph"]._pack(bench)
    host_ms = {"pack": (time.perf_counter() - t0) * 1e3}
    boxes_host = boxes["graph"].numpy()
    t0 = time.perf_counter()
    loops["graph"]._score(boxes_host, bench)
    host_ms["score"] = (time.perf_counter() - t0) * 1e3
    host_ms["enqueue_behind_sleep"] = behind_ms
    for drv in ("eager", "graph"):
        p = prof[drv]
        log(f"{tag} {name} {drv} loop: {', '.join(f'{r:.1f}' for r in rates[drv])} frames/s "
            f"(2 pipelined batches a run, alternated), one profiled batch: wall {p['wall_ms']:.1f} ms, host enqueue {p['enqueue_ms']:.1f} ms, "
            f"device busy {p['busy_ms']:.1f} ms ({p['idle_pct']:.1f}% idle), {p['device_ops']} device operations; "
            f"first batch {first_s[drv] * 1e3:.1f} ms; card {card}")
    log(f"{tag} {name}: graphed boxes bit-equal to the eager loop's {same}; capture {g['capture_ms']} ms, "
        f"{g['graphs']} graph(s) cached, pool {g['pool_bytes']} bytes; host work on a batch: packing "
        f"{host_ms['pack']:.1f} ms, scoring {host_ms['score']:.1f} ms; a graphed batch enqueued behind ~0.5 s of "
        f"queued device work in {behind_ms:.1f} ms")
    if not same:
        fail(f"{tag} {name}: the graphed tracker's boxes differ from the eager loop's "
             f"(max |diff| {float((boxes['graph'] - boxes['eager']).abs().max()):.3e})")
    for drv in ("eager", "graph"):
        check_device_launches(f"{tag} {name} {drv}", prof[drv]["launches"], n_fps, len(bench[0][0]) - 1)
    for ev in loops.values():
        ev.close()
    return {"config": name, "bit_equal": same, "frames_per_s": rates,
            **{f"{drv}_profile": {k: v for k, v in prof[drv].items() if k != "launches"} for drv in prof},
            "first_batch_s": first_s, "host_ms": host_ms, **g}


def bench_tracklets():
    """The benchmark workload: 8 synthetic tracklets of 64 frames (600 object,
    400 clutter and 120 pole points a frame), the JAX ``bench.py`` workload,
    as ``tools/bench_setup.py`` ``bench_tracklets`` makes it (no model)."""
    from ptt_tpu_torch.config import cli_config
    from ptt_tpu_torch.tools import bench_setup

    return bench_setup.bench_tracklets(cli_config(bench_setup.BENCH_CFG)["DATA_CONFIG"])


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


def config_phase(tag, name, cfg, device, card, clock, n_fps, n_vattn, agreement, bench, graph_rows):
    """Phases 8 and 9: one more configuration at its full published width, on
    the port's own seeded init (no trained weights exist for it): every FPS
    and SA call of the first frame step's forward against its plain version,
    the forward against the plain path, then the tracker on the benchmark
    workload: launches per frame step (counted by the wrappers and the
    replays, then by the device in a profiled batch; ``n_vattn`` fused
    vector-attention calls a step), frames/s, a profile of one batch; then
    phase 17's graph-against-eager rows, appended to ``graph_rows``. Returns
    (rows by kernel, launches of one batch, ``vattn`` among them)."""
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network, set_use_kernels

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
    timer.reset()
    results = ev.track_batch(bench)
    torch.cuda.synchronize()
    launches, attention = launch_counts("fps", "sa"), vattn_counts()
    steps = len(bench[0][0]) - 1
    centers = np.array([[b.center for b in trk] for trk in results])
    log(f"{tag} {name} tracker, one batch of the benchmark workload: launches {launches}, vector attention "
        f"{attention} over {steps} frame steps ({n_fps} FPS, 7 SA and {n_vattn} fused vector-attention calls a step "
        f"expected); boxes finite {bool(np.isfinite(centers).all())}")
    if launches != {"fps": n_fps * steps, "sa": 7 * steps}:
        fail(f"{tag} {name} tracker: launches {launches}, expected {n_fps} and 7 per frame step over {steps} steps")
    check_vattn_counts(f"{tag} {name}", attention, n_vattn, steps)
    launches["vattn"] = attention["vattn"]
    if not np.isfinite(centers).all():
        fail(f"{tag} {name} tracker: non-finite boxes")
    rates = [bench_rate(ev, bench, 2) for _ in range(3)]
    set_use_kernels(model, False)
    plain_rate = bench_rate(ev, first_frames(bench, 32), 1)
    set_use_kernels(model, True)
    log(f"{tag} {name} throughput, 8 x 64-frame tracklets, 2 pipelined batches per run: "
        f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f}); plain path "
        f"{plain_rate:.1f} frames/s (one batch cut to 32 frames, graphed, its capture included); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; card {card}")
    prof = profile_batch(ev, bench, sum(len(t[0]) for t in bench), tag)
    check_device_launches(tag, prof["launches"], n_fps, steps)
    ev.close()
    graph_rows.append(graph_vs_eager("[17]", name, cfg, model, bench, device, card, n_fps))
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


def graph_phase(cfg, model, agreement, device):
    """Phase 17 on the agreement batch and the trained asset: in all 12
    REF_BOX x SHAPE_AGGREGATION modes the graphed tracker's boxes bit-equal to
    the eager loop's; the host evaluator's graphed forward against its eager
    forward, the same boxes; weights swapped in place after a capture (captured
    on a seeded init, then the asset loaded): the replay equals the eager
    loop on the asset; ``set_use_kernels(False)`` after a capture: a new
    graph, whose replays launch no FPS or SA kernel, equal to the eager plain
    path. Returns what it measured."""
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.eval.evaluator import TrackingEvaluator, best_proposal
    from ptt_tpu_torch.nn import build_network, set_use_kernels

    def both(c, m):
        return (DeviceTrackingEvaluator(c, m, max_points=1024, batch_size=8, device=device),
                eager(DeviceTrackingEvaluator(c, m, max_points=1024, batch_size=8, device=device)))

    out = {"modes": {}}
    for ref, agg in MODES:
        mcfg = copy.deepcopy(cfg)
        mcfg["TEST"].update(REF_BOX=ref, SHAPE_AGGREGATION=agg)
        g, e = both(mcfg, model)
        out["modes"][f"{ref}/{agg}"] = torch.equal(g.boxes(g.dispatch_batch(agreement)),
                                                   e.boxes(e.dispatch_batch(agreement)))
        g.close()
    log(f"[17] the 12 modes on the agreement batch, graphed boxes bit-equal to the eager loop's: {out['modes']}")
    if not all(out["modes"].values()):
        fail("[17] a mode's graphed boxes differ from the eager loop's")

    hosts = {"graph": TrackingEvaluator(cfg, model, device=device), "eager": TrackingEvaluator(cfg, model, device=device)}
    hosts["eager"].track_step = lambda s, t: best_proposal(model, s, t)
    got = {}
    for drv, ev in hosts.items():
        t0 = time.perf_counter()
        got[drv] = [ev.test_tracklet(pcs, boxes, annos) for pcs, boxes, annos in agreement]
        got[f"{drv}_s"] = time.perf_counter() - t0
    same = all(np.array_equal(a.center, b.center) and np.array_equal(a.orientation.elements, b.orientation.elements)
               for ta, tb in zip(got["graph"], got["eager"]) for a, b in zip(ta, tb))
    steps = sum(len(t[0]) - 1 for t in agreement)
    sg, se = hosts["graph"].summary(), hosts["eager"].summary()
    out["host"] = {"same_boxes": same, "graphs": len(hosts["graph"].track_step.graphs),
                   "graph_s": got["graph_s"], "eager_s": got["eager_s"],
                   "success": (float(sg["success"]), float(se["success"]))}
    log(f"[17] host evaluator, graphed forward against the eager forward over {steps} frame steps: the same boxes "
        f"{same}, Success/Precision {sg['success']:.2f}/{sg['precision']:.2f} and {se['success']:.2f}/"
        f"{se['precision']:.2f}; {len(hosts['graph'].track_step.graphs)} graph cached; {got['graph_s']:.2f} s "
        f"against {got['eager_s']:.2f} s")
    if not same or len(hosts["graph"].track_step.graphs) != 1:
        fail("[17] the host evaluator's graphed forward differs from its eager forward, or it cached other than 1 graph")
    hosts["graph"].close()

    torch.manual_seed(SEED)
    fresh = build_network(cfg["MODEL"], device=device)
    g, e = both(cfg, fresh)
    seeded = g.boxes(g.dispatch_batch(agreement))
    fresh.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    swapped = g.boxes(g.dispatch_batch(agreement))
    want = e.boxes(e.dispatch_batch(agreement))
    out["swap"] = {"equal_eager": torch.equal(swapped, want), "moved": not torch.equal(seeded, swapped),
                   "captures": g.graphs.captures}
    log(f"[17] weights loaded in place after a capture on torch.manual_seed({SEED}) init: the replay equals the eager "
        f"loop on the asset {out['swap']['equal_eager']}, its boxes moved from the seeded init's "
        f"{out['swap']['moved']}, captures {g.graphs.captures}")
    if not (out["swap"]["equal_eager"] and out["swap"]["moved"] and g.graphs.captures == 1):
        fail("[17] a replay after an in-place weight load does not track with the new weights")

    set_use_kernels(fresh, False)
    plain = g.boxes(g.dispatch_batch(agreement))  # captured anew; the profiled batch is all replays
    prof = profile_batch(g, agreement, sum(len(t[0]) for t in agreement), "[17]", quiet=True)
    plain_eager = e.boxes(e.dispatch_batch(agreement))
    set_use_kernels(fresh, True)
    out["plain"] = {"launches": prof["launches"], "captures": g.graphs.captures,
                    "equal_eager": torch.equal(plain, plain_eager)}
    log(f"[17] set_use_kernels(False) after the capture: captures {g.graphs.captures}, the device ran "
        f"{prof['launches']} in a batch (none expected), boxes bit-equal to the eager plain path "
        f"{out['plain']['equal_eager']}")
    if any(prof["launches"].values()) or g.graphs.captures != 2 or not out["plain"]["equal_eager"]:
        fail("[17] after set_use_kernels(False) the replay still launches a kernel, was not captured anew, or "
             "differs from the eager plain path")
    g.close()
    del g, e, fresh
    torch.cuda.empty_cache()
    return out


def relerr(got, ref) -> float:
    """max |got - ref| over the largest |ref|."""
    return float((got - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def train_batches(data_cfg, n, seed=0, workers=LOADER_WORKERS):
    """The first ``n`` batches of TRAIN_B synthetic train items of an epoch,
    built by the port's loader (``workers`` processes, which stay up until
    the caller closes the loader it gets back; 0 builds them in this process,
    the same batches)."""
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset

    loader = DataLoader(SyntheticTrackingDataset(data_cfg), TRAIN_B, shuffle=True, drop_last=True,
                        seed=seed, num_workers=workers)
    out = []
    for batch in loader:  # leaves the epoch early: the workers stay up for the next one
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


# ------------------------------------------------------------ the loader (phases 7, 12, 14)


def item_ms(dataset, n: int = TRAIN_B) -> float:
    """Median ms to build one train item in this thread, over the first ``n``
    indices of epoch 0's order."""
    order = np.random.default_rng(np.random.SeedSequence([0, 0])).permutation(len(dataset))[:n]
    times = []
    for i in order:
        t0 = time.perf_counter()
        dataset[int(i)]
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def thread_batches_ms(loader, n: int, beside=None):
    """Median ms to build each of ``n`` batches of ``loader``'s epoch as the
    loader built them before it had processes: the items mapped over a pool
    of LOADER_WORKERS threads, then collated. With ``beside``, the main thread
    calls it in a loop meanwhile (a train step, launched and waited for, as
    the Trainer's step waited on its pageable upload); then also returns the
    ms each of those calls took, their mean."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ptt_tpu_torch.data.loader import default_collate

    times = []

    def build():
        with ThreadPoolExecutor(LOADER_WORKERS) as pool:
            for idx in loader.batch_indices()[:n]:
                t0 = time.perf_counter()
                default_collate(list(pool.map(loader.dataset.__getitem__, idx)))
                times.append((time.perf_counter() - t0) * 1e3)

    if beside is None:
        build()
        return float(np.median(times))
    building = threading.Thread(target=build)
    building.start()
    calls = []
    while building.is_alive():
        t0 = time.perf_counter()
        beside()
        calls.append((time.perf_counter() - t0) * 1e3)
    building.join()
    return float(np.median(times)), float(np.mean(calls))


def loader_batch_ms(loader, n: int, warm: int = 2 * LOADER_WORKERS) -> float:
    """ms a batch of ``loader`` (its worker processes) when nothing else runs:
    a new epoch, ``warm`` batches taken first (as many as its workers build
    ahead), then ``n`` more timed."""
    it = iter(loader)
    for _ in range(warm):
        next(it)
    t0 = time.perf_counter()
    for _ in range(n):
        next(it)
    return (time.perf_counter() - t0) * 1e3 / n


def loop_ms(step, model, opt, batches, uploader) -> float:
    """ms a step of the Trainer's loop (``pipelined_steps``: nothing waits on
    the device inside) over ``batches``, from the host's first take to the
    device's end."""
    from ptt_tpu_torch.train.trainer import pipelined_steps

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = len(pipelined_steps(step, model, opt, batches, uploader))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / n


def premade_vs_loader(tag, step, model, opt, batch, loader, n, card, warm: int = 2 * LOADER_WORKERS):
    """ms a step of the Trainer's loop on one pre-made batch and fed by
    ``loader``, alternated (pre-made, loader, pre-made, loader); each loader
    run starts an epoch and first takes ``warm`` steps (as many batches as its
    workers build ahead). Returns (pre-made ms, loader ms), two of each."""
    import itertools

    from ptt_tpu_torch.train.train_step import BatchUploader

    uploader = BatchUploader(next(model.parameters()).device)
    loop_ms(step, model, opt, [batch] * 2, uploader)  # warm-up
    premade, fed = [], []
    for epoch in (1, 2):
        premade.append(loop_ms(step, model, opt, [batch] * n, uploader))
        loader.set_epoch(epoch)
        it = iter(loader)
        loop_ms(step, model, opt, itertools.islice(it, warm), uploader)
        fed.append(loop_ms(step, model, opt, itertools.islice(it, n), uploader))
    log(f"{tag} the Trainer's loop (pinned upload on a side stream), {n} steps a run, alternated: one pre-made "
        f"batch {premade[0]:.1f}, {premade[1]:.1f} ms a step; the loader ({LOADER_WORKERS} processes) "
        f"{fed[0]:.1f}, {fed[1]:.1f} ms a step (loader over pre-made {max(fed) / min(premade):.3f}x); card {card}")
    return premade, fed


def busy_us(events) -> float:
    """The union of the device events' intervals, in the trace's microseconds."""
    union, end = 0.0, float("-inf")
    for a, b in sorted((e.start_us, e.start_us + e.dur_us) for e in events):
        union += max(0.0, b - max(a, end))
        end = max(end, b)
    return union


def profile_fed_steps(tag, step, model, opt, batches):
    """``batches`` through the Trainer's loop in the port's profiler window,
    its device events read back: each host-to-device copy, the stream it ran
    on and whether a kernel of the compute stream ran meanwhile; the device's
    busy and idle shares. Returns the numbers; fails if no copy ran beside a
    kernel on another stream."""
    from ptt_tpu_torch.train.train_step import BatchUploader
    from ptt_tpu_torch.train.trainer import pipelined_steps

    uploader = BatchUploader(next(model.parameters()).device)

    def steps():
        t0 = time.perf_counter()
        n = len(pipelined_steps(step, model, opt, batches, uploader))
        torch.cuda.synchronize()
        return n, (time.perf_counter() - t0) * 1e3

    window, (n, wall), seen = traced_window(steps, f"{tag} {len(batches)} loader-fed steps")
    if not seen:
        fail(f"{tag} the profiler's trace of the loader-fed steps holds no kernel")
    device = window.events
    kernels = [e for e in device if e.kind == "kernel"]
    streams = {}
    for e in kernels:
        streams[e.stream] = streams.get(e.stream, 0) + e.dur_us
    compute = max(streams, key=streams.get)
    busy = [(e.start_us, e.start_us + e.dur_us) for e in kernels if e.stream == compute]
    copies = [e for e in device if e.kind == "memcpy" and "HtoD" in e.name]
    side = [e for e in copies if e.stream != compute]
    overlapped = [e for e in side if any(a < e.start_us + e.dur_us and b > e.start_us for a, b in busy)]
    union = busy_us(device)
    names = sorted({e.name for e in copies})
    out = {"steps": n, "wall_ms": wall, "device_busy_ms": union / 1e3, "idle_share": 1 - union / 1e3 / wall,
           "h2d_copies": len(copies), "side_stream_copies": len(side), "copies_beside_kernels": len(overlapped),
           "side_copy_ms": sum(e.dur_us for e in side) / 1e3, "copy_names": names,
           "compute_stream": compute, "side_streams": sorted({e.stream for e in side})}
    log(f"{tag} profile of {n} loader-fed steps of the Trainer's loop: wall {wall / n:.1f} ms a step, device busy "
        f"{union / 1e3 / n:.1f} ms a step ({100 * out['idle_share']:.1f}% idle); {len(copies)} host-to-device copies "
        f"{names}, {len(side)} on side streams {out['side_streams']} (compute stream {compute}), "
        f"{len(overlapped)} of them while a compute-stream kernel ran, {out['side_copy_ms']:.3f} ms of copies")
    if not overlapped:
        fail(f"{tag} no host-to-device copy ran on a side stream beside the step's kernels")
    if any("Pinned" not in name for name in names):
        fail(f"{tag} a batch was uploaded from pageable memory: {names}")
    return out


def runs_from(state, fresh, batches, run, n=1):
    """``n`` runs of 5 steps each from one state: ``run(model, opt)`` -> the
    steps' metrics; returns [(metrics, state_dict after them)]."""
    model, opt = state
    out = []
    for _ in range(n):
        m, o = fresh(True)
        m.load_state_dict(model.state_dict())
        o.load_state_dict(opt.state_dict())
        metrics = run(m, o)
        out.append((metrics, m.state_dict()))
    return out


def same_steps(a, b) -> bool:
    return all(torch.equal(x[k], y[k]) for x, y in zip(a[0], b[0]) for k in x) and \
        all(torch.equal(x, y) for x, y in zip(a[1].values(), b[1].values()))


def upload_witness(step, model, opt, fresh, batches, device):
    """Phase 7's witness of the pipelined upload: the Trainer's loop
    (``pipelined_steps``) against the steps uploading their own batch, from
    one state on the same 5 batches. The step itself is not deterministic
    (see the kernels it changes below), so the two are held equal
    (torch.equal, every metric and every weight after the 5 steps) under
    ``torch.use_deterministic_algorithms``; in the default mode step 0's loss
    terms (the forward, which has no atomics) must be equal, its grad_norm
    (the backward's gather scatters with atomics) and the later steps are
    reported beside the synchronous run twice."""
    from ptt_tpu_torch.train.train_step import BatchUploader
    from ptt_tpu_torch.train.trainer import pipelined_steps

    def piped(m, o):
        return pipelined_steps(step, m, o, batches, BatchUploader(device))

    def synced(m, o):
        return [step(m, o, b) for b in batches]

    def kernels(m, o):
        window, _, _ = traced_window(lambda: step(m, o, batches[0]), "[7] a train step", cpu=False)
        return {e.name for e in window.events if e.kind == "kernel"}

    state = (model, opt)
    default_kernels = runs_from(state, fresh, batches, kernels)[0][0]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_kernels = runs_from(state, fresh, batches, kernels)[0][0]
        det = runs_from(state, fresh, batches, piped) + runs_from(state, fresh, batches, synced)
    finally:
        torch.use_deterministic_algorithms(False)
    free = runs_from(state, fresh, batches, piped) + runs_from(state, fresh, batches, synced, n=2)
    det_equal = same_steps(det[0], det[1])
    step0_equal = all(torch.equal(free[0][0][0][k], free[1][0][0][k]) for k in LOSS_TERMS)
    step0_norm = bool(torch.equal(free[0][0][0]["grad_norm"], free[1][0][0]["grad_norm"]))

    def rel(a, b):
        return [f"{abs(float(x['loss']) - float(y['loss'])) / abs(float(y['loss'])):.1e}" for x, y in zip(a[0], b[0])]

    log(f"[7] the Trainer's loop (pipelined upload) against the steps uploading their own batch, 5 steps from one "
        f"state, under torch.use_deterministic_algorithms: losses {[round(float(x['loss']), 6) for x in det[0][0]]}, "
        f"every metric and weight equal (torch.equal) {det_equal}")
    log(f"[7] the kernels a step runs only in the default mode (not deterministic): "
        f"{sorted(k[:80] for k in default_kernels - det_kernels)}; only under deterministic algorithms: "
        f"{sorted(k[:80] for k in det_kernels - default_kernels)}")
    log(f"[7] the same in the default mode: step 0's loss terms equal {step0_equal}, its grad_norm {step0_norm}; "
        f"loss rel diff per step pipelined vs synchronous {rel(free[0], free[1])}, synchronous twice "
        f"{rel(free[2], free[1])}")
    if not det_equal:
        fail("[7] under deterministic algorithms the pipelined upload changed the steps")
    if not step0_equal:
        fail("[7] the pipelined upload changed step 0's loss terms")


def profile_train(step, model, opt, batch, n_steps=3):
    """A few train steps in the port's profiler window: wall time, device busy
    and idle shares, and the kernels by device time."""
    def steps():
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step(model, opt, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    window, wall, seen = traced_window(steps, f"[7] {n_steps} train steps")
    if not seen:
        return
    events = window.events
    busy = sum(e.dur_us for e in events)
    log(f"[7] profile of {n_steps} train steps: wall {wall * 1e3 / n_steps:.1f} ms/step, device busy "
        f"{busy / 1e3 / n_steps:.1f} ms/step ({100 * busy / 1e6 / wall:.1f}% busy, "
        f"{100 - 100 * busy / 1e6 / wall:.1f}% idle), {len(events) // n_steps} device operations per step")
    for name, (us, n) in top_names(events, 15):
        log(f"  {us / 1e3 / n_steps:8.2f} ms/step  {n // n_steps:5d}x  {name[:90]}")
    ops = [r for r in window.operators() if r.self_device_us > 0]
    log("[7] the same steps by operator (device time of the kernels each operator launched itself):")
    for r in sorted(ops, key=lambda r: -r.self_device_us)[:15]:
        log(f"  {r.self_device_us / 1e3 / n_steps:8.2f} ms/step  {r.count // n_steps:5d}x  {r.key[:90]}")


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
    from ptt_tpu_torch.ops import fps, point_ops
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step
    from ptt_tpu_torch.train.trainer import Trainer

    model_cfg, optim_cfg = cfg["MODEL"], cfg["OPTIMIZATION"]
    t0 = time.perf_counter()
    loader, batches = train_batches(cfg["DATA_CONFIG"], 5)
    log(f"[6] dataset {len(loader.dataset)} train items, {len(loader)} steps per epoch; 5 batches of "
        f"{TRAIN_B} built in {time.perf_counter() - t0:.1f} s")
    weights = state_dict_from_npz(ASSET)
    # the eager step: FpsReplay swaps the FPS function in Python, which a graph's replay never calls again
    # (phase 21 holds the captured step against this one)
    step = make_train_step(model_cfg, device=device, graph=False)

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
    timer.reset()
    kernel_losses, per_step, stepwise, checked, changed = [], [], [], [], []
    for batch in batches:
        same_model.load_state_dict(model.state_dict())
        same_opt.load_state_dict(opt.state_dict())
        before = launch_counts("fps", "group_fwd", "group_bwd").values()
        with FpsReplay(fps, point_ops) as replay:
            k = step(model, opt, batch)
            replay.start()
            p = step(same_model, same_opt, batch)
        per_step.append(tuple(a - b for a, b in zip(launch_counts("fps", "group_fwd", "group_bwd").values(), before)))
        kernel_losses.append(float(k["loss"]))
        stepwise.append(tuple(abs(float(k[m]) - float(p[m])) / abs(float(p[m])) for m in ("loss", "grad_norm")))
        checked.append(replay.checked)
        changed.append(replay.changed)
    launches = launch_counts()
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

    # the loader: the host's cores, one item, a batch by threads (the loader before its processes), alone and
    # beside train steps, and by the loader's processes
    median_step_ms(step, model, opt, batches[:2])  # warm-up
    one_item = item_ms(loader.dataset)
    by_threads = thread_batches_ms(loader, 4)
    beside_threads, beside_step = thread_batches_ms(
        loader, 4, lambda: median_step_ms(step, model, opt, batches[:1]))
    by_processes = loader_batch_ms(loader, 16)
    log(f"[7] the loader on this host: os.cpu_count() {os.cpu_count()}; one train item {one_item:.2f} ms in one "
        f"thread (median of {TRAIN_B}); a batch of {TRAIN_B} by {LOADER_WORKERS} threads {by_threads:.1f} ms alone, "
        f"{beside_threads:.1f} ms beside train steps, which took {beside_step:.1f} ms a step meanwhile; by the "
        f"loader's {LOADER_WORKERS} processes {by_processes:.1f} ms a batch alone")

    # time per step: one pre-made batch, each step waited for (as before); then the Trainer's loop on one
    # pre-made batch against the loader, alternated
    premade_ms = median_step_ms(step, model, opt, [batches[0]] * 6)
    premade, fed = premade_vs_loader("[7]", step, model, opt, batches[0], loader, 6, card)
    plain_ms = median_step_ms(step, plain_model, plain_opt, [batches[0]] * 3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[7] train step at B = {TRAIN_B}, median of 6 after warm-up, each waited for: {premade_ms:.1f} ms on one "
        f"pre-made batch; plain path {plain_ms:.1f} ms; peak device memory {peak:.1f} GiB; card {card}")
    profile_train(step, model, opt, batches[0])
    del plain_model, plain_opt
    loader.set_epoch(3)
    it = iter(loader)
    for _ in range(2 * LOADER_WORKERS):
        next(it)
    profile_fed_steps("[7]", step, model, opt, [next(it) for _ in range(5)])
    loader.close()

    # the Trainer's loop (pinned upload of batch k+1 on a side stream while step k runs) against the same 5
    # steps each uploaded inside the step (pageable, synchronous), from one state on the same batches
    upload_witness(step, model, opt, fresh, batches, device)

    # Trainer: one epoch on a small set, checkpoint, resume, one more step
    out_dir = os.path.join(REPO, "build", "chip_smoke_train")
    shutil.rmtree(out_dir, ignore_errors=True)
    small = dict(cfg["DATA_CONFIG"], NUM_TRACKLETS=8, FRAMES_PER_TRACKLET=6)
    logger = logging.getLogger("chip_smoke")

    def trainer(total_epochs):
        net = copy.deepcopy(model)
        small_loader = DataLoader(SyntheticTrackingDataset(small), TRAIN_B, shuffle=True, drop_last=True,
                                  num_workers=LOADER_WORKERS)
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
    first.train_loader.close()
    resumed.train_loader.close()
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


# Runs ``python3 -m <module> args`` in the port's profiler window (device
# activity only) and prints, after the module's own output, the device's count
# of each tracker kernel's launches: a graph replay runs no Python wrapper, so
# this is the count the wrappers' counters are held against.
PROFILED_CLI = """
import json, runpy, sys
from ptt_tpu_torch.utils.profiling import device_window
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
code = 0
with device_window(cpu=False) as window:
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
    except SystemExit as exc:
        code = exc.code or 0
names = %r
kernels = [e.name for e in window.events if e.kind == "kernel"]
print("device_launches " + json.dumps({n: sum(n in k for k in kernels) for n in names}), flush=True)
sys.exit(code)
""" % (TRACKER_KERNELS,)


def run_cli(module: str, args, timeout: float = 600, device_launches: bool = False):
    """Run ``python3 -m ptt_tpu_torch.tools.<module> args`` from the repo root and
    return (its ``summary`` record, wall seconds, its log). Fails the run when
    the CLI fails. With ``device_launches`` the CLI runs in the port's profiler window,
    and the record's ``device_launches`` holds the device's count of each
    tracker kernel's launches; the wrappers' counts (``launches``) must equal it."""
    return finish_cli(module, args, start_cli(module, args, device_launches), timeout, device_launches)


def start_cli(module: str, args, device_launches: bool = False):
    """Start ``run_cli``'s process; returns (the process, its start time)."""
    target = f"ptt_tpu_torch.tools.{module}"
    cmd = [sys.executable, *(["-c", PROFILED_CLI] if device_launches else ["-m"]), target, *map(str, args)]
    return subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), \
        time.perf_counter()


def finish_cli(module: str, args, started, timeout: float = 600, device_launches: bool = False):
    """Wait for a process of ``start_cli``; returns what ``run_cli`` returns."""
    proc, t0 = started
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{module}: no exit within {timeout} s")
    out = subprocess.CompletedProcess(proc.args, proc.returncode, stdout, stderr)
    wall = time.perf_counter() - t0
    text = out.stdout + out.stderr
    if out.returncode != 0:
        log(text[-4000:])
        fail(f"{module} {' '.join(map(str, args))} exited with {out.returncode}")
    records = [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]
    if not records:
        fail(f"{module}: no summary line in its log")
    record = records[-1]
    if device_launches:
        counted = [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
                   if line.startswith("device_launches ")]
        if not counted:
            fail(f"{module}: no device_launches line")
        record["device_launches"] = counted[-1]
        wrappers = record["launches"]
        log(f"  {module} {' '.join(map(str, args[:4]))} ...: the device ran {counted[-1]} (torch.profiler)")
        if counted[-1] != {"fps_kernel": wrappers["fps"], "sa_pre_kernel": wrappers["sa"], "sa_kernel": wrappers["sa"]}:
            fail(f"{module}: the device ran {counted[-1]}, the wrappers and replays counted {wrappers}")
    return record, wall, text


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
        # the eager loop: the recorder reads the device, which a capture may not
        eager(dl.DeviceTrackingEvaluator(cfg, model, max_points=16384, batch_size=8, device=device)).track_batch(first)
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
    in ``tmp/sweeps`` for phase 13b. Returns (a)'s device-path Success,
    Precision and frame count."""
    from ptt_tpu_torch.config import ptt_config

    try:
        root = os.path.join(tmp, "agreement")
        for i, (pcs, boxes, _) in enumerate(agreement):
            write_kitti_scene(root, f"{i:04d}", pcs, {i: dict(enumerate(boxes))})
        frames = sum(len(t[0]) for t in agreement)
        base = ["--ckpt", ASSET, "--max_points", 1024, "--extra_tag", "chip_smoke_11a"]
        sets = ["--set", "DATA_CONFIG.DATA_PATH", root, "DATA_CONFIG.DATA_SPLIT", "test:all"]
        got = {}
        jobs = {path: base + flags + sets for path, flags in (("device", ["--eval_tag", "device"]),
                                                             ("host", ["--host_loop", "--eval_tag", "host"]))}
        started = {path: start_cli("test_tracking", args, device_launches=True) for path, args in jobs.items()}
        for path, args in jobs.items():  # side by side: their checks are results, not times
            rec, wall, _ = finish_cli("test_tracking", args, started[path], device_launches=True)
            got[path] = rec
            (ref_s, ref_p), lines = phase10[path], line_count(result_file("chip_smoke_11a", path))
            log(f"[11a] test CLI ({path} path) on the agreement tracklets as KITTI scenes 0000-0007: Success "
                f"{rec['success']:.2f} Precision {rec['precision']:.2f}, phase 10 {ref_s:.2f}/{ref_p:.2f} (delta "
                f"{rec['success'] - ref_s:+.2f}/{rec['precision'] - ref_p:+.2f}); {lines} lines of track_result.txt; "
                f"launches {rec['launches']}; CLI wall {wall:.1f} s (both paths side by side); card {card}")
            if not (abs(rec["success"] - ref_s) <= 1.0 and abs(rec["precision"] - ref_p) <= 1.0):
                fail(f"[11a] the test CLI's {path} path is not within 1.0 of phase 10's")
            if lines != frames:
                fail(f"[11a] track_result.txt holds {lines} lines, not {frames}")
        steps = 31
        if got["device"]["launches"]["fps"] != 2 * steps or got["device"]["launches"]["sa"] != 7 * steps:
            fail(f"[11a] device path launches {got['device']['launches']}, not 2 and 7 per step over {steps} steps")
        phase11a = {"success": got["device"]["success"], "precision": got["device"]["precision"], "frames": frames}

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
                                                     "DATA_CONFIG.DATA_PATH", root], device_launches=True)
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
    return phase11a


def kitti_loader_phase(root, device, card):
    """Phase 12's loader in this process, on the train split of the tree at
    ``root``: one item, a batch by threads alone and beside train steps, by
    the loader's processes alone, and the Trainer's loop fed by it against one
    pre-made batch, alternated. The epoch holds 20 batches, so each loader run
    first takes 8 of them."""
    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.data.loader import build_dataloader
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step

    cfg = ptt_config()
    t0 = time.perf_counter()
    dataset, loader = build_dataloader(dict(cfg["DATA_CONFIG"], DATA_PATH=root), cfg["CLASS_NAMES"], TRAIN_B,
                                       workers=LOADER_WORKERS, training=True)
    built = time.perf_counter() - t0
    model = build_network(cfg["MODEL"], device=device, train=True)
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader))
    step = make_train_step(cfg["MODEL"], device=device, graph=False)  # the eager step: these are its loop's times
    batch = next(iter(loader))
    median_step_ms(step, model, opt, [batch] * 2)  # warm-up
    one_item = item_ms(dataset)
    by_threads = thread_batches_ms(loader, 4)
    beside_threads, beside_step = thread_batches_ms(loader, 4, lambda: median_step_ms(step, model, opt, [batch]))
    by_processes = loader_batch_ms(loader, 6, warm=8)
    log(f"[12] the KITTI loader in this process ({len(dataset)} train items, {len(loader)} batches an epoch, built in "
        f"{built:.1f} s): one train item {one_item:.2f} ms in one thread (median of {TRAIN_B}); a batch by "
        f"{LOADER_WORKERS} threads {by_threads:.1f} ms alone, {beside_threads:.1f} ms beside train steps, which took "
        f"{beside_step:.1f} ms a step meanwhile; by the loader's {LOADER_WORKERS} processes {by_processes:.1f} ms a "
        f"batch alone")
    premade_vs_loader("[12]", step, model, opt, batch, loader, 6, card, warm=8)
    loader.close()
    del model, opt
    torch.cuda.empty_cache()


KITTI_TRAIN_FRAMES = 30  # the train CLI's scene 0000 in phase 12: 4 cars in each of its 30 sweeps
KITTI_TRAIN_STEPS = 10  # steps an epoch of it at B = 48 (4 items a car and frame)


def kitti_train_phase(model, batch, device, card):
    """Phase 12: the KITTI loader in this process (``kitti_loader_phase``, on
    a scene 0000 of 4 cars x 60 frames of 120,000 points); the train CLI at B
    = 48 on a scene 0000 of 4 cars x 30 such frames from the trained asset, two epochs and then a resumed third,
    TRAIN.WITH_EVAL on a shorter scene 0019; ``--eval_all`` over the three
    checkpoints; and a reference-layout .pth loaded with ``--ckpt``'s loader,
    against the asset loaded from the .npz."""
    import tempfile

    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.convert import reference_state_dict, state_dict_from_npz
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.checkpoint import load_params_from_file

    tmp = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    run_dir = os.path.join(REPO, "output", "kitti_models", "ptt", "chip_smoke_12")
    try:
        root, loader_root = os.path.join(tmp, "train"), os.path.join(tmp, "loader")
        rng = np.random.default_rng(12)
        write_kitti_scene(root, "0000", *sweep_scene(rng, KITTI_TRAIN_FRAMES, [KITTI_TRAIN_FRAMES] * 4))
        write_kitti_scene(root, "0019", *sweep_scene(rng, 40, [30, 40]))
        write_kitti_scene(loader_root, "0000", *sweep_scene(rng, 60, [60, 60, 60, 60]))
        kitti_loader_phase(loader_root, device, card)
        sets = ["--set", "DATA_CONFIG.DATA_PATH", root, "TRAIN.WITH_EVAL.ENABLE", "True",
                "TRAIN.WITH_EVAL.START_EPOCH", "0"]
        runs = []
        for first, epochs in ((0, 2), (2, 3)):  # two epochs in one process, then one more resumed
            rec, wall, text = run_cli("train_tracking", ["--pretrained_model", ASSET, "--epochs", epochs,
                                                         "--workers", LOADER_WORKERS,
                                                         "--extra_tag", "chip_smoke_12", *sets])
            runs.append(rec)
            n = rec["steps"][1] - rec["steps"][0]
            ev = {e: rec["eval"].get(str(e), {}) for e in range(first + 1, epochs + 1)}
            # the Trainer's line of each epoch: its loop's seconds and ms a step, before its checkpoint and eval
            per_epoch = re.findall(r"epoch (\d+)/\d+ .*?([\d.]+)s \((\d+) ms/it\)", text)
            log(f"[12] train CLI --epochs {epochs}: epochs {rec['epochs']}, steps {rec['steps']}, checkpoints "
                f"{rec['checkpoints']}; {1e3 * rec['train_seconds'] / max(n, 1):.1f} ms a step with the KITTI loader "
                f"({LOADER_WORKERS} processes, checkpoints included); each epoch's loop (epoch, s, ms a step): "
                f"{per_epoch}; launches {rec['launches']} ({ {k: v / max(n, 1) for k, v in rec['launches'].items()} } "
                f"a step); WITH_EVAL (Success, Precision, frames/s) "
                f"{ {e: (round(v.get('success', float('nan')), 2), round(v.get('precision', float('nan')), 2), round(v.get('frames_per_s', float('nan')), 1)) for e, v in ev.items()} }; "
                f"CLI wall {wall:.1f} s; card {card}")
            if rec["epochs"] != [first, epochs] or rec["checkpoints"] != list(range(1, epochs + 1)):
                fail(f"[12] --epochs {epochs}: epochs {rec['epochs']}, checkpoints {rec['checkpoints']}")
            if rec["launches"] != {"fps": 2 * n, "sa": 0, "group_fwd": 7 * n, "group_bwd": 7 * n, "tf32x3": 0} or \
                    n != KITTI_TRAIN_STEPS * (epochs - first):
                fail(f"[12] {n} steps with launches {rec['launches']}, not {KITTI_TRAIN_STEPS} steps an epoch of "
                     f"2 FPS + 7 + 7 group")
            if any(not v for v in ev.values()):
                fail(f"[12] TRAIN.WITH_EVAL did not score every epoch of {rec['epochs']}")
        if runs[1]["steps"][0] != runs[0]["steps"][1]:
            fail(f"[12] the resumed run starts at step {runs[1]['steps'][0]}, not {runs[0]['steps'][1]}")
        rec, wall, _ = run_cli("test_tracking", ["--eval_all", "--ckpt_dir", os.path.join(run_dir, "ckpt"),
                                                 "--max_waiting_mins", 0, "--extra_tag", "chip_smoke_12",
                                                 "--set", "DATA_CONFIG.DATA_PATH", root])
        with open(os.path.join(run_dir, "eval", "default", "eval_list.txt")) as fh:
            evals = fh.read().splitlines()
        log(f"[12] test CLI --eval_all: eval_list.txt {evals}; launches {rec['launches']}; CLI wall {wall:.1f} s; "
            f"card {card}")
        if [line.split()[0] for line in evals] != ["1", "2", "3"]:
            fail("[12] --eval_all did not evaluate checkpoints 1, 2 and 3 once each")

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


# ------------------------------------------------------------ data parallelism (phase 18)

DIST_RANKS = 2  # ranks that share the one card, on the gloo backend (NCCL refuses two ranks on one device)
DIST_STEPS = 3
DIST_TIMED = 3  # steps timed after the compared ones
DIST_TIMEOUT = 600  # seconds a torchrun of the ranks may take
DIST_STEP0_RTOL = 1e-4  # step 0 against one process: PERF.md section 2's step-0 band
DIST_FAULT_RTOL = 5e-2  # steps 1-2: FPS picks may flip with the summation order; beyond this, a fault
ADAM_EPS_FACTOR = 10  # parameters are held where the clipped gradient is at least 10 x Adam's eps


def run_ranks(argv, tag):
    """``python -m torch.distributed.run --standalone --nproc_per_node DIST_RANKS
    argv`` from the repo root, in a process group of its own that is killed at
    DIST_TIMEOUT; fails the run unless every rank exited 0. Returns the output."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(DIST_RANKS),
           *map(str, argv)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DIST_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        log(out[-4000:])
        fail(f"{tag}: the ranks did not finish within {DIST_TIMEOUT} s")
    if proc.returncode != 0:
        log(out[-6000:])
        fail(f"{tag}: torchrun exited with {proc.returncode}")
    return out


def dist_train_rank(job_dir) -> int:
    """Phase 18a, one rank under torchrun (``chip_smoke.py --train-rank DIR``):
    the port's data-parallel step on its shard ([rank::world]) of the global
    batches in DIR, from the trained asset, on the kernels; saves the metrics,
    the averaged gradient and state after step 0, the state after the last
    step, the launch counts and DIST_TIMED step times to DIR/rank<r>.pt."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.tools import kernel_launches
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step
    from ptt_tpu_torch.utils.dist import barrier, broadcast_module, init_distributed

    rank, world, device = init_distributed("gloo", "env://", "cuda:0")
    try:
        cfg = ptt_synth_config()
        job = torch.load(os.path.join(job_dir, "job.pt"), weights_only=False)
        model = build_network(cfg["MODEL"], device=device, train=True)
        if rank == 0:
            model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
        broadcast_module(model)
        opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], job["iters_per_epoch"])
        step = make_train_step(cfg["MODEL"], device=device)
        shards = [{k: v[rank::world] for k, v in b.items()} for b in job["batches"]]
        out = {"metrics": []}
        for i, shard in enumerate(shards):
            out["metrics"].append({k: float(v) for k, v in step(model, opt, shard).items()})
            if i == 0:
                out["grads"] = {n: p.grad.to("cpu", copy=True) for n, p in model.named_parameters()}
                out["state0"] = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        out["state"] = {k: v.to("cpu", copy=True) for k, v in model.state_dict().items()}
        out["launches"] = kernel_launches()
        out["graph"] = step.steps.mode
        out["ms"] = []
        for _ in range(DIST_TIMED):
            torch.cuda.synchronize(device)
            barrier()
            t0 = time.perf_counter()
            step(model, opt, shards[0])
            torch.cuda.synchronize(device)
            barrier()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
        torch.save(out, os.path.join(job_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def dist_train_phase(device, card, tmp):
    """Phase 18a: two ranks on the one card against one process, both at full
    ptt_synth.yaml width from the trained asset on the kernels, global B = 48
    (24 a rank) on the same batches: step 0 within DIST_STEP0_RTOL, steps 1-2
    reported, the ranks bit-equal after DIST_STEPS steps, ms a step alternated
    (one process, the ranks, one process)."""
    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step

    cfg = ptt_synth_config()
    loader, batches = train_batches(cfg["DATA_CONFIG"], DIST_STEPS)
    loader.close()
    job_dir = os.path.join(tmp, "dist_train")
    os.makedirs(job_dir)
    torch.save({"batches": batches, "iters_per_epoch": len(loader)}, os.path.join(job_dir, "job.pt"))

    model = build_network(cfg["MODEL"], device=device, train=True)
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader))
    # eager, as the ranks' steps are: it reads each step's gradient, which a graphed step keeps in its pool
    step = make_train_step(cfg["MODEL"], device=device, graph=False)
    one = []
    for i, batch in enumerate(batches):
        one.append({k: float(v) for k, v in step(model, opt, batch).items()})
        if i == 0:
            grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
            state0 = {k: v.clone() for k, v in model.state_dict().items()}
    one_ms = [median_step_ms(step, model, opt, [batches[0]] * DIST_TIMED)]
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    run_ranks([__file__, "--train-rank", job_dir], "[18a]")
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(job_dir, f"rank{r}.pt"), weights_only=False) for r in range(DIST_RANKS)]
    one_ms.append(median_step_ms(step, model, opt, [batches[0]] * DIST_TIMED))

    r0 = ranks[0]
    step0 = {k: abs(r0["metrics"][0][k] - one[0][k]) / max(abs(one[0][k]), 1e-12) for k in one[0]}
    g_scale = max(float(g.abs().max()) for g in grads.values())
    grad_err = max(float((r0["grads"][n].to(device) - g).abs().max()) for n, g in grads.items()) / g_scale
    stats_err = max(relerr(r0["state0"][k].to(device).float(), v.float()) for k, v in state0.items() if "running_" in k)
    # Adam's first update is g / (|g| + eps): where the clipped gradient is near eps (rounding noise, a
    # parameter the BatchNorm after it makes flat) it moves by up to ~lr under any summation order
    lr, eps = float(cfg["OPTIMIZATION"]["LR"]), float(cfg["OPTIMIZATION"]["EPS"])
    clip = min(1.0, float(cfg["OPTIMIZATION"]["GRAD_NORM_CLIP"]) / one[0]["grad_norm"])
    held_err, noisy, noisy_move, n_params = 0.0, 0, 0.0, 0
    for n, g in grads.items():
        diff = (r0["state0"][n].to(device) - state0[n]).abs()
        well = (g * clip).abs() >= ADAM_EPS_FACTOR * eps
        held_err = max(held_err, float(diff[well].max()) / float(state0[n].abs().max()) if well.any() else 0.0)
        noisy += int((~well).sum())
        noisy_move = max(noisy_move, float(diff[~well].max()) / lr if (~well).any() else 0.0)
        n_params += g.numel()
    later = [{k: abs(r0["metrics"][i][k] - one[i][k]) / max(abs(one[i][k]), 1e-12) for k in ("loss", "grad_norm")}
             for i in range(1, DIST_STEPS)]
    equal = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ranks[0]["state"])
    rank_ms = [float(np.median(r["ms"])) for r in ranks]
    log(f"[18a] {DIST_RANKS} ranks on one card (gloo), ptt_synth.yaml full width, global B = {TRAIN_B} "
        f"({TRAIN_B // DIST_RANKS} a rank), from the trained asset on the kernels, against one process on the same "
        f"batches: step 0 rel diff {({k: f'{v:.1e}' for k, v in step0.items()})}; averaged gradient max |diff| "
        f"{grad_err:.1e} of the largest entry; BatchNorm running statistics {stats_err:.1e}; parameters where the "
        f"clipped gradient is >= {ADAM_EPS_FACTOR} x eps {held_err:.1e} (relative to each tensor's largest entry), "
        f"the other {noisy} of {n_params} entries moved by at most {noisy_move:.2f} lr; steps 1-2 rel diff "
        f"{[{k: f'{v:.1e}' for k, v in d.items()} for d in later]}; ranks bit-equal after {DIST_STEPS} steps "
        f"{equal}; launches a rank over {DIST_STEPS} steps {[r['launches'] for r in ranks]}")
    log(f"[18a] ms a step (median of {DIST_TIMED}), alternated: one process {one_ms[0]:.1f}, {DIST_RANKS} ranks "
        f"{rank_ms} (a step ends when both ranks end), one process {one_ms[1]:.1f}; torchrun wall {wall:.1f} s; "
        f"card {card}")
    if max(step0.values()) > DIST_STEP0_RTOL or grad_err > DIST_STEP0_RTOL or stats_err > DIST_STEP0_RTOL \
            or held_err > DIST_STEP0_RTOL:
        fail(f"[18a] step 0 of the ranks is not within rel {DIST_STEP0_RTOL} of the one-process step")
    if any(max(d.values()) > DIST_FAULT_RTOL for d in later):
        fail(f"[18a] steps 1-2 of the ranks differ from one process beyond rel {DIST_FAULT_RTOL}")
    if not equal or ranks[0]["metrics"] != ranks[1]["metrics"]:
        fail("[18a] the two ranks' states differ after training")
    want = {"fps": 2 * DIST_STEPS, "sa": 0, "group_fwd": 7 * DIST_STEPS, "group_bwd": 7 * DIST_STEPS, "tf32x3": 0}
    if any(r["launches"] != want for r in ranks):
        fail(f"[18a] launches a rank {[r['launches'] for r in ranks]}, not {want}")
    # 21f: under a process group the train step stays eager (gloo's collectives run from the host)
    modes = [r["graph"] for r in ranks]
    log(f"[18a] (21f) the ranks' train step, made with the graph asked for: graph {modes}")
    if modes != [f"off (process group of {DIST_RANKS} ranks on gloo)"] * DIST_RANKS:
        fail(f"[18a] the ranks' train step mode {modes}, not eager under the process group")
    del model, opt
    torch.cuda.empty_cache()
    return {"one_process_ms": one_ms, "ranks_ms": rank_ms, "step0": step0, "grad_err": grad_err}


def dist_test_phase(root, phase11a, model, device, card, tmp):
    """Phase 18b: the test CLI as two ranks under torchrun on one card
    (``--launcher pytorch --dist_backend gloo --device cuda:0``) on phase 11a's
    KITTI tree of the agreement tracklets: the two result files hold 11a's
    frames, the merged Success/Precision within 1.0 of 11a's, and each rank's
    lines equal a one-process run (in this process) on that rank's shard."""
    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.data.kitti import KittiTrackingDataset
    from ptt_tpu_torch.eval.device_loop import eval_one_epoch_device

    tag = "chip_smoke_18"
    try:
        t0 = time.perf_counter()
        out = run_ranks(["-m", "ptt_tpu_torch.tools.test_tracking", "--launcher", "pytorch", "--dist_backend", "gloo",
                         "--device", "cuda:0", "--ckpt", ASSET, "--max_points", 1024, "--extra_tag", tag,
                         "--eval_tag", "device", "--set", "DATA_CONFIG.DATA_PATH", root, "DATA_CONFIG.DATA_SPLIT",
                         "test:all"], "[18b]")
        wall = time.perf_counter() - t0
        records = [json.loads(line.split("  summary ", 1)[1]) for line in out.splitlines() if "  summary {" in line]
        if len(records) != 1:
            fail(f"[18b] {len(records)} summary lines, not rank 0's one")
        rec = records[0]
        data_dir = os.path.dirname(result_file(tag, "device"))
        files = [os.path.join(data_dir, f"track_result.rank{r}.txt") for r in range(DIST_RANKS)]
        lines = [line_count(f) for f in files]
        frames = phase11a["frames"]
        cfg = ptt_config()
        cfg["DATA_CONFIG"]["DATA_PATH"] = root
        ds = KittiTrackingDataset(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], training=False)
        items = [ds[i] for i in range(len(ds))]
        same = []
        for r in range(DIST_RANKS):
            one_dir = os.path.join(tmp, f"dist_one{r}")
            eval_one_epoch_device(cfg, model, [items[r::DIST_RANKS]], max_points=1024, batch_size=8,
                                  result_dir=one_dir, device=device)
            with open(files[r]) as a, open(os.path.join(one_dir, "final_result", "data", "track_result.txt")) as b:
                same.append(a.read() == b.read())
        ds_, dp_ = rec["success"] - phase11a["success"], rec["precision"] - phase11a["precision"]
        steps = 32 - 1
        log(f"[18b] test CLI as {DIST_RANKS} ranks (torchrun, gloo, cuda:0) on 11a's tree: merged Success "
            f"{rec['success']:.2f} Precision {rec['precision']:.2f} (11a {phase11a['success']:.2f}/"
            f"{phase11a['precision']:.2f}, delta {ds_:+.2f}/{dp_:+.2f}); result lines a rank {lines} (11a {frames}); "
            f"each rank's lines equal to one process on its shard {same}; rank 0 launches {rec['launches']}, "
            f"{rec['frames_per_s']:.1f} frames/s a rank; torchrun wall {wall:.1f} s; card {card}")
        if sum(lines) != frames or rec.get("world_size") != DIST_RANKS:
            fail(f"[18b] the rank files hold {lines} lines, not {frames} in all")
        if abs(ds_) > 1.0 or abs(dp_) > 1.0:
            fail("[18b] the merged Success/Precision are not within 1.0 of phase 11a's")
        if not all(same):
            fail("[18b] a rank's result lines differ from one process's on its shard")
        if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
            fail(f"[18b] rank 0 launches {rec['launches']}, not 2 FPS and 7 SA a step over {steps} steps")
    finally:
        shutil.rmtree(os.path.join(REPO, "output", "kitti_models", "ptt", tag), ignore_errors=True)
    return {"success": rec["success"], "precision": rec["precision"], "lines": lines}


# ------------------------------------------------------ ptt_waymo, bf16, optimizers, nuScenes (phases 13-16)


def waymo_cli_phase(root, card):
    """Phase 13b: the test CLI with ptt_waymo.yaml on phase 11b's scene 0019
    (150 sweeps of 120,000 points, max_points 16384, seeded init). Returns its
    result lines, frames/s and Success/Precision (phase 20b's reference)."""
    steps = 160 - 1
    rec, wall, text = run_cli("test_tracking", ["--cfg_file", "tools/cfgs/kitti_models/ptt_waymo.yaml", "--batch_size", 8,
                                                "--extra_tag", "chip_smoke_13b", "--set", "DATA_CONFIG.DATA_PATH", root],
                              device_launches=True)
    log(f"[13b] test CLI ptt_waymo.yaml on scene 0019 (150 x 120,000-point sweeps, max_points 16384, batch 8, "
        f"seeded init): {rec['frames_per_s']:.1f} frames/s, Success {rec['success']:.2f} Precision "
        f"{rec['precision']:.2f} (seeded weights: not a gate), CLI wall {wall:.1f} s; launches {rec['launches']} over "
        f"{steps} frame steps; the one-device POINT_SHARDING line logged "
        f"{'the point axis' in text and 'is not split' in text}; card {card}")
    if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
        fail(f"[13b] launches {rec['launches']}, not 2 FPS and 7 SA per step over {steps} steps")
    if not ("the point axis" in text and "is not split" in text):
        fail("[13b] the test CLI did not log that POINT_SHARDING splits nothing on one device")
    data = os.path.join(REPO, "output", "kitti_models", "ptt_waymo", "chip_smoke_13b", "eval", "default",
                        "final_result", "data")
    with open(os.path.join(data, "track_result.txt")) as fh:
        lines = fh.read().splitlines()
    shutil.rmtree(os.path.join(REPO, "output", "kitti_models", "ptt_waymo"), ignore_errors=True)
    return {"lines": lines, "frames_per_s": rec["frames_per_s"], "success": rec["success"],
            "precision": rec["precision"]}


def waymo_train_phase(device, card):
    """Phase 14: ptt_waymo.yaml training at B = 48 on synthetic items resampled
    to 8192 / 2048 points, on the port's seeded init: the group kernels at the 7
    shapes of its step and a heavy-duplication cloud, then steps: launches, ms
    a step, peak memory. Returns phase 6's rows at these shapes."""
    from ptt_tpu_torch.config import config_by_path, ptt_synth_config
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.ops import group
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
    step = make_train_step(cfg["MODEL"], device=device, graph=False)  # eager: phase 21d takes the graphed step
    torch.cuda.reset_peak_memory_stats()
    timer.reset()
    losses = [float(step(model, opt, b)["loss"]) for b in batches]
    launches = launch_counts()
    ms = median_step_ms(step, model, opt, [batches[0]] * 5)
    peak = torch.cuda.max_memory_allocated()
    log(f"[14] the loader at 8192 / 2048 points: one train item {item_ms(loader.dataset):.2f} ms in one thread "
        f"(median of {TRAIN_B}), {loader_batch_ms(loader, 8):.1f} ms a batch by its {LOADER_WORKERS} processes alone")
    premade_vs_loader("[14]", step, model, opt, batches[0], loader, 3, card, warm=LOADER_WORKERS)
    loader.close()
    log(f"[14] ptt_waymo train steps at B = {TRAIN_B}: losses {[f'{x:.4f}' for x in losses]}; launches {launches} "
        f"over 3 steps; {ms:.1f} ms a step on one pre-made batch (median of 5); peak device memory {peak} bytes "
        f"({peak / 2**30:.2f} GiB); card {card}")
    if not all(np.isfinite(losses)):
        fail("[14] ptt_waymo training: non-finite loss")
    if launches != {"fps": 6, "sa": 0, "group_fwd": 21, "group_bwd": 21, "tf32x3": 0}:
        fail(f"[14] ptt_waymo training launches {launches}, not 2 FPS and 7 + 7 group a step")
    del model, opt
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()  # the later phases' peaks are their own
    return rows


# ------------------------------------------------------------ the captured train step (phase 21)

TRAIN_KERNELS = ("fps_kernel", "group_fwd_kernel") + BWD_KERNELS
# graph against eager from one state may differ by up to this many times what two eager runs from that state
# differ by (torch.gather's backward scatters with atomics), and by at least this relative floor
WITNESS_FACTOR = 10
WITNESS_FLOOR = 1e-6
GRAPH_TIMED = 4  # steps a timed run of phase 21c, 1 dispatch of K = 4
GRAPH_TRACED = 4  # steps phase 21c profiles, one dispatch of K = 4, after as many


def params_err(got, want) -> float:
    """Largest |difference| of two parameter lists, relative to each tensor's largest entry."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30) for a, b in zip(got, want))


def train_runs(step, model, opt, batches, marks=(1, 4, 5)):
    """``step`` over ``batches`` from the model's state: each step's metrics
    and the parameters after the steps in ``marks``."""
    metrics, params = [], {}
    for i, batch in enumerate(batches, 1):
        metrics.append(step(model, opt, batch))
        if i in marks:
            params[i] = [p.detach().clone() for p in model.parameters()]
    return metrics, params


def witness_check(tag, got, want, witnesses) -> dict:
    """``got`` against ``want`` (each ``train_runs``' result from one state on
    the same batches): step 0's loss terms torch.equal; the first and the last
    step's grad_norm and the parameters at each mark within WITNESS_FACTOR x
    the most that a run of ``witnesses`` (``want``'s path again) differs from
    ``want`` by. The other steps' losses are reported: a near-tie among the
    votes makes FPS pick another point in one run and not in another, so two
    free runs part by jumps from step 2 on. Fails otherwise; returns the
    differences."""
    (gm, gp), (wm, wp) = got, want
    step0 = {k: bool(torch.equal(gm[0][k], wm[0][k])) for k in LOSS_TERMS}
    rows, bad = {}, []

    def row(name, d, w, held):
        rows[name] = (d, w)
        if held and d > WITNESS_FACTOR * max(w, WITNESS_FLOOR):
            bad.append(name)

    last = len(gm) - 1
    for i in range(len(gm)):
        for k in ("loss", "grad_norm"):
            row(f"step {i} {k}", relerr(gm[i][k], wm[i][k]), max(relerr(x[0][i][k], wm[i][k]) for x in witnesses),
                k == "grad_norm" and i in (0, last))
    for i in gp:
        row(f"params after {i}", params_err(gp[i], wp[i]), max(params_err(x[1][i], wp[i]) for x in witnesses), True)
    log(f"{tag} step 0's loss terms torch.equal {step0}; rel diff (this, the witness): "
        + ", ".join(f"{k} ({d:.1e}, {w:.1e})" for k, (d, w) in rows.items()))
    if not all(step0.values()):
        fail(f"{tag} step 0's loss terms differ")
    if bad:
        fail(f"{tag} beyond {WITNESS_FACTOR} x the witness (floor {WITNESS_FLOOR}): {bad}")
    return {k: list(v) for k, v in rows.items()}


def same_runs(a, b) -> bool:
    """Every metric of every step and the parameters at every mark torch.equal."""
    return all(torch.equal(x[k], y[k]) for x, y in zip(a[0], b[0]) for k in x) and \
        all(torch.equal(x, y) for i in a[1] for x, y in zip(a[1][i], b[1][i]))


def traced_run(fn) -> dict:
    """``fn()`` in the port's profiler window: wall and host ms (until ``fn``
    returned), the device's busy ms (the union of its kernels, copies and
    sets) and idle share, and the launches of each training kernel."""
    def run():
        t0 = time.perf_counter()
        fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        return host, time.perf_counter() - t0

    window, (host, wall), seen = traced_window(run, "a traced run")
    if not seen:
        fail("the profiler saw no device activity in a traced run")
    device = window.events
    union = busy_us(device)
    kernels = [e.name for e in device if e.kind == "kernel"]
    return {"wall_ms": wall * 1e3, "host_ms": host * 1e3, "busy_ms": union / 1e3,
            "idle_share": 1 - union / 1e3 / (wall * 1e3),
            "launches": {k: sum(k in name for name in kernels) for k in TRAIN_KERNELS}}


class Scalars:
    """A tensorboard writer that keeps the scalars it is given."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, float(value), step))


def graph_entry(steps):
    """The one captured graph of a ``TrainStep``."""
    entries = steps.graphs.values()
    if len(entries) != 1 or entries[0].graph is None:
        fail(f"expected one captured graph, found {len(entries)}")
    return entries[0]


def train_graph_phase(device, card):
    """Phase 21: the train step as one CUDA graph (``train/train_step.py``
    ``TrainStep``), ptt_synth.yaml at B = 48 from the trained asset on the
    kernels. (a) 5 replays of the one-step graph against 5 eager steps from
    one state on the same batches, beside the eager steps again (the
    witness); launches a replay, by the wrappers' counts and by the device;
    (b) one replay of the K = 4 graph (captured in the one-step graph's
    pool, as a Trainer's are) against 4 replays of the one-step graph
    and 4 eager steps, and its table of hyperparameters against the
    optimizer's schedules; (c) ms a step of the Trainer's loop over pre-made
    batches, eager and graphed, K = 1 and 4, alternated, each also traced
    (idle share, exact launches), capture seconds and pool MB; (d) a graphed
    bf16 step against an eager one, and a graphed ptt_waymo.yaml step with
    its peak memory; (e) the Trainer at STEPS_PER_DISPATCH = 4 over 5 steps an
    epoch (4 and a tail of 1), two epochs graphed and eager under
    deterministic algorithms, checkpoints and a resumed epoch; (f)
    ``shared_pool_phase``. Returns the
    numbers."""
    from ptt_tpu_torch.config import config_by_path, ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import BatchUploader, make_multi_step, make_train_step, stack_batches
    from ptt_tpu_torch.train.trainer import Trainer, pipelined_steps
    from ptt_tpu_torch.utils.cuda_graph import CaptureContext, read_launches

    t_phase = time.perf_counter()
    cfg = ptt_synth_config()
    model_cfg, optim_cfg = cfg["MODEL"], cfg["OPTIMIZATION"]
    loader, batches = train_batches(cfg["DATA_CONFIG"], 6, seed=21, workers=0)  # no fork server in its process
    n_iters = len(loader)
    loader.close()
    weights = state_dict_from_npz(ASSET)
    out = {}

    def fresh():
        net = build_network(model_cfg, device=device, train=True)
        net.load_state_dict(weights, strict=True)
        return net, Optimizer(net.parameters(), optim_cfg, n_iters)

    def zero_counts():
        timer.reset()

    # (a) the one-step graph: its key's first dispatch (the eager warm-up step, then the capture) on batch 5, the
    # state put back in place (the graph reads the parameters, statistics and moments by address), 5 replays
    model, opt = fresh()
    start = opt.state_dict()

    def reset():
        model.load_state_dict(weights, strict=True)
        opt.load_state_dict(start)

    eager_step = make_train_step(model_cfg, device=device, graph=False)
    eager = train_runs(eager_step, *fresh(), batches[:5])
    witness = [train_runs(eager_step, *fresh(), batches[:5]) for _ in range(2)]
    context = CaptureContext(device)  # one pool and stream for step1 and multi4, as a Trainer's two steps
    step1 = make_train_step(model_cfg, device=device, context=context)
    if step1.steps.mode != "on":
        fail(f"[21a] the train step's graph mode is {step1.steps.mode!r} on one GPU")
    t0 = time.perf_counter()
    step1(model, opt, batches[5])
    torch.cuda.synchronize()
    first1 = time.perf_counter() - t0
    g1 = graph_entry(step1.steps).graph
    reset()
    zero_counts()
    graphed = train_runs(step1, model, opt, batches[:5])
    replays = dict(zip(("fps", "sa", "group_fwd", "group_bwd"), read_launches()))
    losses = [float(m["loss"]) for m in graphed[0]]
    log(f"[21a] ptt_synth.yaml train step graph (B = {TRAIN_B}, from the asset): first dispatch {first1:.2f} s "
        f"(eager step, then capture {g1.capture_s:.2f} s), pool {g1.pool_bytes() / 2**20:.1f} MB; 5 replays from the "
        f"asset's state: losses {[f'{x:.6f}' for x in losses]} (eager {[f'{float(m['loss']):.6f}' for m in eager[0]]})"
        f"; launches a replay (fps, sa, group fwd, group bwd) {g1.launches}, the counters over 5 replays {replays}")
    out["a"] = witness_check("[21a] graph against eager:", graphed, eager, witness)
    out["a_launches"] = replays
    if len(set(losses)) != 5:
        fail("[21a] the 5 replays' losses are not 5 values (a replay's output read after the next)")
    if g1.launches != (2, 0, 7, 7, 0) or replays != {"fps": 10, "sa": 0, "group_fwd": 35, "group_bwd": 35}:
        fail(f"[21a] launches a replay {g1.launches}, over 5 replays {replays}: not 2 FPS + 7 + 7 group a step")
    # under deterministic algorithms (the gather's backward without atomics) graph and eager are one arithmetic
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det_eager = train_runs(eager_step, *fresh(), batches[:5])
        det_step = make_train_step(model_cfg, device=device)
        reset()
        det_step(model, opt, batches[5])
        reset()
        det_graph = train_runs(det_step, model, opt, batches[:5])
    finally:
        torch.use_deterministic_algorithms(False)
    out["a_deterministic_equal"] = same_runs(det_graph, det_eager)
    log(f"[21a] under torch.use_deterministic_algorithms: 5 replays of a graph captured there against 5 eager "
        f"steps, every metric and the parameters after 1, 4 and 5 steps torch.equal {out['a_deterministic_equal']}")
    if not out["a_deterministic_equal"]:
        fail("[21a] under deterministic algorithms the graphed steps differ from the eager ones")
    det_step.steps.close()

    # (b) one K = 4 dispatch against 4 replays of the one-step graph and 4 eager steps; the K = 4 graph is the
    # context's second: its first dispatch is its capture and a replay, no eager run
    multi4 = make_multi_step(model_cfg, 4, device=device, context=context)
    reset()
    t0 = time.perf_counter()
    multi4(model, opt, stack_batches([batches[5]] * 4))
    torch.cuda.synchronize()
    first4 = time.perf_counter() - t0
    entry4 = graph_entry(multi4)
    g4 = entry4.graph
    reset()
    k4_metrics = multi4.metrics(multi4(model, opt, stack_batches(batches[:4])))
    table = entry4.state[1].cpu()
    want = torch.tensor([[opt.lr_schedule(c), b1, 1.0 - b1, 1.0 - b1 ** (c + 1), 1.0 - opt.b2 ** (c + 1)]
                         for c in range(4) for b1 in [opt.b1 if opt.mom_schedule is None else opt.mom_schedule(c)]],
                        dtype=torch.float32)
    k4 = (k4_metrics, {4: [p.detach().clone() for p in model.parameters()]})
    reset()
    k1 = train_runs(step1, model, opt, batches[:4], marks=(4,))
    eager4 = (eager[0][:4], {4: eager[1][4]})
    witness4 = [(w[0][:4], {4: w[1][4]}) for w in witness]
    log(f"[21b] the K = 4 graph: first dispatch {first4:.2f} s (capture {g4.capture_s:.2f} s, then a replay), pool "
        f"{g4.pool_bytes() / 2**20:.1f} MB shared with the one-step graph (one pool {tuple(g4.pool) == tuple(g1.pool)}), "
        f"launches a replay {g4.launches}; its table of updates 0-3 (lr, b1, 1 - b1, "
        f"corrections) {table.tolist()}, equal to the optimizer's schedules {torch.equal(table, want)}")
    out["b_vs_eager"] = witness_check("[21b] one K = 4 replay against 4 eager steps:", k4, eager4, witness4)
    out["b_vs_k1"] = witness_check("[21b] one K = 4 replay against 4 replays of the one-step graph:", k4, k1, witness4)
    if not torch.equal(table, want):
        fail("[21b] the K = 4 graph's table is not the optimizer's schedules")
    if tuple(g4.pool) != tuple(g1.pool):
        fail("[21b] the K = 4 graph is not in the one-step graph's pool")
    if g4.launches != (8, 0, 28, 28, 0):
        fail(f"[21b] launches a K = 4 replay {g4.launches}, not 4 x (2 FPS + 7 + 7 group)")

    # (c) the Trainer's loop over pre-made batches, eager and graphed, K = 1 and 4, alternated
    eager_multi = make_multi_step(model_cfg, 4, device=device, graph=False)
    uploader = BatchUploader(device)
    timed = (batches[:4] * (GRAPH_TIMED // 4))
    variants = {"eager K=1": (eager_step, None), "graph K=1": (step1, None),
                "eager K=4": (eager_step, eager_multi), "graph K=4": (step1, multi4)}

    def loop(name, data):
        step, multi = variants[name]
        return len(pipelined_steps(step, model, opt, data, uploader, multi_step=multi))

    for name in variants:
        loop(name, batches[:4])  # warm-up
    ms = {name: [] for name in variants}
    for name in list(variants) + list(variants)[::-1]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = loop(name, timed)
        torch.cuda.synchronize()
        ms[name].append((time.perf_counter() - t0) * 1e3 / n)
    traced = batches[:GRAPH_TRACED]
    traces = {name: traced_run(lambda: loop(name, traced)) for name in variants}
    for name, tr in traces.items():
        log(f"[21c] {name}: {ms[name][0]:.1f}, {ms[name][1]:.1f} ms a step (the Trainer's loop, {GRAPH_TIMED} steps "
            f"a run); in the profiler's window ({GRAPH_TRACED} steps): wall {tr['wall_ms'] / GRAPH_TRACED:.1f} ms a "
            f"step, host {tr['host_ms'] / GRAPH_TRACED:.1f}, device busy {tr['busy_ms'] / GRAPH_TRACED:.1f} "
            f"({100 * tr['idle_share']:.1f}% idle), launches {tr['launches']}")
    log(f"[21c] capture: K = 1 {g1.capture_s:.2f} s, pool {g1.pool_bytes() / 2**20:.1f} MB; K = 4 {g4.capture_s:.2f} s, "
        f"pool {g4.pool_bytes() / 2**20:.1f} MB; card {card}")
    out["c"] = {"ms": ms, "traces": traces, "capture_s": [g1.capture_s, g4.capture_s],
                "pool_mb": [g1.pool_bytes() / 2**20, g4.pool_bytes() / 2**20], "first_dispatch_s": [first1, first4]}
    # the device's count of every traced run's launches, eager and graphed: 2 FPS + 7 + 3 x 7 group kernels a step
    want = {"fps_kernel": 2 * GRAPH_TRACED, "group_fwd_kernel": 7 * GRAPH_TRACED,
            **{k: 7 * GRAPH_TRACED for k in BWD_KERNELS}}
    for name, tr in traces.items():
        if tr["launches"] != want:
            fail(f"[21c] {name}: the device ran {tr['launches']} in {GRAPH_TRACED} steps, not {want}")

    # (d) a graphed bf16 step against the eager one from the asset's state
    step16 = make_train_step(model_cfg, device=device, mixed_precision=True)
    eager16 = make_train_step(model_cfg, device=device, mixed_precision=True, graph=False)
    want16 = eager16(*fresh(), batches[0])
    reset()
    step16(model, opt, batches[5])
    reset()
    got16 = step16(model, opt, batches[0])
    equal16 = {k: bool(torch.equal(got16[k], want16[k])) for k in LOSS_TERMS}
    log(f"[21d] bf16 (MIXED_PRECISION) graph: a replay's loss {float(got16['loss']):.6f}, the eager bf16 step's "
        f"{float(want16['loss']):.6f}, loss terms torch.equal {equal16}; capture "
        f"{graph_entry(step16.steps).graph.capture_s:.2f} s")
    if not all(np.isfinite(float(v)) for v in got16.values()):
        fail("[21d] the graphed bf16 step is not finite")
    out["d_bf16_equal"] = equal16
    for steps in (step1.steps, multi4, step16.steps):
        steps.close()
    del model, opt, eager, witness, graphed, k4, k1, eager4, witness4, want16, got16, det_eager, det_graph
    gc.collect()
    torch.cuda.empty_cache()

    # (d) a graphed ptt_waymo.yaml step at B = 48 (8192 / 2048 points), seeded init: peak memory against phase 14's
    # eager step
    wcfg = config_by_path("kitti_models/ptt_waymo.yaml")
    wloader, wbatches = train_batches(dict(cfg["DATA_CONFIG"], SEARCH_INPUT_SIZE=8192, TEMPLATE_INPUT_SIZE=2048), 2)
    wloader.close()
    torch.manual_seed(SEED)
    wmodel = build_network(wcfg["MODEL"], device=device, train=True)
    wopt = Optimizer(wmodel.parameters(), optim_cfg, len(wloader))
    wstep = make_train_step(wcfg["MODEL"], device=device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wlosses = [float(wstep(wmodel, wopt, b)["loss"]) for b in wbatches]
    wall = time.perf_counter() - t0
    peak, peak_reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
    gw = graph_entry(wstep.steps).graph
    log(f"[21d] ptt_waymo.yaml graph, B = {TRAIN_B}: losses {[f'{x:.4f}' for x in wlosses]} (the first dispatch, "
        f"then a replay) in {wall:.1f} s, capture {gw.capture_s:.2f} s, pool {gw.pool_bytes() / 2**30:.2f} GiB, "
        f"launches a replay {gw.launches}; peak device memory {peak / 2**30:.2f} GiB allocated, "
        f"{peak_reserved / 2**30:.2f} GiB reserved (phase 14's line gives its eager steps'); card {card}")
    out["d_waymo"] = {"losses": wlosses, "peak_gib": peak / 2**30, "peak_reserved_gib": peak_reserved / 2**30,
                      "pool_gib": gw.pool_bytes() / 2**30, "capture_s": gw.capture_s}
    if not all(np.isfinite(wlosses)) or gw.launches != (2, 0, 7, 7, 0):
        fail("[21d] the graphed ptt_waymo step is not finite or does not launch 2 FPS + 7 + 7 group a step")
    wstep.steps.close()
    del wmodel, wopt, wstep, gw
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (e) the Trainer at STEPS_PER_DISPATCH = 4 over 5 steps an epoch: one K = 4 dispatch and a tail of one;
    # two epochs graphed and eager from one state on the same batches under
    # deterministic algorithms (the second epoch replays both graphs), then a resumed third epoch
    out_dir = os.path.join(REPO, "build", "chip_smoke_train_graph")
    shutil.rmtree(out_dir, ignore_errors=True)
    small = dict(cfg["DATA_CONFIG"], NUM_TRACKLETS=10, FRAMES_PER_TRACKLET=6)  # 240 items: 5 steps of TRAIN_B = 48
    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    logger = logging.getLogger("chip_smoke.21e")
    logger.setLevel(logging.INFO)
    logger.addHandler(Lines())

    def trainer(total_epochs, scalars, run, graph=True):
        net = build_network(model_cfg, device=device, train=True)
        net.load_state_dict(weights, strict=True)
        small_loader = DataLoader(SyntheticTrackingDataset(small), TRAIN_B, shuffle=True, drop_last=True,
                                  num_workers=0)  # the same batches; no fork server in phase 21's process
        return Trainer(net, model_cfg, dict(optim_cfg, STEPS_PER_DISPATCH=4), small_loader,
                       os.path.join(out_dir, run), logger, total_epochs=total_epochs, device=device,
                       tb_writer=scalars, graph=graph)

    def epoch_losses(scalars):
        return [(step, value) for tag, value, step in scalars.rows if tag == "train/loss"]

    first_scalars, eager_scalars, resumed_scalars = Scalars(), Scalars(), Scalars()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first = trainer(2, first_scalars, "graph").resume()
        zero_counts()
        first.train()
        e_launches = dict(zip(("fps", "sa", "group_fwd", "group_bwd"), read_launches()))
        ckpts = first.ckpt.epochs()
        first.train_loader.close()
        eager_run = trainer(2, eager_scalars, "eager", graph=False).resume()
        eager_run.train()
        eager_run.train_loader.close()
    finally:
        torch.use_deterministic_algorithms(False)
    det_equal = epoch_losses(first_scalars) == epoch_losses(eager_scalars) and all(
        torch.equal(a, b) for a, b in zip(first.model.state_dict().values(), eager_run.model.state_dict().values()))
    pool_mb = graph_entry(first.multi_step).graph.pool_bytes() / 2**20
    resumed = trainer(3, resumed_scalars, "graph").resume()
    same = all(torch.equal(a, b) for a, b in zip(resumed.model.state_dict().values(),
                                                 first.model.state_dict().values()))
    at = (resumed.start_epoch, resumed.accumulated_iter)
    resumed.train()
    resumed.train_loader.close()
    e12, e3 = epoch_losses(first_scalars), epoch_losses(resumed_scalars)
    noted = [line for line in lines if "steps_per_dispatch=" in line or line.startswith("graph: ")]
    log(f"[21e] Trainer, STEPS_PER_DISPATCH = 4, 5 steps an epoch, under deterministic algorithms: epochs 1-2 "
        f"(step, loss) {[(s, round(v, 6)) for s, v in e12]}, accumulated_iter {first.accumulated_iter}, optimizer "
        f"count {first.optimizer.count}, captures K = 4 {first.multi_step.graphs.captures} / K = 1 (the tails) "
        f"{first.train_step.steps.graphs.captures}, the K = 4 graph's pool {pool_mb:.1f} MB, launches {e_launches}, "
        f"checkpoints {ckpts}; the eager Trainer's losses and weights torch.equal {det_equal}; resumed at (epoch, "
        f"step) {at}, weights equal {same}; epoch 3 {[(s, round(v, 6)) for s, v in e3]}, accumulated_iter "
        f"{resumed.accumulated_iter}, optimizer count {resumed.optimizer.count}; logged {noted[:2]} and eager "
        f"{noted[2:4]}")
    shutil.rmtree(out_dir, ignore_errors=True)
    if [s for s, _ in e12] != list(range(1, 11)) or len({v for _, v in e12}) != 10 \
            or not np.isfinite([v for _, v in e12]).all():
        fail("[21e] epochs 1-2 did not log 10 finite losses, each its own step's")
    if first.accumulated_iter != 10 or first.optimizer.count != 10 or ckpts != [1, 2]:
        fail("[21e] the step count or the checkpoints of epochs 1-2 are wrong")
    if (first.multi_step.graphs.captures, first.train_step.steps.graphs.captures) != (1, 1):
        fail("[21e] the epochs did not run one K = 4 graph and the tails through the one-step graph")
    if e_launches != {"fps": 20, "sa": 0, "group_fwd": 70, "group_bwd": 70}:
        fail(f"[21e] launches over the two epochs {e_launches}, not 2 FPS + 7 + 7 group a step")
    if not det_equal:
        fail("[21e] under deterministic algorithms the graphed Trainer differs from the eager one")
    if at != (2, 10) or not same or [s for s, _ in e3] != list(range(11, 16)) \
            or not np.isfinite([v for _, v in e3]).all() or resumed.accumulated_iter != 15 \
            or resumed.optimizer.count != 15:
        fail("[21e] the resumed Trainer did not continue at step 10 for 5 finite steps")
    if noted[:4] != ["graph: on", "steps_per_dispatch=4 (K-step CUDA graph per dispatch)",
                     "graph: off (the eager step asked for)", "steps_per_dispatch=4 (K-step CUDA graph per dispatch)"]:
        fail(f"[21e] the Trainers logged {noted[:4]}")
    for t in (first, resumed):
        t.train_step.steps.close()
        t.multi_step.close()
    del first, resumed, eager_run
    gc.collect()
    torch.cuda.empty_cache()
    out["e"] = {"epochs": e12, "epoch3": e3, "launches": e_launches, "eager_equal": det_equal, "pool_mb": pool_mb}
    out["f"] = shared_pool_phase(device, card, weights, out["d_waymo"])
    # since 21c's traces set CUPTI up, graphs were released (21d) and later ones captured into a shared pool (21e,
    # 21f): the history after which a trace of replays has died inside cudaGraphLaunch, which the port refuses
    from ptt_tpu_torch.utils.profiling import TraceRefused, device_window

    try:
        with device_window():
            pass
        out["refused"] = None
    except TraceRefused as exc:
        out["refused"] = str(exc)
    log(f"[21] a trace after 21d-f's releases and shared-pool captures: refused {out['refused'] is not None} "
        f"({out['refused']})")
    if out["refused"] is None:
        fail("[21] the port's profiler window opened a trace after 21d-f's history")
    out["seconds"] = time.perf_counter() - t_phase
    out["profiler_windows"] = dict(profiler_windows)
    log(f"[21] phase 21 took {out['seconds']:.1f} s; profiler windows {out['profiler_windows']}")
    return out


POOL_PEAK_RATIO = 1.15  # a Trainer's graphs at K > 1 with the epoch tail, against one graph's peak reserved memory


def shared_pool_phase(device, card, weights, waymo_ref) -> dict:
    """Phase 21f: every train graph of a Trainer in one ``CaptureContext``
    (one pool, one stream). (1) ptt_large.yaml at B = 48, seeded init,
    STEPS_PER_DISPATCH = 4 over 6 steps an epoch (a K = 4 dispatch and a tail
    of 2), two epochs, graphed and eager under deterministic algorithms: every
    step's metrics, the parameters, the BatchNorm statistics and Adam's
    moments torch.equal; its peak reserved memory beside a K = 1 graph's in
    this call, at most POOL_PEAK_RATIO x. (2) ptt_waymo.yaml at B = 48 (8192 /
    2048 points), seeded init, K = 2 over 3 steps (a tail of 1), graphed: no
    out-of-memory error, finite, 2 FPS + 0 SA + 7 + 7 group launches a step,
    step 0's metrics equal to the eager Trainer's, the last step's grad_norm
    and the parameters within WITNESS_FACTOR x the eager Trainer run again;
    its peak at most POOL_PEAK_RATIO x 21d's one graph's. (3) ptt_synth.yaml
    from the asset under a BatchNorm schedule with DECAY_STEP 1, K = 2 over 3
    steps, 3 epochs: one capture per ``TrainStep``, torch.equal to the eager
    Trainer under deterministic algorithms. Each Trainer's graphs report one
    pool id."""
    from ptt_tpu_torch.config import config_by_path, ptt_synth_config
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.trainer import Trainer
    from ptt_tpu_torch.utils.cuda_graph import read_launches

    t_phase = time.perf_counter()
    out_dir = os.path.join(REPO, "build", "chip_smoke_shared_pool")
    shutil.rmtree(out_dir, ignore_errors=True)
    synth = ptt_synth_config()
    logger = logging.getLogger("chip_smoke.21f")
    logger.setLevel(logging.WARNING)
    names = ("fps", "sa", "group_fwd", "group_bwd")

    def steps_of(scalars) -> list:
        """Each step's logged metrics, by step: {name: value}."""
        by_step = {}
        for tag, value, step in scalars.rows:
            if tag.startswith("train/"):
                by_step.setdefault(step, {})[tag[len("train/"):]] = value
        return [by_step[k] for k in sorted(by_step)]

    def run(cfg, init, data, optim, epochs, graph, name):
        """A Trainer from ``init`` over ``data`` for ``epochs`` epochs: its
        steps' metrics, its final state (parameters and buffers, Adam's
        moments), the pool ids of its graphs and the captures of each
        TrainStep, the launches; then its graphs released."""
        net = build_network(cfg["MODEL"], device=device, train=True)
        net.load_state_dict(init, strict=True)
        loader = DataLoader(SyntheticTrackingDataset(data), TRAIN_B, shuffle=True, drop_last=True, num_workers=0)
        scalars = Scalars()
        trainer = Trainer(net, cfg["MODEL"], dict(cfg["OPTIMIZATION"], **optim), loader, os.path.join(out_dir, name),
                          logger, total_epochs=epochs, device=device, tb_writer=scalars, graph=graph)
        timer.reset()
        try:
            trainer.train()
        finally:
            loader.close()
        launches = dict(zip(names, read_launches()))
        steps = [trainer.train_step.steps] + ([trainer.multi_step] if trainer.multi_step is not None else [])
        graphs = [(s.k, e.graph) for s in steps for e in s.graphs.values() if e.graph is not None]
        result = {"steps": steps_of(scalars), "captures": [s.graphs.captures for s in steps],
                  "pools": sorted({tuple(g.pool) for _, g in graphs}),
                  "graph_launches": {k: g.launches for k, g in graphs}, "launches": launches,
                  "state": [t.detach().clone() for t in net.state_dict().values()],
                  "moments": [t.clone() for t in trainer.optimizer.mu + trainer.optimizer.nu],
                  "params": [p.detach().clone() for p in net.parameters()],
                  "count": trainer.optimizer.count, "momenta": [trainer._bn_momentum(e) for e in range(epochs)]}
        for s in steps:
            s.close()
        del trainer, net
        gc.collect()
        torch.cuda.empty_cache()
        return result

    def peak():
        return {"reserved_gib": torch.cuda.max_memory_reserved() / 2**30,
                "allocated_gib": torch.cuda.max_memory_allocated() / 2**30}

    def fresh_peak():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    def bit_equal(a, b) -> bool:
        return a["steps"] == b["steps"] and all(torch.equal(x, y) for x, y in zip(a["state"], b["state"])) \
            and all(torch.equal(x, y) for x, y in zip(a["moments"], b["moments"]))

    out = {}
    # (1) ptt_large.yaml, K = 4 with a tail of 2, against a K = 1 graph's memory; seeded init
    lcfg = config_by_path("kitti_models/ptt_large.yaml")
    ldata = dict(synth["DATA_CONFIG"], SEARCH_INPUT_SIZE=lcfg["DATA_CONFIG"]["SEARCH_INPUT_SIZE"],
                 TEMPLATE_INPUT_SIZE=lcfg["DATA_CONFIG"]["TEMPLATE_INPUT_SIZE"], FRAMES_PER_TRACKLET=6)
    torch.manual_seed(SEED)
    linit = {k: v.clone() for k, v in build_network(lcfg["MODEL"], device=device, train=True).state_dict().items()}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        fresh_peak()
        k1 = run(lcfg, linit, dict(ldata, NUM_TRACKLETS=4), {}, 1, True, "large_k1")  # 2 steps
        k1_peak = peak()
        fresh_peak()
        k4 = run(lcfg, linit, dict(ldata, NUM_TRACKLETS=12), {"STEPS_PER_DISPATCH": 4}, 2, True, "large_k4")
        k4_peak = peak()
        k4_eager = run(lcfg, linit, dict(ldata, NUM_TRACKLETS=12), {"STEPS_PER_DISPATCH": 4}, 2, False,
                       "large_k4_eager")
    finally:
        torch.use_deterministic_algorithms(False)
    ratio = k4_peak["reserved_gib"] / k1_peak["reserved_gib"]
    equal = bit_equal(k4, k4_eager)
    losses = [round(m["loss"], 6) for m in k4["steps"]]
    log(f"[21f] ptt_large.yaml, B = {TRAIN_B}, STEPS_PER_DISPATCH = 4 over 6 steps an epoch (K = 4 and a tail of 2), "
        f"2 epochs, under deterministic algorithms: losses {losses}; captures (K = 1, K = 4) {k4['captures']}, pool ids "
        f"{k4['pools']}, launches {k4['launches']}; the eager Trainer's metrics, parameters, BatchNorm statistics and "
        f"Adam moments torch.equal {equal}; peak reserved {k4_peak['reserved_gib']:.2f} GiB (allocated "
        f"{k4_peak['allocated_gib']:.2f}) against a K = 1 graph's {k1_peak['reserved_gib']:.2f} GiB ("
        f"{k1_peak['allocated_gib']:.2f}) in this call: {ratio:.3f} x; card {card}")
    out["large"] = {"losses": losses, "captures": k4["captures"], "pools": len(k4["pools"]),
                    "launches": k4["launches"], "eager_equal": equal, "peak": k4_peak, "k1_peak": k1_peak,
                    "ratio": ratio}
    if len(k4["steps"]) != 12 or not np.isfinite([m["loss"] for m in k4["steps"]]).all() or k4["count"] != 12:
        fail("[21f] ptt_large: not 12 finite steps")
    if k4["captures"] != [1, 1] or len(k4["pools"]) != 1 or len(k1["pools"]) != 1:
        fail(f"[21f] ptt_large: captures {k4['captures']}, pools {k4['pools']}: not one graph a TrainStep in one pool")
    if k4["launches"] != {"fps": 24, "sa": 0, "group_fwd": 84, "group_bwd": 84}:
        fail(f"[21f] ptt_large: launches {k4['launches']}, not 2 FPS + 7 + 7 group in each of 12 steps")
    if not equal:
        fail("[21f] ptt_large: the graphed Trainer differs from the eager one under deterministic algorithms")
    if ratio > POOL_PEAK_RATIO:
        fail(f"[21f] ptt_large: peak reserved {ratio:.3f} x the K = 1 graph's, above {POOL_PEAK_RATIO}")
    del k1, k4, k4_eager, linit

    # (2) ptt_waymo.yaml, K = 2 with a tail of 1, one epoch; seeded init
    wcfg = config_by_path("kitti_models/ptt_waymo.yaml")
    wdata = dict(synth["DATA_CONFIG"], SEARCH_INPUT_SIZE=8192, TEMPLATE_INPUT_SIZE=2048, NUM_TRACKLETS=6,
                 FRAMES_PER_TRACKLET=6)  # 144 items: 3 steps
    torch.manual_seed(SEED)
    winit = {k: v.clone() for k, v in build_network(wcfg["MODEL"], device=device, train=True).state_dict().items()}
    k2 = {"STEPS_PER_DISPATCH": 2}
    eager = [run(wcfg, winit, wdata, k2, 1, False, f"waymo_eager{i}") for i in range(2)]
    fresh_peak()
    graphed = run(wcfg, winit, wdata, k2, 1, True, "waymo_k2")
    w_peak = peak()
    w_ratio = w_peak["reserved_gib"] / waymo_ref["peak_reserved_gib"]
    last = len(graphed["steps"]) - 1
    step0 = {k: graphed["steps"][0][k] == eager[0]["steps"][0][k] for k in LOSS_TERMS}
    norms = [r["steps"][last]["grad_norm"] for r in (graphed, eager[1], eager[0])]
    rows = {"last grad_norm": tuple(abs(x - norms[2]) / max(abs(norms[2]), 1e-12) for x in norms[:2]),
            "params": (params_err(graphed["params"], eager[0]["params"]),
                       params_err(eager[1]["params"], eager[0]["params"]))}
    log(f"[21f] ptt_waymo.yaml, B = {TRAIN_B}, STEPS_PER_DISPATCH = 2 over 3 steps (K = 2 and a tail of 1): losses "
        f"{[round(m['loss'], 4) for m in graphed['steps']]} (eager {[round(m['loss'], 4) for m in eager[0]['steps']]})"
        f"; captures (K = 1, K = 2) {graphed['captures']}, pool ids {graphed['pools']}, launches a dispatch by K "
        f"{graphed['graph_launches']}, over the epoch {graphed['launches']}; step 0's loss terms equal to eager "
        f"{step0}; rel diff (graph, eager again) "
        + ", ".join(f"{k} ({d:.1e}, {w:.1e})" for k, (d, w) in rows.items())
        + f"; peak reserved {w_peak['reserved_gib']:.2f} GiB (allocated {w_peak['allocated_gib']:.2f}) against 21d's "
        f"one graph {waymo_ref['peak_reserved_gib']:.2f} GiB ({waymo_ref['peak_gib']:.2f}): {w_ratio:.3f} x; card {card}")
    out["waymo"] = {"losses": [m["loss"] for m in graphed["steps"]], "captures": graphed["captures"],
                    "pools": len(graphed["pools"]), "launches": graphed["launches"], "step0_equal": step0,
                    "witness": {k: list(v) for k, v in rows.items()}, "peak": w_peak, "ratio": w_ratio}
    if len(graphed["steps"]) != 3 or not np.isfinite([m["loss"] for m in graphed["steps"]]).all():
        fail("[21f] ptt_waymo: not 3 finite steps")
    if graphed["captures"] != [1, 1] or len(graphed["pools"]) != 1:
        fail(f"[21f] ptt_waymo: captures {graphed['captures']}, pools {graphed['pools']}")
    if graphed["graph_launches"] != {1: (2, 0, 7, 7, 0), 2: (4, 0, 14, 14, 0)} or \
            graphed["launches"] != {"fps": 6, "sa": 0, "group_fwd": 21, "group_bwd": 21}:
        fail(f"[21f] ptt_waymo: launches {graphed['graph_launches']}, {graphed['launches']}: not 2, 0, 7, 7 a step")
    if not all(step0.values()):
        fail("[21f] ptt_waymo: step 0's loss terms differ from the eager Trainer's")
    bad = [k for k, (d, w) in rows.items() if d > WITNESS_FACTOR * max(w, WITNESS_FLOOR)]
    if bad:
        fail(f"[21f] ptt_waymo: beyond {WITNESS_FACTOR} x the witness: {bad}")
    if w_ratio > POOL_PEAK_RATIO:
        fail(f"[21f] ptt_waymo: peak reserved {w_ratio:.3f} x 21d's one graph's, above {POOL_PEAK_RATIO}")
    del eager, graphed, winit

    # (3) ptt_synth.yaml from the asset, a BatchNorm schedule that moves every epoch, K = 2 with a tail of 1
    sched = {"STEPS_PER_DISPATCH": 2,
             "BN_SCHEDULER": {"BN_INIT": 0.5, "BN_DECAY": 0.5, "DECAY_STEP": 1, "BN_CLIP": 0.01}}
    sdata = dict(synth["DATA_CONFIG"], NUM_TRACKLETS=6, FRAMES_PER_TRACKLET=6)  # 3 steps an epoch
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        sg = run(synth, weights, sdata, sched, 3, True, "bn_graph")
        se = run(synth, weights, sdata, sched, 3, False, "bn_eager")
    finally:
        torch.use_deterministic_algorithms(False)
    s_equal = bit_equal(sg, se)
    log(f"[21f] ptt_synth.yaml, BN_SCHEDULER with DECAY_STEP 1, STEPS_PER_DISPATCH = 2 over 3 steps, 3 epochs, "
        f"under deterministic algorithms: flax momenta {sg['momenta']}, captures (K = 1, K = 2) {sg['captures']}, pool "
        f"ids {sg['pools']}; the eager Trainer's metrics, parameters, BatchNorm statistics and Adam moments "
        f"torch.equal {s_equal}")
    out["bn_schedule"] = {"momenta": sg["momenta"], "captures": sg["captures"], "pools": len(sg["pools"]),
                          "eager_equal": s_equal}
    if len(set(sg["momenta"])) != 3 or sg["captures"] != [1, 1] or len(sg["pools"]) != 1:
        fail(f"[21f] BN schedule: momenta {sg['momenta']}, captures {sg['captures']}, pools {sg['pools']}")
    if not s_equal or len(sg["steps"]) != 9:
        fail("[21f] BN schedule: the graphed Trainer differs from the eager one under deterministic algorithms")
    shutil.rmtree(out_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[21f] took {out['seconds']:.1f} s")
    return out


OPTIMIZER_RUNS = ("adam", "adamw", "sgd", "adam_onecycle")


def phase15_cli_jobs() -> dict:
    """Phase 15's train CLI runs, name -> (arguments, --set pairs): 2 steps of
    B = 48 each (4 tracklets x 6 frames); p2b_synth_strong.yaml as the file
    sets it (bf16), ptt_synth.yaml once per OPTIMIZER. WEIGHT_DECAY stays the
    file's integer 0 (``--set`` keeps a key's type, as the JAX package's does),
    so adamw steps as adam does here; the CPU lockstep covers weight decay."""
    small = ["DATA_CONFIG.NUM_TRACKLETS", "4", "DATA_CONFIG.FRAMES_PER_TRACKLET", "6", "TRAIN.WITH_EVAL.ENABLE", "False"]
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
    loader.close()
    weights = state_dict_from_npz(ASSET)

    def fresh(use_kernels):
        model = build_network(cfg["MODEL"], device=device, train=True)
        model.load_state_dict(weights, strict=True)
        set_use_kernels(model, use_kernels)
        return model, Optimizer(model.parameters(), cfg["OPTIMIZATION"], len(loader))

    # eager, for FpsReplay (phase 21d takes a graphed bf16 step)
    step16 = make_train_step(cfg["MODEL"], device=device, mixed_precision=True, graph=False)
    step32 = make_train_step(cfg["MODEL"], device=device, graph=False)
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
        times[name].append(median_step_ms(step, model, opt, [batches[0]] * 3))
    log(f"[15] train step at B = {TRAIN_B} on one pre-made batch, medians of 3, alternated f32, bf16, bf16, f32: "
        f"f32 {', '.join(f'{t:.1f}' for t in times['f32'])} ms, bf16 {', '.join(f'{t:.1f}' for t in times['bf16'])} ms; "
        f"card {card}")
    del mk, ok, mp, op, m32, o32
    torch.cuda.empty_cache()

    with ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(run_cli, "train_tracking", args + ["--pretrained_model", ASSET] * (name in OPTIMIZER_RUNS)
                                     + ["--epochs", 1, "--workers", 0, "--extra_tag", f"chip_smoke_15_{name}", "--set",
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


def nuscenes_phase(agreement, phase10, card, beside=""):
    """Phase 16: the agreement tracklets as a nuScenes release, scored by the
    test CLI on nuscenes_models/ptt.yaml with the trained asset; within 1.0 of
    phase 10's device numbers. ``beside`` names what ran beside it."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_nuscenes_")
    try:
        write_nuscenes_tree(tmp, agreement)
        rec, wall, _ = run_cli("test_tracking", ["--cfg_file", "tools/cfgs/nuscenes_models/ptt.yaml", "--ckpt", ASSET,
                                                 "--max_points", 1024, "--extra_tag", "chip_smoke_16", "--set",
                                                 "DATA_CONFIG.DATA_PATH", tmp], device_launches=True)
        ref_s, ref_p = phase10["device"]
        steps = 31
        log(f"[16] test CLI nuscenes_models/ptt.yaml on the agreement tracklets as a nuScenes release (8 val "
            f"scenes, class trailer): Success {rec['success']:.2f} Precision {rec['precision']:.2f}, phase 10 "
            f"{ref_s:.2f}/{ref_p:.2f} (delta {rec['success'] - ref_s:+.2f}/{rec['precision'] - ref_p:+.2f}); "
            f"dataset {rec['dataset_seconds']:.1f} s; launches {rec['launches']}; CLI wall {wall:.1f} s{beside}; "
            f"card {card}")
        if not (abs(rec["success"] - ref_s) <= 1.0 and abs(rec["precision"] - ref_p) <= 1.0):
            fail("[16] the nuScenes test CLI is not within 1.0 of phase 10's")
        if rec["launches"]["fps"] != 2 * steps or rec["launches"]["sa"] != 7 * steps:
            fail(f"[16] launches {rec['launches']}, not 2 and 7 per step over {steps} steps")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(os.path.join(REPO, "output", "nuscenes_models"), ignore_errors=True)


def gemm_layers(cfg, batch, device, card, top: int = 6):
    """Phase 19b: which layers make the tracker forward's matrix products. One
    eager forward of the frame step's batch (B = 8) on the kernel path under
    torch.profiler with input shapes: the matrix-product calls grouped by (M,
    K, N) with their device ms, each beside the linear layers of
    ``per_layer_flops`` whose output positions, input and output widths are
    that product (the SA stages' layers run inside the SA kernel), and the
    device's kernels by name."""
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.utils.profiling import per_layer_flops

    model = build_network(cfg["MODEL"], device=device)
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    by_mkn = {}
    for name, row in per_layer_flops(model, batch):
        if row["kind"] == "Linear" and row["calls"] and not name.startswith("backbone_3d.sa_stages"):
            lin = model.get_submodule(name)
            mkn = (int(np.prod(row["out_shape"][:-1])), lin.in_features, lin.out_features)
            by_mkn.setdefault(mkn, []).append(name)
    with torch.no_grad():
        model(batch)
        window, _, seen = traced_window(lambda: model(batch), "[19b] a forward", record_shapes=True)
    if not seen:
        return
    products = {}
    for r in window.operators(group_by_input_shape=True):
        shapes, ms = r.input_shapes, r.device_us / 1e3
        if r.key == "aten::mm" and len(shapes) >= 2:
            mkn = (shapes[0][0], shapes[0][1], shapes[1][1])
        elif r.key == "aten::addmm" and len(shapes) >= 3:
            mkn = (shapes[1][0], shapes[1][1], shapes[2][1])
        elif r.key == "aten::bmm" and len(shapes) >= 2:
            mkn = (shapes[0][0] * shapes[0][1], shapes[0][2], shapes[1][2])
        else:
            continue
        ms_, n_ = products.get((r.key, mkn), (0.0, 0))
        products[(r.key, mkn)] = (ms_ + ms, n_ + r.count)
    total = sum(ms for ms, _ in products.values())
    log(f"[19b] ptt.yaml forward on the frame step's batch (B = {batch['search_points'].shape[0]}), kernel path, "
        f"eager: the matrix products, {total:.3f} ms of device time, the largest first (op, M x K x N, device ms, "
        f"calls, the linear layers of that product); card {card}")
    for (op, mkn), (ms, n) in sorted(products.items(), key=lambda kv: -kv[1][0])[:top]:
        log(f"  {op} {mkn[0]} x {mkn[1]} x {mkn[2]}: {ms:.3f} ms, {n} calls; layers {by_mkn.get(mkn, 'none (not a layer)')}")
    for name, (us, n) in top_names(window.events, top):
        log(f"  kernel {us / 1e3:8.3f} ms {n:4d}x  {name[:100]}")
    del model
    torch.cuda.empty_cache()


# ------------------------------------------------------- the float32 product kernel (phase 23)

PEAK_TF32X3 = 495e12 / 3  # float32 operations a second: dense TF32 over the three passes of the split product
TF32X3_ERR_FACTOR = 2.0  # the kernel's error against float64 at most this times cuBLAS float32's
TF32X3_TIMED = 20  # calls a timing
# the eight products of a ptt.yaml frame step at B = 8: (layers, M, K, N, epilogue)
TF32X3_SHAPES = [(f"{head} {layer}", m, 512, 512, epi) for head, m in (("centroid", 16384), ("box", 8192))
                 for layer, epi in (("fc_delta.2", "bias"), ("fc_gamma.0", "bias+relu"), ("fc_gamma.2", "bias"))] + \
                [(f"similarity mlp.{i}", 65536, 256, 256, "bn+relu") for i in (1, 2)]
# (K, N) and M of the crossover sweep against cuBLAS
TF32X3_SWEEP = [((512, 512), (1024, 2048, 3072, 4096, 8192)), ((256, 256), (2048, 4096, 6144, 8192, 16384))]


def tf32x3_operands(m, k, n, epilogue, device, seed=0):
    """x (m, k) >= 0 (a ReLU's output, as these layers' inputs), a Linear's (n, k)
    weight and the epilogue's bias or eval BatchNorm vectors, seeded."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.relu(torch.randn(m, k, generator=gen)).to(device)
    w = (torch.randn(n, k, generator=gen) / k ** 0.5).to(device)
    bias = bn = None
    if epilogue.startswith("bias"):
        bias = (0.1 * torch.randn(n, generator=gen)).to(device)
    elif epilogue.startswith("bn"):
        bn = tuple(t.to(device) for t in (torch.rand(n, generator=gen) + 0.5, 0.1 * torch.randn(n, generator=gen),
                                          0.1 * torch.randn(n, generator=gen), torch.rand(n, generator=gen) + 0.5))
        bn = bn + (1e-5,)
    return x, w, bias, bn, epilogue.endswith("relu")


def tf32x3_library(x, w, bias, bn, relu):
    """The same layer as the port ran it before the kernel: cuBLAS's float32
    GEMM (``F.linear``), then eval BatchNorm and ReLU as separate kernels."""
    import torch.nn.functional as F

    y = F.linear(x, w, bias)
    if bn is not None:
        y = F.batch_norm(y, bn[2], bn[3], bn[0], bn[1], False, 0.0, bn[4])
    return torch.relu(y) if relu else y


def tf32x3_float64(x, w, bias, bn, relu):
    y = x.double() @ w.double().t()
    if bias is not None:
        y = y + bias.double()
    if bn is not None:
        y = (y - bn[2].double()) / torch.sqrt(bn[3].double() + bn[4]) * bn[0].double() + bn[1].double()
    return torch.relu(y) if relu else y


def tf32x3_err(got, ref) -> float:
    """|got - ref| over |ref|, Frobenius norms."""
    return float((got.double() - ref).norm() / ref.norm())


def tf32x3_phase(card) -> dict:
    """Phase 23: ``csrc/tf32x3.cu`` at the eight products of a ptt.yaml frame
    step (B = 8): error against float64 beside cuBLAS float32's on the same
    inputs (at most TF32X3_ERR_FACTOR times it) and the plain version's; ms a
    call by events with the host's enqueue hidden (``queued_ms``) for the
    kernel, the plain version on the card and the library layer (cuBLAS GEMM,
    BatchNorm, ReLU: ``library_ms``); the bound (three-pass operations at
    165 TFLOP/s or bytes at 3.35 TB/s); the device time of the split and main
    kernels by the profiler; then the crossover against the library layer
    that ``ops/linear.py`` ``MIN_ROWS`` rests on."""
    from ptt_tpu_torch.ops import linear

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda")
    rows, calls = [], []
    for name, m, k, n, epi in TF32X3_SHAPES:
        x, w, bias, bn, relu = tf32x3_operands(m, k, n, epi, device)
        ref = tf32x3_float64(x, w, bias, bn, relu)
        err = {path: tf32x3_err(fn(x, w, bias, bn, relu), ref) for path, fn in
               (("kernel", linear.linear_tf32x3), ("library", tf32x3_library), ("plain", linear.linear_tf32x3_plain))}
        ms = {path: queued_ms(lambda fn=fn: fn(x, w, bias, bn, relu), TF32X3_TIMED) for path, fn in
              (("kernel", linear.linear_tf32x3), ("library", tf32x3_library), ("plain", linear.linear_tf32x3_plain))}
        nbytes = 4 * (m * k + n * k + m * n + (4 if bn is not None else 1) * n)
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, 2 * m * k * n / PEAK_TF32X3 * 1e3
        bms, by = max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")
        rows.append({"layers": name, "shape": [m, k, n], "epilogue": epi, "err": err["kernel"],
                     "library_err": err["library"], "plain_err": err["plain"], "ms": ms["kernel"],
                     "library_ms": ms["library"], "plain_ms": ms["plain"], "bound_ms": bms, "bound_by": by})
        calls.append((x, w, bias, bn, relu))
        log(f"[23] {name} {m} x {k} x {n} ({epi}): rel err vs float64 kernel {err['kernel']:.3e}, cuBLAS "
            f"{err['library']:.3e}, plain {err['plain']:.3e}; ms kernel {ms['kernel']:.4f}, library "
            f"{ms['library']:.4f}, plain {ms['plain']:.4f}, bound {bms:.4f} ({by}, {100 * bms / ms['kernel']:.1f}%)")
    timer.reset()
    parts = kernel_ms(lambda: [linear.linear_tf32x3(*c) for c in calls], 5, ("tf32x3_split", "tf32x3_gemm"))
    launches = timer.counter("launches.tf32x3")
    total = {key: sum(r[key] for r in rows) for key in ("ms", "library_ms", "plain_ms", "bound_ms")}
    log(f"[23] the eight products: kernel {total['ms']:.4f} ms, library {total['library_ms']:.4f}, plain "
        f"{total['plain_ms']:.4f}, bound {total['bound_ms']:.4f} ({100 * total['bound_ms'] / total['ms']:.1f}% of it); "
        f"device ms of the eight by kernel: {by_kernel(parts)}; launches counted {launches}; card {card}")
    bad = [r["layers"] for r in rows if not r["err"] <= TF32X3_ERR_FACTOR * r["library_err"]]
    if bad:
        fail(f"[23] the kernel's error is above {TF32X3_ERR_FACTOR} x cuBLAS float32's at {bad}")
    if launches == 0 or launches % len(calls):
        fail(f"[23] launches.tf32x3 counted {launches}, not a multiple of the {len(calls)} calls made at a time")
    sweep = []
    for (k, n), ms_ in TF32X3_SWEEP:
        for m in ms_:
            x, w, bias, bn, relu = tf32x3_operands(m, k, n, "bias", device)
            kern = queued_ms(lambda: linear.linear_tf32x3(x, w, bias, bn, relu), TF32X3_TIMED)
            lib = queued_ms(lambda: tf32x3_library(x, w, bias, bn, relu), TF32X3_TIMED)
            sweep.append({"shape": [m, k, n], "ms": kern, "library_ms": lib,
                          "routed": linear.takes_kernel(m, k, n, torch.float32, device, False)})
    log("[23] crossover (M x K x N: kernel / library ms, routed to the kernel): " + "; ".join(
        f"{r['shape'][0]} x {r['shape'][1]} x {r['shape'][2]}: {r['ms']:.4f} / {r['library_ms']:.4f}"
        f"{' (kernel)' if r['routed'] else ''}" for r in sweep))
    return {"rows": rows, "total": total, "device_ms": parts, "sweep": sweep}


def tf32x3_only() -> int:
    """``--tf32x3``: the build and phase 23 alone."""
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    from ptt_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = gpu_line()
    _build.build()
    out = tf32x3_phase(card)
    log(f"[time] build and phase 23: {time.perf_counter() - t_start:.1f} s")
    print("tf32x3 " + json.dumps(out), flush=True)
    return 0


# the four vector-attention calls of the cells' frame steps at B = 8: (config, layer, queries a row, heads)
VATTN_SHAPES = [("ptt.yaml", "centroid", 128, 1), ("ptt.yaml", "box", 64, 1),
                ("ptt_waymo.yaml", "centroid", 256, 4), ("ptt_waymo.yaml", "box", 128, 4)]
VATTN_LAYERS = {"ptt.yaml": 1, "ptt_waymo.yaml": 2}  # layers a block
VATTN_RTOL = 1e-6
VATTN_TIMED = 20  # calls a timing


def vattn_operands(n, device, seed=0, k=16, d=512):
    """q, kproj, vproj (8, n, d), idx (8, n, k) int32, pos and logits (8, n, k, d), seeded."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q, kp, vp = (torch.randn(8, n, d, generator=gen).to(device) for _ in range(3))
    idx = torch.randint(0, n, (8, n, k), generator=gen, dtype=torch.int32).to(device)
    pos, logits = torch.randn(8, n, k, d, generator=gen).to(device), (8 * torch.randn(8, n, k, d, generator=gen)).to(device)
    return q, kp, vp, idx, pos, logits


def vattn_library(q, kp, vp, idx, pos, logits, heads, scale):
    """The blocks' glue as the port ran it before the kernels (``nn/transformer.py``):
    the gathers, q - k + pos, and ``_attend`` of the logits and v + pos, with a
    multi-head layer's permutes, its permuted input made contiguous (the copy
    F.linear made) and its result's transpose."""
    from ptt_tpu_torch.nn.transformer import _attend
    from ptt_tpu_torch.ops.point_ops import group_points

    B, N, d = q.shape
    k, v = group_points(kp, idx), group_points(vp, idx)
    if heads == 1:
        a = q[:, :, None] - k + pos
        _, res = _attend(logits, v + pos, scale)
        return a, res
    hd = d // heads

    def split(t):
        return t.reshape(B, N, t.shape[2], heads, hd).permute(0, 3, 1, 2, 4)

    a = (q.reshape(B, N, heads, hd).transpose(1, 2)[:, :, :, None] - split(k) + split(pos)).contiguous()
    _, res = _attend(split(logits), split(v) + split(pos), scale)
    return a, res.transpose(1, 2).reshape(B, N, d)


def vattn_phase(card) -> dict:
    """Phase 24: ``csrc/vattn.cu`` at the four vector-attention calls of the
    cells' frame steps (B = 8, k 16, d 512): A equal to the plain version, res
    and attn within VATTN_RTOL of it (``relerr``); ms a call of the two
    kernels, of the plain versions on the card and of the library layers (the
    blocks' glue before the kernels, ``vattn_library``), by events with the
    host's enqueue hidden (``queued_ms``); the bytes bound
    (``benchmark/counts/vattn.py``'s least bytes at 3.35 TB/s); the two
    kernels' device time by the profiler; then each configuration's frame
    step."""
    from ptt_tpu_torch.ops import vattn

    device = torch.device("cuda")
    rows, calls = [], []
    for config, layer, n, heads in VATTN_SHAPES:
        q, kp, vp, idx, pos, logits = vattn_operands(n, device)
        scale = 512 // heads
        a = vattn.vattn_in(q, kp, idx, pos)
        res, attn = vattn.vattn_out(logits, vp, idx, pos, scale, want_attn=True)
        pa = vattn.vattn_in_plain(q, kp, idx, pos)
        pres, pattn = vattn.vattn_out_plain(logits, vp, idx, pos, scale, want_attn=True)
        _, lres = vattn_library(q, kp, vp, idx, pos, logits, heads, scale)
        torch.cuda.synchronize()
        err = {"res": relerr(res, pres), "attn": relerr(attn, pattn), "library_res": relerr(lres, pres)}
        a_equal = bool(torch.equal(a, pa))

        def kern():
            vattn.vattn_out(vattn.vattn_in(q, kp, idx, pos), vp, idx, pos, scale)

        def plain():
            vattn.vattn_out_plain(vattn.vattn_in_plain(q, kp, idx, pos), vp, idx, pos, scale)

        ms = {"kernel": queued_ms(kern, VATTN_TIMED), "plain": queued_ms(plain, VATTN_TIMED),
              "library": queued_ms(lambda: vattn_library(q, kp, vp, idx, pos, logits, heads, scale), VATTN_TIMED)}
        Q = 8 * n
        nbytes = 4 * (4 * Q * 16 * 512 + 4 * Q * 512 + 2 * Q * 16)
        bms = nbytes / PEAK_BYTES * 1e3
        rows.append({"config": config, "layer": layer, "shape": [Q, 16, 512], "heads": heads, "a_equal": a_equal,
                     **{f"{key}_err": value for key, value in err.items()}, "ms": ms["kernel"],
                     "plain_ms": ms["plain"], "library_ms": ms["library"], "bound_ms": bms, "bound_by": "bytes"})
        calls.append(kern)
        log(f"[24] {config} {layer} Q {Q} H {heads}: A equal {a_equal}, rel err res {err['res']:.3e} attn "
            f"{err['attn']:.3e} (library's res {err['library_res']:.3e}); ms kernels {ms['kernel']:.4f}, plain "
            f"{ms['plain']:.4f}, library {ms['library']:.4f}, bound {bms:.4f} (bytes, {100 * bms / ms['kernel']:.1f}%)")
    timer.reset()
    parts = kernel_ms(lambda: [c() for c in calls], 5, ("vattn_in_kernel", "vattn_out_kernel"))
    steps = {config: {key: VATTN_LAYERS[config] * sum(r[key] for r in rows if r["config"] == config)
                      for key in ("ms", "plain_ms", "library_ms", "bound_ms")} for config in VATTN_LAYERS}
    for config, st in steps.items():
        log(f"[24] {config} frame step ({VATTN_LAYERS[config]} layer(s) a block): kernels {st['ms']:.4f} ms, plain "
            f"{st['plain_ms']:.4f}, library {st['library_ms']:.4f}, bound {st['bound_ms']:.4f} "
            f"({100 * st['bound_ms'] / st['ms']:.1f}% of it)")
    log(f"[24] device ms of the four calls by kernel: {by_kernel(parts)}; card {card}")
    bad = [(r["config"], r["layer"]) for r in rows
           if not (r["a_equal"] and r["res_err"] <= VATTN_RTOL and r["attn_err"] <= VATTN_RTOL)]
    if bad:
        fail(f"[24] the kernels differ from the plain versions at {bad}")
    return {"rows": rows, "steps": steps, "device_ms": parts}


def vattn_only() -> int:
    """``--vattn``: the build and phase 24 alone."""
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    from ptt_tpu_torch.ops import _build

    t_start = time.perf_counter()
    card = gpu_line()
    _build.build()
    if "vattn" in _build.build_log:
        secs, nvcc_out = _build.build_log["vattn"]
        log(f"[24] nvcc vattn.cu ({secs:.1f} s):\n{nvcc_out}")
    out = vattn_phase(card)
    log(f"[time] build and phase 24: {time.perf_counter() - t_start:.1f} s")
    print("vattn " + json.dumps(out), flush=True)
    return 0


# ------------------------------------------------------------ point sharding (phase 20)

POINT_RANKS = 2  # one point group of two gloo ranks sharing the card (NCCL refuses two ranks on one device)
POINT_B = 8  # ptt_waymo's tracker batch
# (points, centers) of ptt_waymo's stage 0: the search branch, then the template branch
POINT_SHAPES = ((8192, 2048), (2048, 1024))
POINT_TIMED = 10


def point_rank(job_dir) -> int:
    """Phase 20a, one rank under torchrun (``chip_smoke.py --point-rank
    DIR``): both ranks one point group on cuda:0. At ptt_waymo's stage-0
    shapes (B = 8; 8192 points and 2048 centers, 2048 and 1024), clouds and the
    seeded model's stage-0 weights the same on both ranks: ``ball_query``,
    ``knn``, ``three_nn`` and ``square_distance`` under the group against the
    same ops outside it (torch.equal); the SA kernel on this rank's half of
    the centers, gathered, against the unsplit kernel (torch.equal) and
    ``fused_sa_plain`` (SA_RTOL); rank 0's ms of the kernel on all and on half
    the centers while rank 1 waits, and each rank's ms of the gather. Saves
    DIR/rank<r>.pt."""
    sys.path.insert(0, REPO)
    import torch.distributed as dist

    from ptt_tpu_torch.config import config_by_path
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.ops import mesh_ctx, point_ops, sa
    from ptt_tpu_torch.utils.dist import init_distributed, point_groups

    rank, _, device = init_distributed("gloo", "env://", "cuda:0")
    try:
        handle, ranks = point_groups()
        group = mesh_ctx.PointGroup(handle, tuple(ranks), ranks.index(rank))
        torch.manual_seed(SEED)
        model = build_network(config_by_path("kitti_models/ptt_waymo.yaml")["MODEL"], device=device)
        stage = model.backbone_3d.sa_stages[0]
        with torch.no_grad():
            weights, biases = stage.mlp.folded()
        gen = torch.Generator().manual_seed(20)
        out = {"rows": []}
        for n, m in POINT_SHAPES:
            xyz = (torch.randn(POINT_B, n, 3, generator=gen) * torch.tensor([2.0, 1.0, 0.5])).to(device)
            centers = xyz[:, torch.randperm(n, generator=gen)[:m]].contiguous()

            def ops():
                return {"ball_query": point_ops.ball_query(stage.radius, stage.nsample, xyz, centers),
                        "knn": point_ops.knn(16, centers, xyz), "three_nn": point_ops.three_nn(centers, xyz),
                        "square_distance": point_ops.square_distance(centers, xyz)}

            def sa_call(ctr=centers):
                return sa.fused_sa_inference(xyz, ctr, None, stage.radius, stage.nsample, weights, biases)

            whole, whole_sa = ops(), sa_call()
            with mesh_ctx.use_point_group(group):
                before = timer.counter("mesh.gathers")
                split, split_sa = ops(), sa_call()
                gathers = timer.counter("mesh.gathers") - before
            plain = sa.fused_sa_plain(xyz, centers, None, stage.radius, stage.nsample, weights, biases)
            equal = {k: all(torch.equal(a, b) for a, b in zip(v, whole[k])) if isinstance(v, tuple)
                     else torch.equal(v, whole[k]) for k, v in split.items()}
            row = {"shape": [POINT_B, n, m], "gathers": gathers, "equal": equal,
                   "sa_equal": torch.equal(split_sa, whole_sa), "sa_plain_err": float((split_sa - plain).abs().max()),
                   "sa_plain_ok": bool(torch.allclose(split_sa, plain, rtol=SA_RTOL, atol=SA_ATOL))}
            del whole, split, plain
            half = centers[:, group.rows(m)].contiguous()
            local = sa_call(half)
            dist.barrier()
            if rank == 0:  # rank 1 waits: the card's time for all the centers and for one rank's share
                row["sa_ms"] = cuda_ms(sa_call, POINT_TIMED)
                row["sa_half_ms"] = cuda_ms(lambda: sa_call(half), POINT_TIMED)
            dist.barrier()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for _ in range(POINT_TIMED):
                mesh_ctx.gather_rows(local, group)
            torch.cuda.synchronize(device)
            row["gather_ms"] = (time.perf_counter() - t0) * 1e3 / POINT_TIMED
            row["gather_bytes"] = local.numel() * local.element_size() * group.size
            out["rows"].append(row)
            torch.cuda.empty_cache()
        torch.save(out, os.path.join(job_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def summaries(text) -> list:
    return [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]


def point_phase(root, phase13b, card, tmp):
    """Phase 20: POINT_SHARDING as one point group of two gloo ranks sharing
    the card, each started by torchrun: (a) the split ops and the SA kernel on
    each rank's centers at ptt_waymo's stage-0 shapes (``point_rank``); (b)
    the test CLI with ptt_waymo.yaml as the two ranks on 13b's scene: 13b's
    result file line for line and its Success/Precision, the SA calls that
    split, the bytes gathered, ms a frame step and frames/s a rank against
    13b's one process (cost, not scaling: the two ranks share one card); (c)
    the train CLI with ptt_synth_ps.yaml as two ranks, 2 steps of global B =
    48 from the asset: finite losses, data-parallel, the training note."""
    t_phase = time.perf_counter()
    job_dir = os.path.join(tmp, "point")
    os.makedirs(job_dir)
    run_ranks([__file__, "--point-rank", job_dir], "[20a]")
    ranks = [torch.load(os.path.join(job_dir, f"rank{r}.pt"), weights_only=False) for r in range(POINT_RANKS)]
    for r, out in enumerate(ranks):
        for row in out["rows"]:
            b, n, m = row["shape"]
            timing = (f"; the kernel on all {m} centers {row['sa_ms']:.3f} ms, on one rank's {m // POINT_RANKS} "
                      f"{row['sa_half_ms']:.3f} ms (rank 1 idle)" if r == 0 else "")
            log(f"[20a] rank {r}, (B, N, M) = ({b}, {n}, {m}): split ops torch.equal to unsplit {row['equal']} "
                f"({row['gathers']} gathers); the SA kernel on {m // POINT_RANKS} centers a rank, gathered, torch.equal "
                f"to the unsplit kernel {row['sa_equal']}, max |diff| to fused_sa_plain {row['sa_plain_err']:.2e} "
                f"(rtol = atol = {SA_RTOL}){timing}; a gather of {row['gather_bytes'] / 1e6:.2f} MB "
                f"{row['gather_ms']:.3f} ms (gloo, through host memory); card {card}")
            if not all(row["equal"].values()) or not row["sa_equal"] or not row["sa_plain_ok"]:
                fail(f"[20a] a split op or the split SA kernel differs from the unsplit one at {row['shape']}")
            if row["gathers"] != 6:
                fail(f"[20a] {row['gathers']} gathers at {row['shape']}, not 6 (4 ops, three_nn's pair, SA)")

    tag = "chip_smoke_20b"
    data = os.path.join(REPO, "output", "kitti_models", "ptt_waymo", tag, "eval", "default", "final_result", "data")
    try:
        t0 = time.perf_counter()
        text = run_ranks(["-m", "ptt_tpu_torch.tools.test_tracking", "--launcher", "pytorch", "--dist_backend", "gloo",
                          "--device", "cuda:0", "--cfg_file", "tools/cfgs/kitti_models/ptt_waymo.yaml", "--batch_size",
                          8, "--extra_tag", tag, "--set", "DATA_CONFIG.DATA_PATH", root], "[20b]")
        wall = time.perf_counter() - t0
        files = sorted(os.listdir(data))
        with open(os.path.join(data, "track_result.rank0.txt")) as fh:
            lines = fh.read().splitlines()
    finally:
        shutil.rmtree(os.path.join(REPO, "output", "kitti_models", "ptt_waymo"), ignore_errors=True)
    records = summaries(text)
    if len(records) != 1:
        fail(f"[20b] {len(records)} summary lines, not rank 0's one")
    rec = records[0]
    steps = 160 - 1
    group = rec["point_group"]
    split = {int(m): n for m, n in group["sa_split"].items()}
    frames = len(lines)
    ms_step = {"13b": 1e3 * frames / phase13b["frames_per_s"] / steps, "20b": 1e3 * frames / rec["frames_per_s"] / steps}
    same = lines == phase13b["lines"]
    log(f"[20b] test CLI ptt_waymo.yaml as a point group of {group['ranks']} gloo ranks on cuda:0 (torchrun) on 13b's "
        f"scene: result files {files}; rank 0's {frames} lines equal to 13b's line for line {same}; Success "
        f"{rec['success']:.2f} Precision {rec['precision']:.2f} (13b {phase13b['success']:.2f}/"
        f"{phase13b['precision']:.2f}); graph {rec['graph']!r}; SA launches on half the centers by the stage's M "
        f"{split} over {steps} frame steps ({sum(split.values()) / steps:.0f} of {rec['launches']['sa'] / steps:.0f} "
        f"SA calls a step split); {group['gathers'] / steps:.0f} gathers and {group['gathered_bytes'] / steps / 1e6:.2f} "
        f"MB gathered a frame step; rank 0 launches {rec['launches']}; {rec['frames_per_s']:.1f} frames/s a rank, "
        f"{ms_step['20b']:.2f} ms a frame step, against 13b's one process {phase13b['frames_per_s']:.1f} frames/s, "
        f"{ms_step['13b']:.2f} ms a step (graphed, under the profiler; cost, not scaling: the ranks share one card); "
        f"torchrun wall {wall:.1f} s; card {card}")
    if not same or files != ["track_result.rank0.txt"]:
        fail("[20b] the point group's result file is not 13b's line for line, or rank 1 wrote one")
    if (rec["success"], rec["precision"]) != (phase13b["success"], phase13b["precision"]):
        fail("[20b] Success/Precision differ from 13b's")
    if split != {2048: steps, 1024: 2 * steps, 512: steps} or rec["launches"]["sa"] != 7 * steps \
            or rec["launches"]["fps"] != 2 * steps:
        fail(f"[20b] SA split {split}, launches {rec['launches']}: not 4 of 7 SA calls split and 2 FPS a step over "
             f"{steps} steps")
    if rec["graph"] != f"off (point group of {POINT_RANKS} ranks on gloo)":
        fail(f"[20b] graph mode {rec['graph']!r} under the point group")

    tag = "chip_smoke_20c"
    try:
        text = run_ranks(["-m", "ptt_tpu_torch.tools.train_tracking", "--launcher", "pytorch", "--dist_backend", "gloo",
                          "--device", "cuda:0", "--cfg_file", "tools/cfgs/synthetic_models/ptt_synth_ps.yaml",
                          "--batch_size", TRAIN_B, "--epochs", 1, "--workers", 0, "--pretrained_model", ASSET,
                          "--extra_tag", tag, "--set", "DATA_CONFIG.NUM_TRACKLETS", 4,
                          "DATA_CONFIG.FRAMES_PER_TRACKLET", 6, "TRAIN.WITH_EVAL.ENABLE", "False"], "[20c]")
    finally:
        shutil.rmtree(os.path.join(REPO, "output", "synthetic_models", "ptt_synth_ps"), ignore_errors=True)
    train = (summaries(text) or [{}])[-1]
    losses = [float(line.split("  loss ", 1)[1].split()[0]) for line in text.splitlines() if "  loss " in line]
    noted = "POINT_SHARDING: training splits no point axis" in text
    graph_lines = text.count(f"graph: off (process group of {POINT_RANKS} ranks on gloo)")
    seconds = time.perf_counter() - t_phase
    log(f"[20c] train CLI ptt_synth_ps.yaml as {POINT_RANKS} gloo ranks on cuda:0 from the asset, global B = {TRAIN_B}: "
        f"steps {train.get('steps')}, epoch loss {losses}, rank 0 launches {train.get('launches')}, world size "
        f"{train.get('world_size')}, the training note logged {noted}, the eager step's graph line logged "
        f"{graph_lines} times (rank 0 logs); phase 20 took {seconds:.1f} s")
    if train.get("steps") != [0, 2] or train.get("world_size") != POINT_RANKS or not losses \
            or not all(np.isfinite(losses)) or not noted:
        fail("[20c] the train CLI on ptt_synth_ps.yaml did not train 2 finite data-parallel steps with its note")
    if graph_lines != 1:
        fail("[20c] the train CLI's rank 0 did not log once that the step runs eagerly under the process group")
    return {"ops": ranks[0]["rows"], "sa_split": split, "sa_launches": rec["launches"]["sa"],
            "fps_launches": rec["launches"]["fps"], "frames_per_s": rec["frames_per_s"], "ms_step": ms_step,
            "gathered_bytes_a_step": group["gathered_bytes"] / steps, "seconds": seconds}


TOOL_RUNS = (("train_bench", ["--iters", 4, "--tracklets", 2]),)  # demo_tracking: a side tool (phase 22)


def tools_phase(card):
    """Phase 19: the training-side tools run as a user runs them, ``python3 -m
    ptt_tpu_torch.tools.train_bench`` (ptt.yaml and ptt_large.yaml at B = 48,
    4 chained steps for the device step, 2 x 24 synthetic tracklets: 4
    steps an epoch, pipelined, blocking, then 1 dispatch of K = 4 with the
    one-step graph live in the same pool; the
    graphed step): its output printed, a non-zero exit, or a row without a
    number in its K-dispatch column, fails the run. ``python3 -m
    ptt_tpu_torch.tools.demo_tracking`` (ptt.yaml, batch 8) runs with the
    side tools (``start_side_tools``), the same checks."""
    for module, args in TOOL_RUNS:
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", f"ptt_tpu_torch.tools.{module}", *map(str, args)], cwd=REPO,
                             capture_output=True, text=True, timeout=600)
        log(f"[19] python3 -m ptt_tpu_torch.tools.{module} {' '.join(map(str, args))}: exit {out.returncode}, "
            f"{time.perf_counter() - t0:.1f} s; card {card}")
        for line in out.stdout.splitlines():
            log(f"  {line}")
        if out.returncode != 0:
            log(out.stderr[-4000:])
            fail(f"[19] {module} exited with {out.returncode}")
        if module == "train_bench":
            rows = [line.split(" | ") for line in out.stdout.splitlines() if line.startswith("| ptt")]
            if len(rows) != 2 or not all(re.fullmatch(r"[0-9.]+", row[6]) for row in rows):
                fail("[19] train_bench's table has no K-dispatch number for each configuration")


PHASE21_TIMEOUT = 600  # seconds phase 21's process may take


def phase21_process() -> dict:
    """Phase 21 in a process of its own (``chip_smoke.py --phase21``), its
    output logged here and its numbers returned. Its history (a graph
    captured under deterministic algorithms and released, then a graph
    captured into a shared pool) with CUPTI set up before it, as every trace
    of the phases before leaves it in this process, makes a later trace of
    graph replays die inside ``cudaGraphLaunch`` (``cupti_repro.py``;
    PERF.md §6). In its own process the first trace comes after those
    captures."""
    gc.collect()
    torch.cuda.empty_cache()  # this process's cached blocks, which the phase's graph pools need
    t0 = time.perf_counter()
    try:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--phase21"], cwd=REPO, capture_output=True,
                             text=True, timeout=PHASE21_TIMEOUT)
    except subprocess.TimeoutExpired as e:
        log((e.stdout or "")[-8000:] if isinstance(e.stdout, str) else "")
        fail(f"[21] no exit within {PHASE21_TIMEOUT} s")
    records = []
    for line in out.stdout.splitlines():
        if line.startswith("phase21 {"):
            records.append(json.loads(line.split(" ", 1)[1]))
        else:
            log(line)
    if out.returncode != 0 or not records:
        log(out.stderr[-8000:])
        fail(f"[21] its process exited with {out.returncode}")
    log(f"[21] its process: {time.perf_counter() - t0:.1f} s")
    return records[-1]


def phase21_only() -> int:
    """``python3 chip_smoke.py --phase21``: phase 21 alone, its numbers on the
    last line as ``phase21 {json}``; ``main`` runs it so."""
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    adopt_orphans()
    faulthandler.enable()
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.ops import _build

    _build.build()
    out = train_graph_phase(torch.device("cuda"), gpu_line())
    stop_children()
    print("phase21 " + json.dumps(out), flush=True)
    return 0


PORT_TOOL_TIMEOUT = 300  # seconds a tool of phase 22 may take
SIM_RTOL = 1e-4  # CosineSimAug without BatchNorm, card against CPU, relative to the largest output


def tool_cmd(module: str, *args) -> list:
    return [sys.executable, "-m", f"ptt_tpu_torch.tools.{module}", *map(str, args)]


def finish_tool(tag, name, proc, t0, expect_rc=0):
    """Wait for a tool's process, log its output and seconds; fail on an exit
    code other than ``expect_rc`` (None: any non-zero one). Returns (stdout, stderr)."""
    try:
        out, err = proc.communicate(timeout=PORT_TOOL_TIMEOUT)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"{tag} {name}: no exit within {PORT_TOOL_TIMEOUT} s")
    log(f"{tag} {name}: exit {proc.returncode}, {time.perf_counter() - t0:.1f} s")
    for line in out.splitlines():
        log(f"  {line}")
    bad = proc.returncode == 0 if expect_rc is None else proc.returncode != expect_rc
    if bad:
        log(err[-4000:])
        fail(f"{tag} {name} exited with {proc.returncode}")
    return out, err


def table_cells(text: str, first: str) -> list:
    """The cells of the markdown row whose first cell starts with ``first``."""
    rows = [[c.strip() for c in line.strip().strip("|").split("|")] for line in text.splitlines()
            if line.startswith("| " + first)]
    if not rows:
        fail(f"no table row '{first}' in:\n{text}")
    return rows[0]


def point_ops_check(points, device):
    """22a: the point ops of the JAX package no path of the tracker reaches, at
    ptt.yaml's stage-0 shapes (B = 8, 1024 points, 512 centers, r = 0.3, ns =
    32), on the card against the CPU."""
    from ptt_tpu_torch.ops import point_ops

    xyz = points[..., :3].float().contiguous()
    centers = xyz[:, :512].contiguous()
    cpu_xyz, cpu_centers = xyz.cpu(), centers.cpu()
    d2 = point_ops.square_distance(centers, xyz, exact=True)
    if not torch.equal(d2.cpu(), point_ops.square_distance(cpu_centers, cpu_xyz, exact=True)):
        fail("[22a] square_distance(exact=True): the card's differs from the CPU's")
    feats = torch.randn(xyz.shape[0], xyz.shape[1], 16, device=device)
    for got, ref in zip(point_ops.group_all(xyz, feats), point_ops.group_all(cpu_xyz, feats.cpu())):
        if not torch.equal(got.cpu(), ref):
            fail("[22a] group_all: the card's differs from the CPU's")
    idx = point_ops.ball_query(0.3, 32, xyz, centers)
    out, cnt = point_ops.uniform_resample_idx(idx, torch.Generator(device=device).manual_seed(0))
    _, cpu_cnt = point_ops.uniform_resample_idx(idx.cpu(), torch.Generator().manual_seed(0))
    if not torch.equal(cnt.cpu(), cpu_cnt):
        fail("[22a] uniform_resample_idx: the unique counts differ from the CPU's")
    srt = torch.sort(idx.long(), dim=-1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[..., 1:] = srt[..., 1:] != srt[..., :-1]
    unique = torch.where(first, srt, torch.iinfo(torch.int64).max).sort(dim=-1).values
    slots = torch.arange(32, device=device)
    front = slots < cnt[..., None].long()
    members = (out.long()[..., :, None] == srt[..., None, :]).any(-1)
    if not (torch.where(front, out.long() == unique, True).all() and members.all()):
        fail("[22a] uniform_resample_idx: a row's front is not its sorted unique members, or a slot is not a member")
    log(f"[22a] point ops at (8, 1024) x 512 centers, r = 0.3, ns = 32: square_distance(exact=True) and group_all "
        f"torch.equal to the CPU's; uniform_resample_idx counts equal ({int(cnt.sum())} unique members in "
        f"{cnt.numel()} rows), fronts sorted unique, every slot a member")


def sim_no_bn_check(device):
    """22b: CosineSimAug with MLP.BN False at ptt.yaml's width, card against CPU."""
    from ptt_tpu_torch.config import ptt_config
    from ptt_tpu_torch.nn.similarity import CosineSimAug

    cfg = ptt_config()["MODEL"]["SIMILARITY_MODULE"]
    cfg["MLP"]["BN"] = False
    torch.manual_seed(SEED)
    module = CosineSimAug(cfg).eval()
    gen = torch.Generator().manual_seed(SEED)
    batch = {"search_feats": torch.randn(8, 128, 256, generator=gen),
             "template_feats": torch.randn(8, 64, 256, generator=gen),
             "template_seeds": torch.randn(8, 64, 3, generator=gen)}
    with torch.no_grad():
        ref = module(dict(batch))["cosine_feats"]
        got = module.to(device)({k: v.to(device) for k, v in batch.items()})["cosine_feats"].cpu()
    err = float((got - ref).abs().max() / ref.abs().max())
    log(f"[22b] CosineSimAug, MLP {cfg['MLP']['CHANNELS']} without BatchNorm (biases), B = 8, 64 x 128 seeds: "
        f"card against CPU, max error {err:.3g} of the largest output (limit {SIM_RTOL})")
    if not err <= SIM_RTOL:
        fail(f"[22b] CosineSimAug without BatchNorm: {err:.3g} > {SIM_RTOL}")


SIDE_TOOLS = (("fused_ab", ("fused_ab",)),
              ("parity_decomposition --device cuda", ("parity_decomposition", "--device", "cuda")),
              ("warmup --seed-out", ("warmup", "--seed-out", "cache_seeds")),
              ("warmup --train", ("warmup", "--train")),
              ("demo_tracking --workers 0", ("demo_tracking", "--workers", 0)))


def start_side_tools(card) -> tuple:
    """The tool runs whose checks are results, not times, started side by
    side: phase 22's (c), (d), (f) and phase 19's ``demo_tracking``. ``main``
    starts them before phase 16, whose checks are results too, and
    ``finish_side_tools`` waits for them; the seconds and ms they print are
    taken beside that work. Returns (t0, {name: process})."""
    log(f"[22] started beside what follows: {', '.join(name for name, _ in SIDE_TOOLS)}; card {card}")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    return time.perf_counter(), {name: subprocess.Popen(tool_cmd(*cmd), cwd=REPO, stdout=subprocess.PIPE,
                                                        stderr=subprocess.PIPE, text=True, env=env)
                                 for name, cmd in SIDE_TOOLS}


def finish_side_tools(meta, started) -> None:
    """Phase 22's (c) ``fused_ab`` (trained asset: kernels against plain within
    1.0 in Success and Precision), (d) ``parity_decomposition --device cuda``
    (the deployed row within 2.0 of the asset's host numbers), (f)
    ``warmup --train`` and ``warmup --seed-out`` (refused with its reason),
    and phase 19's ``demo_tracking``: waits for the processes
    ``start_side_tools`` started and checks their output."""
    t0, side = started
    out, _ = finish_tool("[22c]", "fused_ab", side["fused_ab"], t0)
    for row in ("eval Success", "eval Precision"):
        delta = float(table_cells(out, row)[3])
        if not delta <= 1.0:
            fail(f"[22c] fused_ab: |delta {row.split()[1]}| {delta} > 1.0")
    out, _ = finish_tool("[22d]", "parity_decomposition --device cuda", side["parity_decomposition --device cuda"], t0)
    cells = table_cells(out, "deployed")
    host = [float(x) for x in cells[1].split("/")]
    dev = [float(x) for x in cells[2].split("/")]
    recorded = (meta["host_success"], meta["host_precision"])
    if not all(abs(x - r) <= 2.0 for pair in (host, dev) for x, r in zip(pair, recorded)):
        fail(f"[22d] deployed row host {host}, device {dev}: more than 2.0 from the asset's host {recorded}")
    _, err = finish_tool("[22f]", "warmup --seed-out cache_seeds", side["warmup --seed-out"], t0, expect_rc=None)
    if "no counterpart" not in err:
        fail("[22f] warmup --seed-out was refused without its reason")
    log(f"  refused: {err.strip()}")
    finish_tool("[22f]", "warmup --train (beside phase 16 and the other side tools)", side["warmup --train"], t0)
    finish_tool("[19]", "demo_tracking --workers 0 (beside phase 16 and the other side tools)",
                side["demo_tracking --workers 0"], t0)


def ported_modules_phase(points, card):
    """Phase 22: the JAX package's last modules in the port, the
    side tools aside (``finish_side_tools``). (a) and (b) in this process;
    then the tools as a user runs them, ``python3 -m
    ptt_tpu_torch.tools.<name>``, one at a time, as they time the card: (e)
    ``compile_diag`` cold into a fresh build directory and warm from
    ``build/``, (g) ``train_ablate --iters 4`` (six finite rows)."""
    device = points.device
    t_phase = time.perf_counter()
    log(f"[22] the JAX package's last modules in the port; card {card}")
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    point_ops_check(points, device)
    sim_no_bn_check(device)
    cold = tempfile.mkdtemp(prefix="chip_smoke_build_")
    try:
        for tag, args in (("cold", ("--build-dir", cold)), ("warm", ())):
            t0 = time.perf_counter()
            proc = subprocess.Popen(tool_cmd("compile_diag", *args), cwd=REPO, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, env=env)
            finish_tool(f"[22e] {tag}", f"compile_diag {' '.join(args)}".strip(), proc, t0)
    finally:
        shutil.rmtree(cold, ignore_errors=True)
    t0 = time.perf_counter()
    out, _ = finish_tool("[22g]", "train_ablate --iters 4",
                         subprocess.Popen(tool_cmd("train_ablate", "--iters", 4), cwd=REPO, env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), t0)
    from ptt_tpu_torch.tools.train_ablate import ROWS

    for name, *_ in ROWS:
        cells = table_cells(out, name)
        try:
            values = [float(cells[i].rstrip("%")) for i in range(1, 9)]
        except (IndexError, ValueError):
            values = [float("nan")]
        if not np.isfinite(values).all():
            fail(f"[22g] train_ablate: row '{name}' is missing a number: {cells}")
    log(f"[22] {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        log("no CUDA device: chip_smoke.py runs on a GPU")
        return 1
    adopt_orphans()
    faulthandler.enable()  # a crash in native code prints the Python stack of every thread
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.config import config_by_path, p2b_synth_config, ptt_large_config, ptt_synth_config
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import set_use_kernels
    from ptt_tpu_torch.ops import _build
    from ptt_tpu_torch.tools.bench_setup import agreement_setup

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

    cfg, model, agreement, meta = agreement_setup(device)

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
    # 23. the eval-mode float32 product kernel at the frame step's eight products
    phase23 = tf32x3_phase(card)
    # 24. the vector-attention kernels at the cells' four calls
    phase24 = vattn_phase(card)
    log(f"[time] phases 1-3, 23 and 24: {time.perf_counter() - t_start:.1f} s")

    # 4. the tracker on the trained weights
    ev = DeviceTrackingEvaluator(cfg, model, max_points=1024, batch_size=8, device=device)
    timer.reset()
    t0 = time.perf_counter()
    results = ev.track_batch(agreement)
    torch.cuda.synchronize()
    launches, attention = launch_counts("fps", "sa", "tf32x3"), vattn_counts()
    s = ev.summary()
    steps = 32 - 1  # 24 frames pad to the 32-frame bucket; frame 0 is the given box
    log(f"[4] tracker: {s['frames']} frames in {time.perf_counter() - t0:.2f} s (first batch); "
        f"Success {s['success']:.2f} Precision {s['precision']:.2f}; recorded host "
        f"{meta['host_success']:.2f}/{meta['host_precision']:.2f} "
        f"(delta {s['success'] - meta['host_success']:+.2f}/{s['precision'] - meta['host_precision']:+.2f}); "
        f"launches {launches}, vector attention {attention} over {steps} frame steps")
    centers = np.array([[b.center for b in trk] for trk in results])
    if s["frames"] != 192 or not np.isfinite(centers).all():
        fail("tracker: wrong frame count or non-finite boxes")
    if s["success"] < 50.0:
        fail(f"tracker: Success {s['success']:.2f} < 50")
    if launches != {"fps": 2 * steps, "sa": 7 * steps, "tf32x3": 8 * steps}:
        fail(f"tracker: launches {launches}, expected 2, 7 and 8 per frame step over {steps} steps")
    check_vattn_counts("[4]", attention, 2, steps)
    launches["vattn"] = attention["vattn"]
    device_launches = profile_batch(ev, agreement, s["frames"], "[4]", quiet=True)["launches"]
    check_device_launches("[4]", device_launches, 2, steps)
    ev.close()

    bench = bench_tracklets()
    ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device)
    n_frames = sum(len(t[0]) for t in bench)
    bench_rate(ev, bench, 1)  # warm-up
    rates = [bench_rate(ev, bench, 2) for _ in range(3)]
    set_use_kernels(model, False)
    plain_rate = bench_rate(ev, first_frames(bench, 32), 1)
    set_use_kernels(model, True)
    log(f"[4] throughput, 8 x 64-frame tracklets, 2 pipelined batches per run: "
        f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f}); "
        f"plain path {plain_rate:.1f} frames/s (one batch cut to 32 frames, graphed, its capture included); "
        f"card {card}")
    prof = profile_batch(ev, bench, n_frames)
    check_device_launches("[5]", prof["launches"], 2, len(bench[0][0]) - 1)
    ev.close()
    del ev
    torch.cuda.empty_cache()
    graph_rows = [graph_vs_eager("[17]", "ptt.yaml", cfg, model, bench, device, card, 2)]

    log(f"[time] phases 1-5 and 17 of ptt.yaml: {time.perf_counter() - t_start:.1f} s")
    # 6 and 7: the training path; 14: ptt_waymo training
    train_launches, group_rows = train_phase(ptt_synth_config(), device, card)
    log(f"[time] phases 6 and 7: {time.perf_counter() - t_start:.1f} s")
    waymo_group_rows = waymo_train_phase(device, card)
    log(f"[time] phases 6, 7 and 14: {time.perf_counter() - t_start:.1f} s")
    # 21: the train step as one CUDA graph, K = 1 and 4, against the eager step, in a fresh process
    phase21 = phase21_process()

    log(f"[time] phase 21: {time.perf_counter() - t_start:.1f} s")
    # 8 and 9: ptt_large.yaml and p2b_synth.yaml at full width
    check_sa_limit(device)
    large_rows, large_launches = config_phase("[8]", "ptt_large.yaml", ptt_large_config(), device, card, clock, 2,
                                              4, agreement, bench, graph_rows)
    p2b_rows, p2b_launches = config_phase("[9]", "p2b_synth.yaml (P2B)", p2b_synth_config(), device, card, clock, 1,
                                          0, agreement, bench, graph_rows)
    log(f"[time] phases 8 and 9: {time.perf_counter() - t_start:.1f} s")

    # 10. every tracking mode and the host evaluator on the trained weights
    phase10 = modes_phase(cfg, model, meta, agreement, device)
    log(f"[time] phase 10: {time.perf_counter() - t_start:.1f} s")
    # 17. the captured frame step against the eager loop (the benchmark batches ran with phases 4, 8, 9, 13)
    phase17 = graph_phase(cfg, model, agreement, device)

    # 11 and 12: the CLIs on KITTI-format trees; 13, 15, 16: ptt_waymo's tracker, bf16 and the optimizers, nuScenes
    log(f"[time] phases 8, 9, 10 and 17: {time.perf_counter() - t_start:.1f} s")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_kitti_")
    try:
        phase11a = kitti_test_phase(agreement, phase10, model, device, card, tmp)
        log(f"[time] phase 11: {time.perf_counter() - t_start:.1f} s")
        kitti_train_phase(model, batch, device, card)
        log(f"[time] phase 12: {time.perf_counter() - t_start:.1f} s")
        # 18. data parallelism: two ranks on the one card against one process
        phase18 = {"train": dist_train_phase(device, card, tmp),
                   "test": dist_test_phase(os.path.join(tmp, "agreement"), phase11a, model, device, card, tmp)}
        log(f"[time] phase 18: {time.perf_counter() - t_start:.1f} s")
        del model
        torch.cuda.empty_cache()
        waymo_rows, waymo_launches = config_phase("[13]", "ptt_waymo.yaml", config_by_path("kitti_models/ptt_waymo.yaml"),
                                                  device, card, clock, 2, 4, agreement, bench, graph_rows)
        phase13b = waymo_cli_phase(os.path.join(tmp, "sweeps"), card)
        log(f"[time] phases 13 and 13b: {time.perf_counter() - t_start:.1f} s")
        # 20. POINT_SHARDING: two ranks on the one card as one point group
        phase20 = point_phase(os.path.join(tmp, "sweeps"), phase13b, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[time] phases 11, 12, 18, 13, 20: {time.perf_counter() - t_start:.1f} s")
    bf16_phase(device, card)
    log(f"[time] phase 15: {time.perf_counter() - t_start:.1f} s")
    side_tools = start_side_tools(card)  # results, not times: beside phase 16, checked before phase 19
    nuscenes_phase(agreement, phase10, card, beside=" (beside the side tools of phase 22)")
    finish_side_tools(meta, side_tools)
    log(f"[time] phases 15, 16 and the side tools beside 16: {time.perf_counter() - t_start:.1f} s")
    # 19. train_bench and demo_tracking
    torch.cuda.empty_cache()
    tools_phase(card)
    gemm_layers(cfg, batch, device, card)
    log(f"[time] phases 19 and 19b: {time.perf_counter() - t_start:.1f} s")
    # 22. the JAX package's last modules: the point ops, CosineSimAug without BatchNorm, the six tools
    ported_modules_phase(batch["search_points"], card)
    log(f"[time] phases 19 and 22: {time.perf_counter() - t_start:.1f} s")

    record = {"kernels": []}
    for name, src, replaces in (("fps", "ptt_tpu_torch/csrc/fps.cu", "ptt_tpu/ops/pallas_fps.py:37"),
                                ("sa", "ptt_tpu_torch/csrc/sa.cu", "ptt_tpu/ops/pallas_sa.py:82")):
        rs = rows[name]
        bms = sum(r["bound_ms"] for r in rs)
        record["kernels"].append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "device_launches": device_launches[f"{name}_kernel"],
            "max_abs_err": summary[name]["max_abs_err"],
            "ms": summary[name]["ms"], "plain_ms": summary[name]["plain_ms"], "bound_ms": bms,
            "bound_by": max(rs, key=lambda r: r["bound_ms"])["bound_by"], "library_ms": None,
        })
        record["kernels"][-1]["device_ms"] = summary[name]["device_ms"]
        record["kernels"][-1]["launches_by_path"] = {
            "ptt.yaml tracker (agreement batch)": launches[name],
            "ptt_large.yaml tracker (benchmark batch)": large_launches[name],
            "p2b_synth.yaml tracker (benchmark batch)": p2b_launches[name],
            "ptt_waymo.yaml tracker (benchmark batch)": waymo_launches[name],
            "ptt_waymo.yaml test CLI, a point group of 2 (rank 0, 159 steps)": phase20[f"{name}_launches"]}
        if name == "fps":
            record["kernels"][-1]["launches_by_path"].update({
                "ptt_synth.yaml train step graph, 5 replays (21a)": phase21["a_launches"]["fps"],
                "Trainer, STEPS_PER_DISPATCH = 4, 2 epochs of 5 steps (21e)": phase21["e"]["launches"]["fps"]})
        if name == "sa":
            record["kernels"][-1]["split_launches_by_centers"] = phase20["sa_split"]
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
        record["kernels"][-1]["launches_by_path"] = {
            "ptt_synth.yaml train step, 5 eager steps (7)": train_launches[name],
            "ptt_synth.yaml train step graph, 5 replays (21a)": phase21["a_launches"][name],
            "Trainer, STEPS_PER_DISPATCH = 4, 2 epochs of 5 steps (21e)": phase21["e"]["launches"][name]}
        record["kernels"][-1]["shapes"] = [
            {"config": config, "shape": r["shape"], "err": r[f"{pre}_err"], "ms": r[f"{pre}_ms"],
             "device_ms": r[f"{pre}_device_ms"], "plain_ms": r[f"{pre}_plain_ms"], "bound_ms": r[f"{pre}_bound"],
             "bound_by": r[f"{pre}_by"], **({"library_ms": r["lib_ms"]} if pre == "bwd" else {})}
            for config, rs_ in (("ptt_synth.yaml", group_rows), ("ptt_waymo.yaml", waymo_group_rows)) for r in rs_]
    rows23 = phase23["rows"]
    record["kernels"].append({
        "name": "tf32x3", "route": "cuda", "source": "ptt_tpu_torch/csrc/tf32x3.cu", "replaces": None,
        "launches": launches["tf32x3"], "max_rel_err": max(r["err"] for r in rows23),
        "ms": phase23["total"]["ms"], "plain_ms": phase23["total"]["plain_ms"], "bound_ms": phase23["total"]["bound_ms"],
        "bound_by": "operations", "library_ms": phase23["total"]["library_ms"], "device_ms": phase23["device_ms"],
        "launches_by_path": {"ptt.yaml tracker (agreement batch)": launches["tf32x3"]},
        "shapes": [{"config": "ptt.yaml", **r} for r in rows23], "crossover": phase23["sweep"]})
    record["kernels"].append({
        "name": "vattn", "route": "cuda", "source": "ptt_tpu_torch/csrc/vattn.cu", "replaces": None,
        "launches": launches["vattn"],
        "launches_by_path": {"ptt.yaml tracker (agreement batch)": launches["vattn"],
                             "ptt_large.yaml tracker (benchmark batch)": large_launches["vattn"],
                             "p2b_synth.yaml tracker (benchmark batch)": p2b_launches["vattn"],
                             "ptt_waymo.yaml tracker (benchmark batch)": waymo_launches["vattn"]},
        "max_rel_err": max(max(r["res_err"], r["attn_err"]) for r in phase24["rows"]),
        "bound_by": "bytes", "device_ms": phase24["device_ms"], "steps": phase24["steps"], "shapes": phase24["rows"]})
    log("graphs " + json.dumps({"benchmark": graph_rows, **phase17}))
    log("data_parallel " + json.dumps(phase18))
    log("point_sharding " + json.dumps(phase20))
    log("train_graph " + json.dumps(phase21))
    log("profiler_windows " + json.dumps({"main": profiler_windows, "phase 21": phase21["profiler_windows"]}))
    stop_children()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def loader_start() -> int:
    """``python3 chip_smoke.py --loader-start``, not a run: seconds from making
    a ptt_synth.yaml train loader of LOADER_WORKERS workers to its first
    batch, and for 15 more, by the start method: ``spawn`` (each worker a new
    interpreter), then the loader's ``forkserver`` (its first pool in this
    process, then a later one), then ``spawn`` again. On the GPU's host."""
    import multiprocessing

    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.data import loader as loader_mod
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset

    if not torch.cuda.is_available():
        log("no CUDA device: --loader-start measures the GPU's host")
        return 1
    adopt_orphans()
    log(f"card {gpu_line()}; os.cpu_count() {os.cpu_count()}")
    dataset = SyntheticTrackingDataset(ptt_synth_config()["DATA_CONFIG"])
    for method in ("spawn", "forkserver", "forkserver", "spawn"):
        t0 = time.perf_counter()
        loader = loader_mod.DataLoader(dataset, TRAIN_B, shuffle=True, drop_last=True, num_workers=LOADER_WORKERS)
        if method == "spawn":
            loader._context = multiprocessing.get_context("spawn")
        it = iter(loader)
        next(it)
        first = time.perf_counter() - t0
        for _ in range(15):
            next(it)
        log(f"{method}: first batch {first:.2f} s, 15 more {time.perf_counter() - t0 - first:.2f} s")
        loader.close()
    return 0


TRACE_COST_ORDER = (True, False, False, True, True, False)  # three pairs of processes, alternated; True: traced first
TRACE_COST_TIMEOUT = 300  # seconds a process of --trace-cost may take


def trace_cost() -> int:
    """``python3 chip_smoke.py --trace-cost``, not a run: what a trace that
    keeps CUPTI attached (``utils/profiling.py`` ``CUPTI_SETTINGS``) costs the
    graphed work after it. Three pairs of fresh processes, alternated (traced
    first, never traced; never, traced; traced, never), each
    ``trace_cost_process``; prints each process's numbers, the medians of
    each kind and the card."""
    if not torch.cuda.is_available():
        log("no CUDA device: --trace-cost measures the GPU")
        return 1
    adopt_orphans()
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.ops import _build

    _build.build()  # once, before the processes load it
    card = gpu_line()
    rows = {True: [], False: []}
    for traced in TRACE_COST_ORDER:
        try:
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--trace-cost-process",
                                  "traced" if traced else "clean"], cwd=REPO, capture_output=True, text=True,
                                 timeout=TRACE_COST_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"--trace-cost: a process took more than {TRACE_COST_TIMEOUT} s")
        records = [json.loads(line.split(" ", 1)[1]) for line in out.stdout.splitlines()
                   if line.startswith("trace_cost {")]
        if out.returncode != 0 or not records:
            log(out.stdout[-4000:] + out.stderr[-4000:])
            fail(f"--trace-cost: a process exited with {out.returncode}")
        rows[traced].append(records[-1])
        log(f"{'traced first' if traced else 'never traced'}: " + json.dumps(records[-1]))
    for traced, recs in rows.items():
        fps_ = sorted(x for r in recs for x in r["frames_per_s"])
        ms = sorted(x for r in recs for x in r["train_ms"])
        log(f"{'traced first' if traced else 'never traced'}, {len(recs)} processes: ptt.yaml graphed tracker "
            f"{', '.join(f'{x:.1f}' for x in fps_)} frames/s (median {fps_[len(fps_) // 2]:.1f}); graphed train step "
            f"{', '.join(f'{x:.2f}' for x in ms)} ms a step (median {ms[len(ms) // 2]:.2f})")
    log(f"card {card}")
    stop_children()
    return 0


def trace_cost_process(traced: bool) -> int:
    """One process of ``trace_cost``: ptt.yaml's graphed tracker on the
    benchmark workload (8 x 64 frames, max_points 2048, the trained asset) and
    ptt_synth.yaml's graphed train step (B = 48, K = 1, the Trainer's loop over
    4 pre-made batches), each captured and run once; then, if ``traced``, one
    tracker batch and 4 train steps in the port's profiler window, else the
    same work untraced; then frames/s of 3 runs of 2 pipelined batches and ms
    a step of 3 runs of 8 steps. Prints ``trace_cost {json}``."""
    faulthandler.enable()
    sys.path.insert(0, REPO)
    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.convert import state_dict_from_npz
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.ops import _build
    from ptt_tpu_torch.tools.bench_setup import agreement_setup
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import BatchUploader, make_train_step
    from ptt_tpu_torch.train.trainer import pipelined_steps
    from ptt_tpu_torch.utils.profiling import device_window

    _build.build()
    device = torch.device("cuda")
    cfg, model, _, _ = agreement_setup(device)
    bench = bench_tracklets()
    ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device)
    bench_rate(ev, bench, 1)  # the capture
    tcfg = ptt_synth_config()
    loader, batches = train_batches(tcfg["DATA_CONFIG"], 4, seed=21, workers=0)
    n_iters = len(loader)
    loader.close()
    net = build_network(tcfg["MODEL"], device=device, train=True)
    net.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    opt = Optimizer(net.parameters(), tcfg["OPTIMIZATION"], n_iters)
    step, uploader = make_train_step(tcfg["MODEL"], device=device), BatchUploader(device)
    pipelined_steps(step, net, opt, batches, uploader)  # the capture, then replays

    def work():
        ev.finish_batch(ev.dispatch_batch(bench))
        pipelined_steps(step, net, opt, batches, uploader)
        torch.cuda.synchronize()

    events = None
    if traced:
        with device_window() as window:
            work()
        events = len(window.events)
        if not events:
            fail("--trace-cost: the traced window holds no device activity")
    else:
        work()
    rates = [bench_rate(ev, bench, 2) for _ in range(3)]
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = len(pipelined_steps(step, net, opt, batches * 2, uploader))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / n)
    ev.close()
    print("trace_cost " + json.dumps({"traced": traced, "device_events_traced": events, "frames_per_s": rates,
                                      "train_ms": ms, "TEARDOWN_CUPTI": os.environ.get("TEARDOWN_CUPTI")}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-rank"]:  # a rank of phase 18a, started by torchrun
        sys.exit(dist_train_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--point-rank"]:  # a rank of phase 20a, started by torchrun
        sys.exit(point_rank(sys.argv[2]))
    if sys.argv[1:2] == ["--loader-start"]:
        sys.exit(loader_start())
    if sys.argv[1:2] == ["--phase21"]:  # phase 21's process, started by main
        sys.exit(phase21_only())
    if sys.argv[1:2] == ["--trace-cost"]:
        sys.exit(trace_cost())
    if sys.argv[1:2] == ["--tf32x3"]:
        sys.exit(tf32x3_only())
    if sys.argv[1:2] == ["--vattn"]:
        sys.exit(vattn_only())
    if sys.argv[1:2] == ["--trace-cost-process"]:  # a process of --trace-cost
        sys.exit(trace_cost_process(sys.argv[2] == "traced"))
    sys.exit(main())
