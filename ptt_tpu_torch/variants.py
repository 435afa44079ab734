"""Where a kernel's time goes, without a profiler that can see inside it: build
text-patched copies of ``csrc/fps.cu`` and ``csrc/group.cu`` (a part skipped, a
constant changed), run each at the shapes of the main paths and time them in one
process on one card. The splits and the design choices in ``PERF.md`` come from
this script.

    python3 -m ptt_tpu_torch.variants [--parent DIR]

Run it from the root of the repo on a machine with the GPU and nvcc. ``--parent
DIR`` names a checkout of an earlier commit: its FPS and group forward are
then built and timed beside this tree's, and its ``csrc/sa.cu`` is put behind
the SA wrapper at the 7 calls of a ``ptt.yaml`` frame step (parent, this tree,
this tree, parent), and the ``ptt.yaml`` tracker runs on the benchmark
workload with the parent's package and this tree's, one process each, in the
same order. Every variant that should
still compute the function is held against the plain version; one that skips a
part is timed only. Copies and libraries go to ``build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from .ops import _build, fps, group, point_ops, sa

ROOT = Path(__file__).resolve().parent.parent
CSRC = Path(__file__).resolve().parent / "csrc"
OUT = ROOT / "build" / "variants"
_p, _i = ctypes.c_void_p, ctypes.c_int
FPS_ARGS = [_p, _p, _i, _i, _i, _p]
FWD_ARGS = [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, ctypes.c_float, _p]

# name -> (replacements in csrc/group.cu, whether D must still equal the plain version)
LOAD = "v[u] = __ldg(zb + static_cast<size_t>(row[s0 + u]) * hv + col);"
STORE = "__stcs(dst + (s0 + u) * slot_stride, add4(v[u], o));"
QUERY = "  ptt::block_ball_query<kWarps>(pts, n, ctr + row0 * 3, kTile, tm, r2, ns, hits, cnt, nbr, kTile * ns);\n"
IDX_STORE = "  for (int e = threadIdx.x; e < (tm * ns) >> 2; e += kThreads) idx4[e] = reinterpret_cast<const int4*>(nbr)[e];\n"
GROUP_VARIANTS = {
    "ball query and idx only": ([(IDX_STORE, IDX_STORE + "  return;\n")], False),
    "no ball query (table read back)": ([(QUERY, "  for (int e = threadIdx.x; e < tm * ns; e += kThreads) nbr[e] = idx[row0 * ns + e];\n"
                                          "  __syncthreads();\n")], True),
    "stores without the gather (D = O)": ([(LOAD, "v[u] = o;")], False),
    "plain stores": ([(STORE, "dst[(s0 + u) * slot_stride] = add4(v[u], o);")], True),
    "tile of 16 centers": ([("constexpr int kTile = kWarps;", "constexpr int kTile = 2 * kWarps;")], True),
    "8 loads in flight, 4 blocks an SM": ([("constexpr int kFwdInFlight = 4;", "constexpr int kFwdInFlight = 8;"),
                                           ("constexpr int kFwdBlocksPerSm = 6;", "constexpr int kFwdBlocksPerSm = 4;")], True),
    "no thread groups": ([("  const int groups = tile_pairs < kThreads ? kThreads / tile_pairs : 1;", "  const int groups = 1;")], True),
}
# other forms (warps x points a thread), each for the clouds of one form of
# csrc/fps.cu: name -> (edits, N of the calls it changes)
FORMS = "X(128, 1, 4) X(1024, 8, 4) X(2048, 16, 4) X(8192, 16, 16)"
FPS_VARIANTS = {
    "2 warps x 16 points": ([(FORMS, FORMS.replace("X(1024, 8, 4)", "X(1024, 2, 16)"))], 1024),
    "4 warps x 8 points": ([(FORMS, FORMS.replace("X(1024, 8, 4)", "X(1024, 4, 8)"))], 1024),
    "16 warps x 2 points": ([(FORMS, FORMS.replace("X(1024, 8, 4)", "X(1024, 16, 2)"))], 1024),
    "32 warps x 8 points at 8192": ([(FORMS, FORMS.replace("X(8192, 16, 16)", "X(8192, 32, 8)"))], 8192),
}


def apply(text: str, edits, name: str) -> str:
    """``text`` with every (old, new) of ``edits`` applied; raises when a source
    no longer holds an ``old``, so that a variant cannot silently time the
    unpatched kernel."""
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant '{name}': the source no longer holds\n{old}")
        text = text.replace(old, new)
    return text


def patched(src: Path, name: str, edits) -> Path:
    out = OUT / (re.sub(r"[^a-z0-9]+", "_", name.lower()) + "-" + src.name)
    out.write_text(apply(src.read_text(), edits, name))
    return out


LIBS: dict = {}  # job name -> its loaded library


def build_all(jobs: dict) -> dict:
    """jobs: name -> (source, include directory, entry point, argument types, ...).
    One nvcc each, all at once; returns name -> the entry point."""
    nvcc = _build._nvcc()
    procs = {}
    for k, (name, job) in enumerate(jobs.items()):
        src, inc = job[:2]
        lib = OUT / f"lib{k}.so"
        procs[name] = (lib, subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(inc), "-o", str(lib), str(src)],
                                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for '{name}':\n{log}")
        LIBS[name] = ctypes.CDLL(str(lib))
        fn = getattr(LIBS[name], jobs[name][2])
        fn.argtypes, fn.restype = jobs[name][3], ctypes.c_int
        fns[name] = fn
    return fns


def time_sa_against_parent(cs, parent_fn, parent_prep, dev):
    """The 7 SA calls of a ``ptt.yaml`` frame step (B = 8, trained weights),
    each through the wrapper with the parent's library and this tree's behind
    it in turn (parent, this tree, this tree, parent): device ms by
    ``queued_ms`` and ``sa_kernel``'s by the profiler; outputs bit-equal."""
    from .config import ptt_config
    from .convert import state_dict_from_npz
    from .data.synthetic import make_tracklets
    from .nn import build_network

    cfg = ptt_config()
    model = build_network(cfg["MODEL"], device=dev)
    model.load_state_dict(state_dict_from_npz(cs.ASSET), strict=True)
    tracklets = make_tracklets({"NUM_TRACKLETS": 8, "FRAMES_PER_TRACKLET": 24, "SYNTH_SEED": 11})
    calls = cs.capture_kernel_calls(model, cs.first_step_batch(tracklets, cfg, dev))["sa"]
    sa_forward, prep = _build.function("sa_forward"), _build.function("sa_prep_floats")
    libs = {"parent": (parent_fn, parent_prep), "this tree": (sa_forward, prep)}
    total = {}
    for args, kwargs in calls:
        shape = f"{tuple(args[0].shape)}->{args[1].shape[1]} ns{args[4]}"
        outs, line = {}, []
        for k, name in enumerate(("parent", "this tree", "this tree", "parent")):
            _build._loaded["sa_forward"], _build._loaded["sa_prep_floats"] = libs[name]
            try:
                outs[name] = sa.fused_sa_inference(*args, **kwargs)
                ms = cs.queued_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 20)
                part = cs.kernel_ms(lambda: sa.fused_sa_inference(*args, **kwargs), 10, ("sa_kernel",))["sa_kernel"]
            finally:
                _build._loaded["sa_forward"], _build._loaded["sa_prep_floats"] = sa_forward, prep
            key = f"{name} {1 + k // 2 if name == 'this tree' else 1 + k // 3}"
            total[key] = total.get(key, 0.0) + ms
            total[key + ", sa_kernel"] = total.get(key + ", sa_kernel", 0.0) + part
            line.append(f"{key} {ms:.4f} (sa_kernel {part:.4f})")
        if not torch.equal(outs["parent"], outs["this tree"]):
            raise RuntimeError(f"SA at {shape}: this tree's kernel differs from the parent's")
        print(f"sa {shape}, device ms: " + "; ".join(line) + "; outputs bit-equal", flush=True)
    print("sa, the 7 calls of a ptt.yaml frame step summed, device ms: "
          + "; ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)


# one run of the ptt.yaml tracker on the trained weights and the benchmark
# workload, with the ptt_tpu_torch package under argv[1]; argv[2] is this repo
# (chip_smoke.py, the asset), argv[3] the file for the first batch's centers
TRACKER_RUN = """
import json, sys
import numpy as np
sys.path[:0] = sys.argv[1:3]
import chip_smoke as cs
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.convert import state_dict_from_npz
from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.ops import _build
_build.build()
cfg = ptt_config()
model = build_network(cfg["MODEL"], device="cuda")
model.load_state_dict(state_dict_from_npz(cs.ASSET), strict=True)
bench = cs.bench_tracklets()
ev = DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device="cuda")
np.save(sys.argv[3], np.array([[b.center for b in trk] for trk in ev.track_batch(bench)]))
print(json.dumps([cs.bench_rate(ev, bench, 4) for _ in range(3)]))
"""


def time_tracker_against_parent(parent: Path):
    """The ``ptt.yaml`` tracker as chip_smoke.py's phase 4 times it (trained
    weights, 8 x 64-frame tracklets, ``max_points`` 2048, 3 runs of 4
    pipelined batches after a warm-up batch), one process for each of parent,
    this tree, this tree, parent; prints frames/s and how far the four runs'
    boxes part."""
    boxes = []
    for k, (name, root) in enumerate((("parent", parent), ("this tree", ROOT), ("this tree", ROOT),
                                      ("parent", parent))):
        out = OUT / f"tracker-{k}.npy"
        run = subprocess.run([sys.executable, "-c", TRACKER_RUN, str(root), str(ROOT), str(out)], cwd=ROOT,
                             capture_output=True, text=True, check=False)
        if run.returncode:
            raise RuntimeError(f"the tracker run with the {name}'s package failed:\n{run.stderr[-4000:]}")
        rates = json.loads(run.stdout.strip().splitlines()[-1])
        boxes.append(np.load(out))
        print(f"tracker ptt.yaml, {name} {1 + k // 2 if name == 'this tree' else 1 + k // 3}: "
              f"{', '.join(f'{r:.1f}' for r in rates)} frames/s (median {sorted(rates)[1]:.1f})", flush=True)
    diff = max(float(np.abs(b - boxes[0]).max()) for b in boxes)
    print(f"tracker ptt.yaml, first batch's box centers: largest difference between the four runs {diff:.3e}",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, help="checkout of an earlier commit to time beside this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: the variants run on a GPU")
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from .config import ptt_synth_config
    from .convert import state_dict_from_npz
    from .nn import build_network

    dev = torch.device("cuda")
    print(f"card: {cs.gpu_line()}", flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    # group jobs end with whether the variant must still equal the plain version
    jobs = {"this tree": (CSRC / "group.cu", CSRC, "group_forward", FWD_ARGS, True)}
    for name, (edits, exact) in GROUP_VARIANTS.items():
        jobs[name] = (patched(CSRC / "group.cu", name, edits), CSRC, "group_forward", FWD_ARGS, exact)
    fps_jobs = {"this tree": (CSRC / "fps.cu", CSRC, "fps_forward", FPS_ARGS)}
    for name, (edits, _) in FPS_VARIANTS.items():
        fps_jobs[name] = (patched(CSRC / "fps.cu", name, edits), CSRC, "fps_forward", FPS_ARGS)
    sa_jobs = {}
    if args.parent:
        pc = args.parent.resolve() / "ptt_tpu_torch" / "csrc"
        sa_jobs = {"parent": (pc / "sa.cu", pc, "sa_forward", _build._FUNCTIONS["sa_forward"][1])}
        jobs["parent"] = (pc / "group.cu", pc, "group_forward", FWD_ARGS, True)
        fps_jobs["parent"] = (pc / "fps.cu", pc, "fps_forward", FPS_ARGS)
    fns = build_all({**jobs, **{"fps: " + k: v for k, v in fps_jobs.items()}, **{"sa: " + k: v for k, v in sa_jobs.items()}})
    stream = torch.cuda.current_stream().cuda_stream
    if sa_jobs:
        prep = LIBS["sa: parent"].sa_prep_floats
        prep.argtypes, prep.restype = _build._FUNCTIONS["sa_prep_floats"][1], ctypes.c_int
        time_sa_against_parent(cs, fns["sa: parent"], prep, dev)

    # FPS at the call shapes of the main paths, ptt_waymo.yaml's two last
    gen = torch.Generator(device=dev).manual_seed(4)
    extent = torch.tensor([2.2, 1.0, 0.8], device=dev)
    for B, N, m in ((16, 1024, 512), (8, 128, 64), (2 * cs.TRAIN_B, 1024, 512), (cs.TRAIN_B, 128, 64),
                    (16, 8192, 2048), (8, 256, 128)):
        xyz = (torch.rand((B, N, 3), device=dev, generator=gen) * 2 - 1) * extent
        ref = point_ops.furthest_point_sample(xyz, m)
        out = torch.empty((B, m), dtype=torch.int32, device=dev)
        line = [f"wrapper {cs.queued_ms(lambda: fps.furthest_point_sample(xyz, m), 20):.4f}"]
        for name in fps_jobs:
            if name in FPS_VARIANTS and FPS_VARIANTS[name][1] != N:
                continue  # a variant changes the form of one N only
            fn = fns["fps: " + name]
            call = lambda: fn(xyz.data_ptr(), out.data_ptr(), B, N, m, stream)
            out.zero_()
            _build.check_launch(call(), name)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise RuntimeError(f"fps variant '{name}' differs from the plain version at {(B, N, m)}")
            line.append(f"{name} {cs.queued_ms(call, 20):.4f}")
        print(f"fps ({B}, {N}, 3)->{m}, device ms: " + "; ".join(line), flush=True)

    # the group forward at the 7 shapes of a B = 48 train step and the heavy-duplication cloud
    cfg = ptt_synth_config()
    _, batches = cs.train_batches(cfg["DATA_CONFIG"], 1)
    model = build_network(cfg["MODEL"], device=dev, train=True)
    model.load_state_dict(state_dict_from_npz(cs.ASSET), strict=True)
    calls = cs.capture_group_calls(model, batches[0], dev)
    total: dict = {}
    for c in calls + [cs.heavy_duplication_call(calls[0])]:
        xyz, new_xyz, r, ns = c["xyz"], c["new_xyz"], c["radius"], c["nsample"]
        B, N, _ = xyz.shape
        M, H = new_xyz.shape[1], c["w1"].shape[1]
        z, off = group.fold_inputs(xyz, new_xyz, c["features"], c["w1"], r, c["normalize_xyz"], c["use_xyz"])
        d_ref, idx_ref = group.group_forward_plain(xyz, new_xyz, z, off, r, ns)
        out, idx = torch.empty_like(d_ref), idx_ref.clone()
        ptrs = (xyz.data_ptr(), new_xyz.data_ptr(), z.data_ptr(), off.data_ptr(), out.data_ptr(), idx.data_ptr(),
                B, N, M, ns, H, point_ops.radius_sq(r))
        times = {"bound": cs.bound_ms(*cs.group_fwd_bound(xyz, new_xyz, H, r, ns, point_ops))[0],
                 "a fill of D": cs.queued_ms(lambda: out.zero_(), 20),
                 "wrapper": cs.queued_ms(lambda: group.group_forward(xyz, new_xyz, z, off, r, ns), 20)}
        for name in jobs:
            call = lambda: fns[name](*ptrs, stream)
            out.zero_()
            _build.check_launch(call(), name)
            torch.cuda.synchronize()
            if jobs[name][4] and not (torch.equal(out, d_ref) and torch.equal(idx, idx_ref)):
                raise RuntimeError(f"group variant '{name}' differs from the plain version at {N}->{M} H{H}")
            times[name] = cs.queued_ms(call, 20)
        label = " (heavy duplication)" if "label" in c else ""
        print(f"group forward {N}->{M} ns{ns} H{H}{label}, device ms: " + "; ".join(f"{k} {v:.4f}" for k, v in times.items()),
              flush=True)
        if not label:
            for k, v in times.items():
                total[k] = total.get(k, 0.0) + v
    print("group forward, the 7 shapes summed: " + "; ".join(f"{k} {v:.4f}" for k, v in total.items()), flush=True)
    if args.parent:
        time_tracker_against_parent(args.parent.resolve())
    return 0


if __name__ == "__main__":
    sys.exit(main())
