"""Where a kernel's time goes, without a profiler that can see inside it: build
text-patched copies of ``csrc/fps.cu`` and ``csrc/group.cu`` (a part skipped, a
constant changed), run each at the shapes of the main paths and time them in one
process on one card. The splits and the design choices in ``PERF.md`` come from
this script.

    python3 -m ptt_tpu_torch.variants [--parent DIR]

Run it from the root of the repo on a machine with the GPU and nvcc. ``--parent
DIR`` names a checkout of an earlier commit: its two kernels are then built and
timed beside this tree's, the forward also split into its ball query and its
gather and stores (patches that fit the first design's source). Every variant
that should still compute the function is held against the plain version; one
that skips a part is timed only. Copies and libraries go to ``build/variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from .ops import _build, fps, group, point_ops

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
# other forms for N = 1024 (warps x points a thread); csrc/fps.cu runs it in 8 x 4
EIGHT = ("  if (n <= 8 * 32 * kPts) return 8;\n", "    case 8: fps_kernel<8><<<batch, 256, 0, st>>>(xyz, out, n, npoint); break;\n")
# with more points a thread the 16-warp form outgrows static shared memory: those variants drop it
NO_SIXTEEN = [("  if (n <= 16 * 32 * kPts) return 16;\n", ""),
              ("    case 16: fps_kernel<16><<<batch, 512, 0, st>>>(xyz, out, n, npoint); break;\n", "")]
FPS_VARIANTS = {
    "2 warps x 16 points": [("constexpr int kPts = 4;", "constexpr int kPts = 16;"), (EIGHT[0], "  if (n <= 2 * 32 * kPts) return 2;\n"),
                            (EIGHT[1], "    case 2: fps_kernel<2><<<batch, 64, 0, st>>>(xyz, out, n, npoint); break;\n"), *NO_SIXTEEN],
    "4 warps x 8 points": [("constexpr int kPts = 4;", "constexpr int kPts = 8;"), (EIGHT[0], "  if (n <= 4 * 32 * kPts) return 4;\n"),
                           (EIGHT[1], "    case 4: fps_kernel<4><<<batch, 128, 0, st>>>(xyz, out, n, npoint); break;\n"), *NO_SIXTEEN],
    "16 warps x 2 points": [("constexpr int kPts = 4;", "constexpr int kPts = 2;"), (EIGHT[0], "")],
}
# the first design of the forward (a warp per center, the cloud scanned from device memory)
PARENT_GROUP_VARIANTS = {
    "ball query and idx only": [("  __syncthreads();\n\n  const float* zb = z +", "  __syncthreads();\n  return;\n\n  const float* zb = z +")],
    "no ball query (table read back)": [(
        "    ptt::warp_ball_query(xyz + static_cast<size_t>(b) * n * 3, n,\n"
        "                         ctr + (static_cast<size_t>(b) * m_total + m) * 3, r2, ns, row, lane);\n"
        "    for (int s = lane; s < ns; s += 32) idx[(static_cast<size_t>(b) * m_total + m) * ns + s] = row[s];",
        "    for (int s = lane; s < ns; s += 32) row[s] = idx[(static_cast<size_t>(b) * m_total + m) * ns + s];")],
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
        fn = getattr(ctypes.CDLL(str(lib)), jobs[name][2])
        fn.argtypes, fn.restype = jobs[name][3], ctypes.c_int
        fns[name] = fn
    return fns


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
    fps_jobs = {"this tree, 8 warps x 4 points": (CSRC / "fps.cu", CSRC, "fps_forward", FPS_ARGS)}
    for name, edits in FPS_VARIANTS.items():
        fps_jobs[name] = (patched(CSRC / "fps.cu", name, edits), CSRC, "fps_forward", FPS_ARGS)
    if args.parent:
        pc = args.parent.resolve() / "ptt_tpu_torch" / "csrc"
        jobs["parent"] = (pc / "group.cu", pc, "group_forward", FWD_ARGS, True)
        for name, edits in PARENT_GROUP_VARIANTS.items():
            jobs[f"parent, {name}"] = (patched(pc / "group.cu", "parent " + name, edits), pc, "group_forward", FWD_ARGS,
                                       "table read back" in name)
        fps_jobs["parent"] = (pc / "fps.cu", pc, "fps_forward", FPS_ARGS)
    fns = build_all({**jobs, **{"fps: " + k: v for k, v in fps_jobs.items()}})
    stream = torch.cuda.current_stream().cuda_stream

    # FPS at the four call shapes of the main paths
    gen = torch.Generator(device=dev).manual_seed(4)
    extent = torch.tensor([2.2, 1.0, 0.8], device=dev)
    for B, N, m in ((16, 1024, 512), (8, 128, 64), (2 * cs.TRAIN_B, 1024, 512), (cs.TRAIN_B, 128, 64)):
        xyz = (torch.rand((B, N, 3), device=dev, generator=gen) * 2 - 1) * extent
        ref = point_ops.furthest_point_sample(xyz, m)
        out = torch.empty((B, m), dtype=torch.int32, device=dev)
        line = [f"wrapper {cs.queued_ms(lambda: fps.furthest_point_sample(xyz, m), 20):.4f}"]
        for name in fps_jobs:
            if N <= 128 and name in FPS_VARIANTS:
                continue  # the variants change the form of N = 1024 only
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
    return 0


if __name__ == "__main__":
    sys.exit(main())
