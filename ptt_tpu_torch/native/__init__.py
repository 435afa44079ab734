"""The native C++ host library (``ptt_native.cpp``), loaded with ctypes: the JAX
package's ``native`` with the same functions and signatures.

CPU oracles of pointnet2's sampling and grouping (``fps``, ``fps_with_dist``,
``ball_query`` with first-hit padding), the host evaluator's canonical crop
(``crop_canonical``), the box decode (``decode_box_offset``) and the device
evaluator's scorer (``box_iou3d_batch``, the reference metric's 3D IoU and
center distance in float32).

The library is built with ``g++`` at first use into the kernels' build
directory (``ops/_build.py``, ``build/ptt_tpu_torch/`` by default), named by
a hash of the source, the flags and the CPU that ``-march=native`` resolves
to, so that a library built on another machine is never loaded. Each build
writes a file of its own and renames it into place, so processes that build
at once all load a whole library. A failed build raises with g++'s output:
there is no numpy fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..ops import _build
from ..utils import timer

_SRC = Path(__file__).resolve().parent / "ptt_native.cpp"
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i = ctypes.c_int
_SIGNATURES = {
    "fps": ([_f32p, _i, _i, _i32p], None),
    "fps_with_dist": ([_f32p, _i, _i, _i32p], None),
    "ball_query": ([_f32p, _i, _f32p, _i, ctypes.c_float, _i, _i32p], None),
    "crop_canonical": ([_f32p, _i, _f32p, _f32p, ctypes.c_float, ctypes.c_float, _f32p, _i32p], ctypes.c_int),
    "compact_masked": ([_f32p, _i32p, _i, _f32p], None),
    "decode_box_offset": ([_f32p, _f32p, _i, _f32p], None),
    "box_iou3d_batch": ([_f32p, _f32p, _i, _i, _f32p, _f32p], None),
}


def _target_cpu() -> str:
    """The options ``-march=native`` expands to on this machine."""
    out = subprocess.run(["g++", "-march=native", "-###", "-x", "c++", "-c", os.devnull, "-o", os.devnull],
                         capture_output=True, text=True, timeout=60)
    words = (word.strip('"') for line in out.stderr.splitlines() if "cc1plus" in line for word in line.split())
    return " ".join(word for word in words if word.startswith("-m"))


def library_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    h.update(_target_cpu().encode())
    return _build.BUILD_DIR / f"libptt_native-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is there; returns its path. Raises with
    g++'s output if the build fails."""
    target = library_path()
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    out = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True)
    timer.count("kernels.builds")
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC.name}:\n{out.stdout}{out.stderr}")
    os.replace(tmp, target)  # atomic: a reader never sees half a library
    return target


def _load():
    lib = _build._loaded.get("native")
    if lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = restype
        _build._loaded["native"] = lib
    return lib


# each array passed by pointer is held by a name until its call returns
def _f32(a):
    a = np.ascontiguousarray(a, np.float32)
    return a, a.ctypes.data_as(_f32p)


def _i32(a):
    a = np.ascontiguousarray(a, np.int32)
    return a, a.ctypes.data_as(_i32p)


def fps(xyz: np.ndarray, npoint: int) -> np.ndarray:
    """(N, 3) or (B, N, 3) -> (npoint,) / (B, npoint) int32, pointnet2-exact."""
    lib = _load()
    if xyz.ndim == 3:
        return np.stack([fps(x, npoint) for x in xyz])
    xyz, xp = _f32(xyz)
    out, op = _i32(np.empty(npoint, np.int32))
    lib.fps(xp, xyz.shape[0], npoint, op)
    return out


def fps_with_dist(d2: np.ndarray, npoint: int) -> np.ndarray:
    """FPS on an (N, N) or (B, N, N) squared-distance matrix ('ffps')."""
    lib = _load()
    if d2.ndim == 3:
        return np.stack([fps_with_dist(x, npoint) for x in d2])
    d2, dp = _f32(d2)
    out, op = _i32(np.empty(npoint, np.int32))
    lib.fps_with_dist(dp, d2.shape[0], npoint, op)
    return out


def ball_query(xyz: np.ndarray, centers: np.ndarray, radius: float, nsample: int) -> np.ndarray:
    """(N, 3) x (M, 3) -> (M, nsample) int32 with first-hit duplicate padding."""
    lib = _load()
    if xyz.ndim == 3:
        return np.stack([ball_query(x, c, radius, nsample) for x, c in zip(xyz, centers)])
    xyz, xp = _f32(xyz)
    centers, cp = _f32(centers)
    out, op = _i32(np.empty((centers.shape[0], nsample), np.int32))
    lib.ball_query(xp, xyz.shape[0], cp, centers.shape[0], radius, nsample, op)
    return out


def crop_canonical(pts: np.ndarray, box_vec, wlh, offset: float, scale: float):
    """Returns (canonical_pts (K, 3) compacted, mask (N,) bool)."""
    lib = _load()
    pts, pp = _f32(pts)
    box, bp = _f32(np.asarray(box_vec))
    wlh, wp = _f32(np.asarray(wlh))
    out_pts, opp = _f32(np.empty_like(pts))
    mask, mp = _i32(np.empty(pts.shape[0], np.int32))
    kept = lib.crop_canonical(pp, pts.shape[0], bp, wp, offset, scale, opp, mp)
    compact, cp2 = _f32(np.empty((kept, 3), np.float32))
    lib.compact_masked(opp, mp, pts.shape[0], cp2)
    return compact, mask.astype(bool)


def box_iou3d_batch(boxes_a: np.ndarray, boxes_b: np.ndarray, z_axis: bool = False):
    """Batched reference-metric 3D IoU and center distance in float32.

    boxes (F, 7) = [cx, cy, cz, w, l, h, yaw] in lidar coords. Returns
    (iou (F,), dist (F,)). Reproduces eval_tracking_metrics.estimateOverlap /
    estimateAccuracy including the identical-box shortcut and (by default) the
    vertical-extent quirk; pass z_axis=True for the z-correct variant.
    """
    lib = _load()
    boxes_a, ap = _f32(boxes_a)
    boxes_b, bp = _f32(boxes_b)
    n = boxes_a.shape[0]
    iou, ip = _f32(np.empty(n, np.float32))
    dist, dp = _f32(np.empty(n, np.float32))
    lib.box_iou3d_batch(ap, bp, n, int(z_axis), ip, dp)
    return iou, dist


def decode_box_offset(box_vec, offset4, use_z: bool) -> np.ndarray:
    """[x, y, z, yaw] box and a canonical-frame offset -> the decoded [x, y, z, yaw]."""
    lib = _load()
    box, bp = _f32(np.asarray(box_vec))
    off, fp = _f32(np.asarray(offset4))
    out, op = _f32(np.empty(4, np.float32))
    lib.decode_box_offset(bp, fp, int(use_z), op)
    return out
