"""Builds the CUDA kernels of ``ptt_tpu_torch/csrc`` at first use and loads them.

Each ``.cu`` file has a plain C interface and is compiled by its own ``nvcc``
into a shared library, all of them started together, then loaded with ctypes;
pointers and the stream are passed as integers. (No source includes PyTorch's
headers: a file that does takes minutes to compile, these take seconds.)

Libraries go to ``build/ptt_tpu_torch/`` beside the package, named by a hash of
source, the shared headers (``csrc/*.cuh``) and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ptt_tpu_torch"
SOURCES = ("fps", "sa", "group")
NVCC_FLAGS = [
    "-O3",
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
]

_p = ctypes.c_void_p
_i = ctypes.c_int
# entry point -> (source, ctypes argument types); every entry point returns int
_FUNCTIONS = {
    "fps_forward": ("fps", [_p, _p, _i, _i, _i, _p]),
    "fps_form": ("fps", [_i, ctypes.POINTER(_i), ctypes.POINTER(_i)]),
    "fps_probe": ("fps", [_p, _i, _i, _p]),
    "sa_forward": (
        "sa",
        [_p, _p, _p, _i, _p, _p, _i, ctypes.c_float, _i, _p, _p, _p, _i, ctypes.POINTER(_p), ctypes.POINTER(_p),
         ctypes.POINTER(_i), _p, _p, _i, _i, _i, _i, ctypes.c_float, _p],
    ),
    "sa_prep_floats": ("sa", [_i, ctypes.POINTER(_i)]),
    "sa_smem_bytes": ("sa", [_i, _i, _i, ctypes.POINTER(_i)]),
    "group_forward": ("group", [_p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, ctypes.c_float, _p]),
    "group_backward": ("group", [_p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p]),
    "group_backward_scratch": ("group", [_i, _i, _i, _i, ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(_i)]),
    "group_backward_order": ("group", [_i, ctypes.POINTER(_i), ctypes.POINTER(_i), ctypes.POINTER(_i)]),
    "group_csr_ranges": ("group", [_i, ctypes.POINTER(_i)]),
}

_loaded: dict = {}
build_log: dict = {}  # name -> (seconds, nvcc output) of the builds this process ran


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}; the CUDA kernels cannot be built")
    return str(nvcc)


def _target(name: str) -> Path:
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES) -> None:
    """Compile the named sources that have no current library, one nvcc each,
    all at once. Raises with nvcc's output if any build fails."""
    todo = [n for n in names if not _target(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    procs = {}
    for name in todo:
        tmp = _target(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = (time.perf_counter() - start, log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(name))  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))


def function(fn_name: str):
    """The C entry point ``fn_name`` of its ``csrc/*.cu`` library with its ctypes
    signature, building every source that needs it on the first call."""
    if fn_name not in _loaded:
        build()
        name, argtypes = _FUNCTIONS[fn_name]
        fn = getattr(ctypes.CDLL(str(_target(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[fn_name] = fn
    return _loaded[fn_name]


_NO_GUARD = contextlib.nullcontext()


def on_device(device):
    """(guard, stream) for a launch on the CUDA ``device``: a context that makes it
    the current device while the kernel is launched, and the handle of its
    current stream. Where it already is the current device, the usual case, the
    guard is the null context: switching devices and wrapping the stream in an
    object cost more host time than a small kernel runs."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    guard = _NO_GUARD if index == current else torch.cuda.device(index)
    return guard, torch._C._cuda_getCurrentRawStream(index)


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
