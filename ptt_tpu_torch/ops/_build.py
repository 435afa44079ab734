"""Builds the CUDA kernels of ``ptt_tpu_torch/csrc`` at first use and loads them.

Each ``.cu`` file has a plain C interface and is compiled by its own ``nvcc``
into a shared library, all of them started together, then loaded with ctypes;
pointers and the stream are passed as integers. (No source includes PyTorch's
headers: a file that does takes minutes to compile, these take seconds.)

Libraries go to ``build/ptt_tpu_torch/`` beside the package, named by a hash of
source and flags, so an edited source is rebuilt and an unchanged one is
loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ptt_tpu_torch"
SOURCES = ("fps", "sa")
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
_ARGTYPES = {
    "fps": ("fps_forward", [_p, _p, _i, _i, _i, _p]),
    "sa": (
        "sa_forward",
        [_p, _p, _p, _p, _i, ctypes.POINTER(_p), ctypes.POINTER(_p), ctypes.POINTER(_i),
         _p, _p, _i, _i, _i, _i, ctypes.c_float, _p],
    ),
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


def library(name: str):
    """The kernel entry point of ``csrc/<name>.cu`` with its ctypes signature,
    building every source that needs it on the first call."""
    if name not in _loaded:
        build()
        fn_name, argtypes = _ARGTYPES[name]
        fn = getattr(ctypes.CDLL(str(_target(name))), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return _loaded[name]


def check_launch(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
