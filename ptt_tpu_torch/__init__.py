"""PyTorch/CUDA port of the PTT Siamese LiDAR tracker for an NVIDIA H100.

The JAX package ``ptt_tpu`` beside this one is the reference; every module here
mirrors its counterpart's name and layout (``ops/``, ``nn/``, ``eval/``, ``core/``,
``data/``) and is held against it in ``tests/test_torch_port_*.py``. This package
imports torch and numpy only, never JAX or ``ptt_tpu``.

Precision: float32 matrix products and convolutions run in full float32 —
TF32 is switched off here, where the package is set up. TF32 keeps ~10
significand bits, and single-pass rounding of that size already flipped
ball-query and argmax selections once on the TPU (ROADMAP.md "Known traps").
"""

from __future__ import annotations

import os

import torch
import torch.distributed

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for the
    CPU. Raises when CUDA is asked for and no GPU is present.

    In a process group (``utils/dist.py``, one process per GPU) ``"cuda"``
    means ``cuda:{LOCAL_RANK}``, an explicit ``cuda:N`` is kept, and the device
    is made the current one, so that kernels are built and graphs captured
    there."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ptt_tpu_torch runs on a CUDA GPU and none is available; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    if device.type == "cuda" and torch.distributed.is_available() and torch.distributed.is_initialized():
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    return device


def __getattr__(name):
    if name == "__version__":  # on first use: git runs in a subprocess (version.py)
        from .version import version

        return version()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
