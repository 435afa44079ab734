"""Float32 linear layers of the eval forward on the tensor cores: the CUDA
kernels of ``csrc/tf32x3.cu`` behind ``linear_tf32x3``, with their plain
PyTorch version (``linear_tf32x3_plain``) for tensors on the CPU.

The function, over the last axis of ``x``: ``relu?((x @ weight.T) * scale +
shift)``, where per output column ``scale`` and ``shift`` are 1 and the bias
(0 without one) of a Linear, or eval BatchNorm's gamma / sqrt(var + eps) and
beta - mean * scale. The product is ``ops/sa.py``'s three-pass TF32 split
(``matmul_3xtf32``): float32 accuracy on the tensor cores.

The kernel replaces no TPU kernel: the JAX package leaves these products to
XLA. Its bound is the three passes' operations at 165 TFLOP/s (a third of
dense TF32's 495); the 65536 x 256 x 256 products of the similarity MLP sit
near the bytes ridge (64 operations a byte against the card's 49), the
512-wide ones above it (128). What the design does about that:
``csrc/tf32x3.cu``.

``takes_kernel`` is the route ``nn/layers.py`` asks, a function of what a call
can observe: CUDA, float32, no autograd, K and N on the kernel's tiles, and M
at or above ``min_rows(N)``, the crossover against cuBLAS's float32 GEMM
measured on the card (``chip_smoke.py`` phase 23). Each launch counts one
``launches.tf32x3`` and one ``launches.tf32x3.<M>x<K>x<N>`` of its shape (a
CUDA graph's replay adds its capture's), so that a reader can price each
shape's product.
"""

from __future__ import annotations

import torch

from ..utils import timer
from . import _build
from .sa import matmul_3xtf32

K_STEP = 32  # K of a stage (csrc/tf32x3.cu kBK)
N_STEP = 128  # columns of an output tile (kBN)
# The crossover: at 64 output tiles of 128 x 128 (M x N = 2^20) and above the
# kernel is the faster (H100: 2048 x 512 x 512 in 0.0230 ms against the
# library layer's 0.0314, 4096 x 256 x 256 in 0.0149 against 0.0185), at 32
# the slower (1024 x 512 x 512: 0.0227 against 0.0197; 2048 x 256 x 256:
# 0.0149 against 0.0116): below a wave the kernel's time is one tile's chain
# of K-steps, cuBLAS's shrinks with M.
MIN_OUTPUTS = 64 * N_STEP * N_STEP


def min_rows(n: int) -> int:
    """The least M that goes to the kernel for N = ``n`` outputs."""
    return -(-MIN_OUTPUTS // n)


def takes_kernel(m: int, k: int, n: int, dtype, device, grad_enabled: bool) -> bool:
    """Whether a linear layer of ``m`` rows, ``k`` inputs and ``n`` outputs in
    ``dtype`` on ``device`` goes to the kernel: a float32 CUDA call without
    autograd (the kernel has no backward) whose K and N fit its tiles and whose
    M reaches the crossover, ``min_rows(n)``."""
    return (torch.device(device).type == "cuda" and dtype == torch.float32 and not grad_enabled
            and k % K_STEP == 0 and n % N_STEP == 0 and n > 0 and m >= min_rows(n))


def check_kernel_shapes(m: int, k: int, n: int) -> None:
    """Raises ValueError unless ``csrc/tf32x3.cu`` takes a product of ``m``
    rows, ``k`` inputs and ``n`` outputs: K a positive multiple of 32, N of
    128, M at least 1."""
    if m < 1 or k < K_STEP or k % K_STEP or n < N_STEP or n % N_STEP:
        raise ValueError(f"linear_tf32x3: the kernel takes M >= 1, K a multiple of {K_STEP} and N a multiple of "
                         f"{N_STEP}, got M = {m}, K = {k}, N = {n}")


def affine(n: int, bias=None, bn=None, device=None):
    """(scale, shift) of the epilogue, (n,) float32 each: 1 and ``bias`` (or 0),
    or from ``bn`` = (gamma, beta, running_mean, running_var, eps). The plain
    version of ``tf32x3_split_kernel``'s last step."""
    if bn is not None:
        gamma, beta, mean, var, eps = bn
        scale = gamma / torch.sqrt(var + eps)
        return scale, beta - mean * scale
    ones = torch.ones(n, dtype=torch.float32, device=device)
    return ones, (bias if bias is not None else torch.zeros(n, dtype=torch.float32, device=device))


def linear_tf32x3_plain(x, weight, bias=None, bn=None, relu: bool = False):
    """The plain version: the split product (``matmul_3xtf32``), then ``* scale
    + shift`` and the ReLU, in float32."""
    scale, shift = affine(weight.shape[0], bias, bn, x.device)
    y = matmul_3xtf32(x, weight.t()) * scale + shift
    return torch.relu(y) if relu else y


def linear_tf32x3(x, weight, bias=None, bn=None, relu: bool = False):
    """``relu?((x @ weight.T) * scale + shift)`` for ``x`` (..., K) and a
    torch.nn.Linear ``weight`` (N, K): with ``bias`` (N,), or ``bn`` =
    (gamma, beta, running_mean, running_var, eps) of an eval BatchNorm, or
    neither. The CUDA kernel for CUDA tensors (float32 and contiguous, or it
    raises), the plain version for CPU tensors."""
    if x.device.type == "cpu":
        return linear_tf32x3_plain(x, weight, bias, bn, relu)
    if bias is not None and bn is not None:
        raise ValueError("linear_tf32x3: a bias or a BatchNorm, not both")
    vectors = [("bias", bias)] if bn is None else list(zip(("bn weight", "bn bias", "bn mean", "bn var"), bn[:4]))
    tensors = [("x", x), ("weight", weight)] + [(name, t) for name, t in vectors if t is not None]
    for name, t in tensors:
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"linear_tf32x3: {name} must be a contiguous float32 tensor on {x.device}")
    n, k = weight.shape
    m = x.numel() // k if k else 0
    if x.shape[-1] != k or any(t.shape != (n,) for _, t in tensors[2:]):
        raise ValueError(f"linear_tf32x3: inconsistent shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}")
    check_kernel_shapes(m, k, n)
    out = torch.empty((*x.shape[:-1], n), dtype=torch.float32, device=x.device)
    wprep = torch.empty((_build.function("tf32x3_prep_floats")(k, n),), dtype=torch.float32, device=x.device)
    scale_shift = torch.empty((2 * n,), dtype=torch.float32, device=x.device)
    bn_ptrs = [t.data_ptr() for t in bn[:4]] if bn is not None else [None] * 4
    fn = _build.function("tf32x3_linear")
    guard, stream = _build.on_device(x.device)
    with guard:
        err = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr() if bias is not None else None, *bn_ptrs,
                 float(bn[4]) if bn is not None else 0.0, wprep.data_ptr(), scale_shift.data_ptr(), out.data_ptr(),
                 m, k, n, int(relu), stream)
    _build.check_launch(err, "tf32x3")
    timer.count("launches.tf32x3")
    timer.count(f"launches.tf32x3.{m}x{k}x{n}")
    return out
