"""Fused eval-mode set-abstraction stage: the CUDA kernels of ``csrc/sa.cu``
behind the port of the JAX package's ``ops/pallas_sa.py``, with their plain
PyTorch version (``fused_sa_plain``) for tensors on the CPU, and the plain
emulation of the kernel's tensor-core arithmetic (``fused_sa_split``).

The function: for each center, ball-query its ``nsample`` neighbours, group
[relative xyz (/ radius) | features], run the BatchNorm-folded MLP with a ReLU
after every layer, and take the max over the neighbourhood.

Under a point group (``ops/mesh_ctx.py``) the kernel runs on this rank's
slice of the centers against the whole cloud, and the slices are gathered.
The kernel's grid is split by center already and every center's row is
computed alone (its ball query, its layer-0 offset, its MLP rows, its max), so
the gathered rows equal the unsplit kernel's bit for bit; what the kernel
checks and plans (``check_kernel_shapes``, shared memory) depends on N and the
widths, not on M. The JAX package turns its Pallas kernel off under a point
mesh instead (``pallas_sa.py`` ``fused_enabled``) and runs the jnp stage,
whose ball query is the sharded one: that is what ``fused_sa_plain``, the CPU
path, does here.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import timer
from . import _build, mesh_ctx
from .point_ops import _point_group_for, ball_query, query_and_group, radius_sq

_MAX_TAIL = 4  # tail layers the kernel takes (csrc/sa.cu kMaxTail)
_NSAMPLES = (16, 32, 64)  # a center's rows are whole warps of the kernel's 16-row fragments
_WIDTH_STEP = 8  # the K of one wgmma
# csrc/sa.cu's shared memory, in floats: activation row pad, buffer alignment,
# the weight ring (2 slabs of 2 x 32 x 128), the columns of a pass, the limit
_ACT_PAD = 4
_BUF_ALIGN = 256
_RING = 2 * 2 * 32 * 128
_PASS_COLS = 128
_MAX_SMEM = 227 * 1024


def fold_bn(kernel_w, bn_scale, bn_bias, bn_mean, bn_var, eps: float = 1e-5):
    """Fold eval-mode BatchNorm into the preceding bias-free linear layer, with
    the kernel in (in, out) layout: y = BN(xW) = x (W*s) + (beta - mean*s),
    s = gamma / sqrt(var + eps)."""
    s = bn_scale * torch.rsqrt(bn_var + eps)
    return kernel_w * s[None, :], bn_bias - bn_mean * s


def fused_sa_plain(xyz, new_xyz, features, radius, nsample, weights, biases,
                   normalize_xyz=True, use_xyz=True):
    """The plain version: query_and_group, then relu(h @ W + b) per layer, then
    the max over the neighbourhood. weights[i] is (in, out); weights[0] has the
    3 relative-xyz rows first when ``use_xyz``."""
    h, _, _ = query_and_group(radius, nsample, xyz, new_xyz, features,
                              use_xyz=use_xyz, normalize_xyz=normalize_xyz)
    for w, b in zip(weights, biases):
        h = torch.relu(torch.matmul(h, w) + b)
    return h.amax(dim=2)


def split_tf32(x):
    """x = hi + lo as the kernel splits a float32 operand for the tensor cores:
    hi is x rounded to TF32's 11 significant bits (Veltkamp's splitting with
    2^13 + 1, exact float32 arithmetic, so these are the kernel's bits), lo is
    the exact remainder with its low 13 mantissa bits masked off."""
    c = x * 8193.0
    hi = c - (c - x)
    lo = ((x - hi).view(torch.int32) & -8192).view(torch.float32)
    return hi, lo


def matmul_tf32(a, w):
    """One TF32 pass: both operands rounded to TF32, float32 accumulation."""
    return torch.matmul(split_tf32(a)[0], split_tf32(w)[0])


def matmul_3xtf32(a, w):
    """The kernel's error-compensated product: a_lo w_hi + a_hi w_lo + a_hi w_hi,
    small terms first, float32 accumulation (a_lo w_lo, ~2^-22 of the product,
    is dropped)."""
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    return (torch.matmul(a_lo, w_hi) + torch.matmul(a_hi, w_lo)) + torch.matmul(a_hi, w_hi)


def fused_sa_split(xyz, new_xyz, features, radius, nsample, weights, biases,
                   normalize_xyz=True, use_xyz=True, matmul=matmul_3xtf32):
    """``fused_sa_plain`` with the kernel's arithmetic in the tail layers: layer
    0 in full float32, every later product through ``matmul``."""
    h, _, _ = query_and_group(radius, nsample, xyz, new_xyz, features,
                              use_xyz=use_xyz, normalize_xyz=normalize_xyz)
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.relu((torch.matmul(h, w) if i == 0 else matmul(h, w)) + b)
    return h.amax(dim=2)


def fused_sa_inference(xyz, new_xyz, features, radius: float, nsample: int, weights, biases,
                       normalize_xyz: bool = True, use_xyz: bool = True, idx_out=None):
    """One eval-mode SA stage: (B, N, 3) points, (B, M, 3) centers, (B, N, C)
    features or None -> (B, M, C_out). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``idx_out``, a (B, M, nsample) int32 tensor,
    receives the neighbour table when given.

    Under a point group the centers split (the CPU path through the split
    ``ball_query``, the kernel on this rank's centers); a stage of fewer than
    ``point_ops.MIN_SHARD_POINTS`` centers, or of a count the group does not
    divide, runs whole on every rank."""
    if xyz.device.type == "cpu":
        if idx_out is not None:
            idx_out.copy_(ball_query(radius, nsample, xyz, new_xyz))
        return fused_sa_plain(xyz, new_xyz, features, radius, nsample, weights, biases,
                              normalize_xyz=normalize_xyz, use_xyz=use_xyz)
    w1, b1 = weights[0].float().contiguous(), biases[0].float().contiguous()
    group = _point_group_for(new_xyz.shape[1])
    if group is None:
        return _launch(xyz, new_xyz, features, w1, b1, weights[1:], biases[1:], radius, nsample, normalize_xyz,
                       use_xyz, idx_out)[0]
    M = new_xyz.shape[1]
    rows = group.rows(M)
    local_idx = None if idx_out is None else torch.empty((xyz.shape[0], rows.stop - rows.start, nsample),
                                                         dtype=torch.int32, device=xyz.device)
    out = _launch(xyz, new_xyz[:, rows].contiguous(), features, w1, b1, weights[1:], biases[1:], radius, nsample,
                  normalize_xyz, use_xyz, local_idx)[0]
    timer.count(f"launches.sa_split.{M}")  # a launch on a slice of the centers, by the stage's whole M
    if idx_out is not None:
        idx_out.copy_(mesh_ctx.gather_rows(local_idx, group))
    return mesh_ctx.gather_rows(out, group)


def _first_layer(xyz, new_xyz, features, radius, w1, b1, normalize_xyz, use_xyz):
    """Layer 0 commuted ahead of the gather (pallas_sa.py:204-225): Z over the
    source points and the per-center offset O, so that layer 0 of neighbour j
    of center m is relu(Z[j] + O[m]). Full float32 matmuls (TF32 is off). The
    plain version of ``csrc/sa.cu``'s ``sa_pre_kernel``."""
    if use_xyz:
        w1x = w1[:3] / (radius if normalize_xyz else 1.0)
        z = torch.matmul(xyz, w1x)
        if features is not None:
            z = z + torch.matmul(features.float(), w1[3:])
        off = b1 - torch.matmul(new_xyz, w1x)
    else:
        z = torch.matmul(features.float(), w1)
        off = b1.expand(new_xyz.shape[0], new_xyz.shape[1], -1)
    return z.contiguous(), off.contiguous()


def smem_bytes(n: int, nsample: int, widths) -> int:
    """Shared memory of a 64-row ``csrc/sa.cu`` block, the smallest (its
    ``smem_bytes<1>``): the first activation buffer, sized for the block's
    rows or the cloud of ``n`` points, whichever is larger, a second one when
    a stored layer is wider than a pass, the weight ring, the warps' maxima,
    the neighbour table, and the ball query's hit lists. The wrapper asks the
    built library (``kernel_smem_bytes``); this copy serves the CPU, and
    chip_smoke.py holds the two equal on the card."""
    rows, warps = 64, 4
    width = max(widths[:-1])
    act = rows * (width + _ACT_PAD)
    buf0 = max(act, -(-3 * n // _BUF_ALIGN) * _BUF_ALIGN)
    two_bufs = any(c > _PASS_COLS for c in widths[1:-1])
    tm = rows // nsample
    lists = tm * (1 if tm >= warps else warps // tm)
    return 4 * (buf0 + (act if two_bufs else 0) + _RING + warps * _PASS_COLS + 2 * rows + lists * nsample)


def kernel_smem_bytes(n: int, nsample: int, widths) -> int:
    """``smem_bytes`` as the built ``csrc/sa.cu`` computes it (``sa_smem_bytes``)."""
    c_widths = (ctypes.c_int * len(widths))(*widths)
    return _build.function("sa_smem_bytes")(n, nsample, len(widths) - 1, c_widths)


def check_kernel_shapes(n: int, nsample: int, widths, block_bytes=smem_bytes) -> None:
    """Raises ValueError unless ``csrc/sa.cu`` takes a stage of ``n`` source
    points, ``nsample`` slots and layers of these output ``widths`` (layer 0
    first): nsample 16, 32 or 64, 1 to 4 tail layers, widths in multiples of 8,
    ``n`` a multiple of 4, and a 64-row block with its cloud within shared
    memory (N up to 13,652 at ns 32 and stored layers of 64 or 128), by
    ``block_bytes``. Every stage of ptt.yaml and ptt_large.yaml qualifies."""
    if nsample not in _NSAMPLES:
        raise ValueError(f"fused_sa_inference: the kernel takes nsample in {_NSAMPLES}, got {nsample}")
    if not 2 <= len(widths) <= _MAX_TAIL + 1:
        raise ValueError(f"fused_sa_inference: the kernel takes 2 to {_MAX_TAIL + 1} layers, got {len(widths)}")
    if any(c < _WIDTH_STEP or c % _WIDTH_STEP for c in widths):
        raise ValueError(f"fused_sa_inference: the kernel takes widths in multiples of {_WIDTH_STEP}, got {list(widths)}")
    if n % 4 or block_bytes(n, nsample, widths) > _MAX_SMEM:
        raise ValueError(f"fused_sa_inference: the kernel takes N in multiples of 4 whose 64-row block fits in "
                         f"{_MAX_SMEM} bytes of shared memory at these widths, got N = {n} "
                         f"({block_bytes(n, nsample, widths)} bytes)")


def _launch(xyz, new_xyz, features, w1, b1, tail_w, tail_b, radius, nsample, normalize_xyz, use_xyz,
            idx_out):
    """Returns (out, Z, O): the stage's output and layer 0 over the points and
    the centers as the kernels left it (``_first_layer`` is its plain version)."""
    tensors = [("xyz", xyz), ("new_xyz", new_xyz), ("weights[0]", w1), ("biases[0]", b1)]
    if features is not None:
        features = features.float().contiguous()
        tensors.append(("features", features))
    for name, t in tensors:
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_sa_inference: {name} must be a contiguous float32 CUDA tensor")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    c_feat = 0 if features is None else features.shape[-1]
    H1 = w1.shape[1]
    if (xyz.shape[-1] != 3 or new_xyz.shape != (B, M, 3) or (features is not None and features.shape[:2] != (B, N))
            or w1.shape[0] != (3 if use_xyz else 0) + c_feat or b1.shape != (H1,) or w1.shape[0] == 0):
        raise ValueError("fused_sa_inference: inconsistent shapes")
    widths = [H1]
    for w, b in zip(tail_w, tail_b):
        if w.shape[0] != widths[-1] or b.shape != (w.shape[1],):
            raise ValueError("fused_sa_inference: tail layer widths do not chain")
        widths.append(w.shape[1])
    check_kernel_shapes(N, nsample, widths, kernel_smem_bytes)
    ws = [w.float().contiguous() for w in tail_w]
    bs = [b.float().contiguous() for b in tail_b]
    z = torch.empty((B, N, H1), dtype=torch.float32, device=xyz.device)
    off = torch.empty((B, M, H1), dtype=torch.float32, device=xyz.device)
    out = torch.empty((B, M, widths[-1]), dtype=torch.float32, device=xyz.device)
    if idx_out is not None and (idx_out.shape != (B, M, nsample) or idx_out.dtype != torch.int32
                                or idx_out.device != xyz.device or not idx_out.is_contiguous()):
        raise ValueError("fused_sa_inference: idx_out must be a contiguous (B, M, nsample) int32 tensor")
    n_tail = len(ws)
    w_ptrs = (ctypes.c_void_p * n_tail)(*[w.data_ptr() for w in ws])
    b_ptrs = (ctypes.c_void_p * n_tail)(*[b.data_ptr() for b in bs])
    c_widths = (ctypes.c_int * len(widths))(*widths)
    # the tail weights split and laid out for the tensor cores; the layout is csrc/sa.cu's
    wprep = torch.empty((_build.function("sa_prep_floats")(n_tail, c_widths),),
                        dtype=torch.float32, device=xyz.device)
    fn = _build.function("sa_forward")
    guard, stream = _build.on_device(xyz.device)
    with guard:
        err = fn(xyz.data_ptr(), new_xyz.data_ptr(), features.data_ptr() if c_feat else None, c_feat,
                 w1.data_ptr(), b1.data_ptr(), H1, float(radius) if normalize_xyz else 1.0, int(use_xyz),
                 z.data_ptr(), off.data_ptr(), wprep.data_ptr(), n_tail, w_ptrs, b_ptrs, c_widths, out.data_ptr(),
                 idx_out.data_ptr() if idx_out is not None else None,
                 B, N, M, nsample, radius_sq(radius), stream)
    _build.check_launch(err, "sa")
    timer.count("launches.sa")
    return out, z, off
