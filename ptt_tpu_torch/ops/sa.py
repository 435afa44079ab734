"""Fused eval-mode set-abstraction stage: the CUDA kernel ``csrc/sa.cu`` behind
the port of the JAX package's ``ops/pallas_sa.py``, with its plain PyTorch
version (``fused_sa_plain``) for tensors on the CPU.

The function: for each center, ball-query its ``nsample`` neighbours, group
[relative xyz (/ radius) | features], run the BatchNorm-folded MLP with a ReLU
after every layer, and take the max over the neighbourhood.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .point_ops import ball_query, query_and_group, radius_sq

# kernel launches made through fused_sa_inference (a run resets it to 0)
launches = 0

_MAX_TAIL = 4  # tail layers the kernel takes (csrc/sa.cu kMaxTail)
_MAX_NSAMPLE = 64  # rows per block (csrc/sa.cu kRows)


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


def fused_sa_inference(xyz, new_xyz, features, radius: float, nsample: int, weights, biases,
                       normalize_xyz: bool = True, use_xyz: bool = True, idx_out=None):
    """One eval-mode SA stage: (B, N, 3) points, (B, M, 3) centers, (B, N, C)
    features or None -> (B, M, C_out). The CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. ``idx_out``, a (B, M, nsample) int32 tensor,
    receives the neighbour table when given."""
    if xyz.device.type == "cpu":
        if idx_out is not None:
            idx_out.copy_(ball_query(radius, nsample, xyz, new_xyz))
        return fused_sa_plain(xyz, new_xyz, features, radius, nsample, weights, biases,
                              normalize_xyz=normalize_xyz, use_xyz=use_xyz)
    z, off = _first_layer(xyz, new_xyz, features, radius, weights[0], biases[0],
                          normalize_xyz, use_xyz)
    return _launch(xyz, new_xyz, z, off, weights[1:], biases[1:], radius, nsample, idx_out)


def _first_layer(xyz, new_xyz, features, radius, w1, b1, normalize_xyz, use_xyz):
    """Layer 0 commuted ahead of the gather (pallas_sa.py:204-225): Z over the
    source points and the per-center offset O, so that layer 0 of neighbour j
    of center m is relu(Z[j] + O[m]). Full float32 matmuls (TF32 is off)."""
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


def _launch(xyz, new_xyz, z, off, tail_w, tail_b, radius, nsample, idx_out):
    global launches
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz), ("z", z), ("off", off)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"fused_sa_inference: {name} must be a contiguous float32 CUDA tensor")
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    H1 = z.shape[-1]
    if xyz.shape[-1] != 3 or new_xyz.shape != (B, M, 3) or z.shape != (B, N, H1) or off.shape != (B, M, H1):
        raise ValueError("fused_sa_inference: inconsistent shapes")
    if not 1 <= nsample <= _MAX_NSAMPLE or len(tail_w) > _MAX_TAIL:
        raise ValueError(f"fused_sa_inference: nsample <= {_MAX_NSAMPLE} and <= {_MAX_TAIL} tail layers")
    widths = [H1]
    ws, bs = [], []
    for w, b in zip(tail_w, tail_b):
        w = w.float().contiguous()
        b = b.float().contiguous()
        if w.shape[0] != widths[-1] or b.shape != (w.shape[1],):
            raise ValueError("fused_sa_inference: tail layer widths do not chain")
        widths.append(w.shape[1])
        ws.append(w)
        bs.append(b)
    C_out = widths[-1]
    out = torch.empty((B, M, C_out), dtype=torch.float32, device=xyz.device)
    if idx_out is not None and (idx_out.shape != (B, M, nsample) or idx_out.dtype != torch.int32
                                or idx_out.device != xyz.device or not idx_out.is_contiguous()):
        raise ValueError("fused_sa_inference: idx_out must be a contiguous (B, M, nsample) int32 tensor")
    n_tail = len(ws)
    w_ptrs = (ctypes.c_void_p * max(n_tail, 1))(*[w.data_ptr() for w in ws])
    b_ptrs = (ctypes.c_void_p * max(n_tail, 1))(*[b.data_ptr() for b in bs])
    c_widths = (ctypes.c_int * len(widths))(*widths)
    fn = _build.library("sa")
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xyz.data_ptr(), new_xyz.data_ptr(), z.data_ptr(), off.data_ptr(), n_tail,
                 w_ptrs, b_ptrs, c_widths, out.data_ptr(),
                 idx_out.data_ptr() if idx_out is not None else None,
                 B, N, M, nsample, radius_sq(radius), stream)
    _build.check_launch(err, "sa")
    launches += 1
    return out
