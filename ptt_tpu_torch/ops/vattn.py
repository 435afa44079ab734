"""The transformer blocks' eval-mode kNN vector attention around ``fc_gamma``:
the CUDA kernels of ``csrc/vattn.cu`` behind ``vector_attention``, with their
plain PyTorch versions (``vattn_in_plain``, ``vattn_out_plain``) for tensors
on the CPU.

The function, for queries (B, N) with neighbours ``idx`` (B, N, k) among the
(B, N_ref) points of the projections, channels-last:

- ``vattn_in``: A[b, n, j] = (q[b, n] - kproj[b, idx[b, n, j]]) + pos[b, n, j],
  the input of ``fc_gamma``, (B, N, k, d) contiguous;
- ``fc_gamma`` (the caller's, row-wise over the last axis): logits = fc_gamma(A);
- ``vattn_out``: res[b, n, c] = sum_j softmax_j(logits[b, n, j, c] /
  sqrt(scale)) (vproj[b, idx[b, n, j], c] + pos[b, n, j, c]), (B, N, d).

That is ``nn/transformer.py``'s ``q[:, :, None] - k + pos_enc`` and
``_attend(fc_gamma(...), v + pos_enc, scale)`` with ``k`` and ``v`` the
gathered projections. A multi-head layer's heads are contiguous runs of
channels: its ``fc_gamma`` reads A's rows as (B, N, k, H, head_dim), which is
the same memory, and each channel's softmax is its own, so the heads enter
only through ``scale`` (head_dim) and ``res`` comes out in (B, N, H * head_dim)
order, which the layer's ``proj`` reads as it is.

The kernels replace no TPU kernel; why they were added, what bounds them and
their design: ``csrc/vattn.cu``.

``takes_kernel`` is the route the blocks ask, a function of what a call can
observe (module docstring of ``nn/transformer.py``). Each ``vector_attention``
call on the card counts one ``launches.vattn`` and one
``launches.vattn.<Q>x<k>x<d>`` of its shape (Q = B * N queries; a CUDA graph's
replay adds its capture's), so that a reader can price each shape's bytes; a
CUDA float32 eval-mode call the route refuses counts ``vattn.plain``.
"""

from __future__ import annotations

import math

import torch

from ..utils import timer
from . import _build
from .point_ops import group_points

MAX_K = 16  # neighbours a query: vattn_out_kernel keeps each one's logits in registers


def takes_kernel(block, q, kproj, vproj, idx, pos) -> bool:
    """Whether ``block``'s vector attention on these operands (as
    ``vector_attention``'s) goes to the kernels: CUDA float32 tensors in eval
    mode without autograd (the kernels have no backward), all contiguous, at
    most ``MAX_K`` neighbours, a width that is a multiple of 4 (16-byte
    columns) and the block's kernels on (``nn.set_use_kernels``). Under a
    point group (``ops/mesh_ctx.py``) only the kNN search splits and the
    block runs whole on every rank, so it takes the kernels there too, and a
    point group's result stays the one process's. Counts ``vattn.plain`` for a
    CUDA float32 eval-mode call that it refuses."""
    floats = (q, kproj, vproj, pos)
    if q.device.type != "cuda" or any(t.dtype != torch.float32 for t in floats) or block.training:
        return False
    k, d = idx.shape[-1], q.shape[-1]
    if (block.use_kernels and not torch.is_grad_enabled() and all(t.is_contiguous() for t in (*floats, idx))
            and 0 < k <= MAX_K and d > 0 and d % 4 == 0):
        return True
    timer.count("vattn.plain")
    return False


# ---------------------------------------------------------------- plain versions


def vattn_in_plain(q, kproj, idx, pos):
    """A = (q - kproj at idx) + pos, the blocks' order: (B, N, d), (B, N_ref, d),
    (B, N, k), (B, N, k, d) -> (B, N, k, d)."""
    return q[:, :, None] - group_points(kproj, idx) + pos


def vattn_out_plain(logits, vproj, idx, pos, scale: int, want_attn: bool = False):
    """(res (B, N, d), attn (B, N, k, d) or None): the softmax of ``logits /
    sqrt(scale)`` over the neighbours and the weighted sum of ``vproj`` at
    ``idx`` plus ``pos``, as ``nn/transformer.py`` ``_attend``. (On the CPU
    PyTorch divides by the scalar; on the card it multiplies by its float32
    reciprocal, as the kernel does.)"""
    attn = torch.softmax(logits.float() / math.sqrt(scale), dim=-2)
    res = (attn * (group_points(vproj, idx) + pos)).sum(dim=-2)
    return res, (attn if want_attn else None)


# ---------------------------------------------------------------- the kernels


def _check(what: str, idx, proj, **tensors) -> tuple:
    """(B, N, N_ref, k, d) of a call, or ValueError: ``idx`` (B, N, k) int32,
    ``proj`` (B, N_ref, d) and ``tensors`` (``q`` (B, N, d), ``logits`` or
    ``pos`` (B, N, k, d)) float32, all contiguous on ``idx``'s device."""
    if idx.dtype != torch.int32 or not idx.is_contiguous() or idx.dim() != 3 or proj.dim() != 3:
        raise ValueError(f"{what}: idx must be a contiguous (B, N, k) int32 tensor and the projection (B, N_ref, d)")
    (B, N, k), (n_ref, d) = idx.shape, proj.shape[1:]
    shapes = {"proj": (B, n_ref, d), "q": (B, N, d), "logits": (B, N, k, d), "pos": (B, N, k, d)}
    for name, t in {"proj": proj, **tensors}.items():
        if t.device != idx.device or t.dtype != torch.float32 or not t.is_contiguous() or t.shape != shapes[name]:
            raise ValueError(f"{what}: {name} must be a contiguous float32 tensor of shape {shapes[name]} on "
                             f"{idx.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if not (0 < k <= MAX_K and d > 0 and d % 4 == 0 and N > 0 and n_ref > 0):
        raise ValueError(f"{what}: the kernel takes 1 to {MAX_K} neighbours and a width that is a multiple of 4, "
                         f"got k = {k}, d = {d}")
    return B, N, n_ref, k, d


def vattn_in(q, kproj, idx, pos):
    """``vattn_in_plain``'s A: the CUDA kernel for CUDA tensors (float32, idx
    int32, all contiguous, or it raises), the plain version for CPU tensors."""
    if q.device.type == "cpu":
        return vattn_in_plain(q, kproj, idx, pos)
    B, N, n_ref, k, d = _check("vattn_in", idx, kproj, q=q, pos=pos)
    out = torch.empty_like(pos)
    fn = _build.function("vattn_in")
    guard, stream = _build.on_device(q.device)
    with guard:
        err = fn(q.data_ptr(), kproj.data_ptr(), idx.data_ptr(), pos.data_ptr(), out.data_ptr(), B, N, n_ref, k, d,
                 stream)
    _build.check_launch(err, "vattn_in")
    return out


def vattn_out(logits, vproj, idx, pos, scale: int, want_attn: bool = False):
    """``vattn_out_plain``'s (res, attn or None): the CUDA kernel for CUDA
    tensors (as ``vattn_in``), the plain version for CPU tensors. ``attn`` is
    written only when asked for."""
    if logits.device.type == "cpu":
        return vattn_out_plain(logits, vproj, idx, pos, scale, want_attn)
    B, N, n_ref, k, d = _check("vattn_out", idx, vproj, logits=logits, pos=pos)
    res = torch.empty((B, N, d), dtype=torch.float32, device=logits.device)
    attn = torch.empty_like(pos) if want_attn else None
    fn = _build.function("vattn_out")
    guard, stream = _build.on_device(logits.device)
    with guard:
        err = fn(logits.data_ptr(), vproj.data_ptr(), idx.data_ptr(), pos.data_ptr(), res.data_ptr(),
                 attn.data_ptr() if want_attn else None, B, N, n_ref, k, d, math.sqrt(scale), stream)
    _build.check_launch(err, "vattn_out")
    return res, attn


def vector_attention(q, kproj, vproj, idx, pos, gamma, scale: int):
    """res (B, N, d) of a block's vector attention: ``vattn_in``, the
    caller's ``gamma`` (its ``fc_gamma``, (B, N, k, d) -> (B, N, k, d)), then
    ``vattn_out`` without attn. On the card it counts one ``launches.vattn``
    and its shape counter."""
    res, _ = vattn_out(gamma(vattn_in(q, kproj, idx, pos)), vproj, idx, pos, scale)
    if q.device.type == "cuda":
        B, N, k = idx.shape
        timer.count("launches.vattn")
        timer.count(f"launches.vattn.{B * N}x{k}x{q.shape[-1]}")
    return res
