"""Grouped first linear layer of a training set-abstraction stage: the CUDA
kernels ``csrc/group.cu`` behind the port of the JAX package's
``ops/pallas_group.py``, with their plain PyTorch versions for tensors on the
CPU.

The function (``grouped_first_linear``): ball-query each center's ``nsample``
neighbours, group [relative xyz (/ radius) | features] and apply the bias-free
layer 0 of the stage's MLP, returning the pre-BatchNorm activations slot-major,
(B, nsample, M, H). Layer 0 commutes with the gather (``fold_inputs``), so the
forward kernel only gathers rows of Z and adds the per-center offset O, and the
backward kernel scatters the output gradient back onto Z's rows; every dense
product stays ``torch.matmul`` in full float32, as the JAX package leaves it to
XLA outside its kernels.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .point_ops import ball_query, group_points, query_and_group, radius_sq

# launches made through group_forward / group_backward (a run resets them to 0):
# one per call each; a backward call is three kernels (CSR build, chunk sums,
# combine of the few long segments), counted as one
fwd_launches = 0
bwd_launches = 0


def fold_inputs(xyz, new_xyz, features, w1, radius: float, normalize_xyz: bool = True,
                use_xyz: bool = True):
    """Z over the source points and the per-center offset O (pallas_group.py
    ``_fold_inputs``), so that layer 0 of neighbour j of center m is Z[j] + O[m].
    The xyz terms cancel down to the radius-scale offset and need full float32:
    TF32 is off in this package."""
    r = radius if normalize_xyz else 1.0
    if use_xyz:
        w1x = w1[:3] / r
        z = torch.matmul(xyz, w1x)
        if features is not None:
            z = z + torch.matmul(features, w1[3:])
        off = -torch.matmul(new_xyz, w1x)
    else:
        z = torch.matmul(features, w1)
        off = z.new_zeros((new_xyz.shape[0], new_xyz.shape[1], w1.shape[1]))
    return z.contiguous(), off.contiguous()


# ---------------------------------------------------------------- plain versions


def grouped_first_linear_plain(xyz, new_xyz, features, w1, radius: float, nsample: int,
                               normalize_xyz: bool = True, use_xyz: bool = True):
    """The composite: query_and_group -> x @ w1 -> slot-major (B, ns, M, H)."""
    grouped, _, _ = query_and_group(radius, nsample, xyz, new_xyz, features,
                                    use_xyz=use_xyz, normalize_xyz=normalize_xyz)
    return torch.matmul(grouped, w1).permute(0, 2, 1, 3)


def group_forward_plain(xyz, new_xyz, z, off, radius: float, nsample: int):
    """The forward kernel's function: (D (B, ns, M, H), idx (B, M, ns) int32)
    with D[b, s, m] = z[b, idx[b, m, s]] + off[b, m]."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    d = group_points(z, idx) + off[:, :, None, :]
    return d.permute(0, 2, 1, 3).contiguous(), idx


def group_backward_plain(dd, idx, n: int):
    """The backward kernel's function: dz (B, N, H), the sum of dd's rows
    (B, ns, M, H) onto the points idx (B, M, ns) names, by ``index_add_``."""
    B, ns, M, H = dd.shape
    rows = dd.permute(0, 2, 1, 3).reshape(B * M * ns, H)
    flat = (idx.long() + n * torch.arange(B, device=idx.device)[:, None, None]).reshape(-1)
    return dd.new_zeros((B * n, H)).index_add_(0, flat, rows).reshape(B, n, H)


# csrc/group.cu's forward: a block's shared memory, its tile of centers (a warp
# each), its threads, and the Z pieces a thread loads before it stores their sums
_MAX_SHARED_BYTES = 227 * 1024
FWD_TILE = 8
FWD_THREADS = 256
FWD_IN_FLIGHT = 4


def forward_shared_bytes(n: int, nsample: int) -> int:
    """Shared memory of one forward block: the tile's neighbour table, the ball
    query's hit lists and counts, and the cloud (csrc/group.cu ``fwd_smem_bytes``)."""
    return 4 * (2 * FWD_TILE * nsample + FWD_TILE + 3 * n)


def check_forward_shapes(n: int, nsample: int, h: int) -> None:
    """Raises ValueError unless ``csrc/group.cu``'s forward takes a cloud of ``n``
    points, ``nsample`` slots and rows of ``h`` floats: rows and the neighbour
    table move in 16-byte pieces (h and nsample multiples of 4), and the cloud
    lies in a block's shared memory beside the tile's tables. Every stage of
    ptt.yaml qualifies."""
    if n < 1 or nsample < 4 or nsample % 4:
        raise ValueError(f"grouped_first_linear: the forward kernel takes nsample in multiples of 4, got {nsample}")
    if h < 4 or h % 4:
        raise ValueError(f"grouped_first_linear: the forward kernel takes H in multiples of 4, got {h}")
    need = forward_shared_bytes(n, nsample)
    if need > _MAX_SHARED_BYTES:
        raise ValueError(f"grouped_first_linear: a cloud of N = {n} points with nsample = {nsample} needs {need} "
                         f"bytes of a block's shared memory, the card gives {_MAX_SHARED_BYTES}")


def group_forward_tiled(z, off, idx, tile: int = FWD_TILE, threads: int = FWD_THREADS,
                        in_flight: int = FWD_IN_FLIGHT):
    """``group_forward_plain``'s D built in the order the CUDA kernel writes it,
    from a given neighbour table: tile by tile of ``tile`` centers, within a tile
    the (center, 16-byte column) pairs dealt over the block's ``threads`` (where
    a tile has fewer pairs than that, the threads form groups that deal the
    slots out among them), each pair adding its O to ``in_flight`` gathered Z
    pieces at a time. Every element is one float32 addition, so the result
    equals the plain version's bit for bit whatever the order."""
    B, M, ns = idx.shape
    H = z.shape[-1]
    hv = H // 4
    out = z.new_empty((B, ns, M, H))
    zv, ov, dv = z.reshape(B, -1, hv, 4), off.reshape(B, M, hv, 4), out.view(B, ns, M, hv, 4)
    groups = threads // (tile * hv) if tile * hv < threads else 1
    step = tile * hv if groups > 1 else threads
    for b in range(B):
        for m0 in range(0, M, tile):
            valid = min(tile, M - m0)
            for e0 in range(0, valid * hv, step):  # one pass of the block over its pairs
                e = torch.arange(e0, min(e0 + step, valid * hv))
                t, col = e // hv, e % hv
                o = ov[b, m0 + t, col]
                for g in range(groups):
                    for s0 in range(g * in_flight, ns, groups * in_flight):
                        for s in range(s0, min(s0 + in_flight, ns)):
                            dv[b, s, m0 + t, col] = zv[b, idx[b, m0 + t, s].long(), col] + o
    return out


def check_kernel_width(h: int) -> None:
    """Raises ValueError unless ``csrc/group.cu``'s backward takes rows of ``h``
    floats: a multiple of 4 (16-byte columns), at least 64 (a row is half a
    warp or more). Every stage of ptt.yaml qualifies."""
    if h < 64 or h % 4:
        raise ValueError(f"grouped_first_linear: the backward kernel takes H >= 64 in multiples of 4, got {h}")


# csrc/group.cu's CSR build: a block's counters, one set per range of a batch
# row's entries, up to one range a warp of its 16
CSR_WARPS = 16


def csr_shared_bytes(n: int, ranges: int) -> int:
    """Shared memory of the backward's CSR build for a cloud of ``n`` points cut
    into ``ranges`` ranges (csrc/group.cu ``csr_smem_bytes``)."""
    return 4 * (ranges * n + 2 * (n + 1) + CSR_WARPS + 1)


def csr_ranges(n: int) -> int:
    """The ranges the CSR build takes for ``n`` points (``csr_ranges`` in
    csrc/group.cu): the most, up to 16, whose counters fit a block; 0 beyond
    ``BACKWARD_MAX_POINTS``."""
    ranges = CSR_WARPS
    while ranges and csr_shared_bytes(n, ranges) > _MAX_SHARED_BYTES:
        ranges //= 2
    return ranges


BACKWARD_MAX_POINTS = 19364  # the largest cloud whose CSR build fits one range


def check_backward_points(n: int) -> None:
    """Raises ValueError unless ``csrc/group.cu``'s backward takes a cloud of
    ``n`` points: its CSR build keeps a count of every point for at least one
    range of the entries in a block's shared memory."""
    if not 1 <= n <= BACKWARD_MAX_POINTS:
        raise ValueError(f"grouped_first_linear: the backward kernel takes N in [1, {BACKWARD_MAX_POINTS}] "
                         f"(its CSR build counts every point in shared memory), got {n}")


def kernel_csr_ranges(n: int) -> int:
    """``csr_ranges`` as the built library has it (builds it: only where nvcc is)."""
    ranges = ctypes.c_int(0)
    _build.function("group_csr_ranges")(n, ctypes.byref(ranges))
    return ranges.value


def documented_order(h: int):
    """(rows per chunk, ranges of a point's chunks, rows per warp-wide load) of
    the backward's summation order as ``csrc/group.cu``'s header note states it
    for rows of ``h`` floats. ``kernel_order`` asks the built library for the
    same three numbers."""
    check_kernel_width(h)
    return 32, 8, (2 if h == 64 else 1)


def kernel_order(h: int):
    """``documented_order`` as ``csrc/group.cu`` itself has it (builds the
    library: only where nvcc is)."""
    check_kernel_width(h)
    chunk, ranges, sub = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
    _build.function("group_backward_order")(h, ctypes.byref(chunk), ctypes.byref(ranges), ctypes.byref(sub))
    return chunk.value, ranges.value, sub.value


def group_backward_ordered(dd, idx, n: int, order=None):
    """``group_backward_plain`` summed in the order the CUDA kernel documents
    (csrc/group.cu), every addition written out, so that two runs give equal
    bits on any device: a point's rows in ascending e = m * ns + s, cut into
    chunks; within a chunk ``sub`` interleaved sub-sums (``sub`` rows fit one
    warp-wide load of 16-byte columns), added pairwise by halving; then the
    point's chunks in contiguous ranges of ceil(chunks / ranges), each range
    added in order, then the ranges' sums in order (a point with one chunk,
    almost every point, is that chunk's sum). ``order`` is (chunk, ranges, sub),
    ``documented_order`` when not given."""
    B, ns, M, H = dd.shape
    E = M * ns
    dev = dd.device
    chunk_rows, n_ranges, sub = documented_order(H) if order is None else order
    rows = dd.permute(0, 2, 1, 3).reshape(B * E, H)
    key = (idx.long() + n * torch.arange(B, device=dev)[:, None, None]).reshape(-1)
    by_point = torch.sort(key, stable=True).indices  # by (batch row, point), ascending e within
    skey = key[by_point]
    counts = torch.bincount(key, minlength=B * n)
    pos = torch.arange(B * E, device=dev) - (counts.cumsum(0) - counts)[skey]
    n_chunks = ((counts + chunk_rows - 1) // chunk_rows).clamp_min(1)  # a point without rows: one empty chunk
    first = n_chunks.cumsum(0) - n_chunks
    chunk = first[skey] + pos // chunk_rows
    t = pos % chunk_rows
    acc = dd.new_zeros((int(n_chunks.sum()), sub, H))
    for q in range(chunk_rows // sub):  # step q adds row q * sub + u to sub-sum u: one row per target
        sel = (t // sub) == q
        c, u = chunk[sel], (t % sub)[sel]
        acc[c, u] = acc[c, u] + rows[by_point[sel]]
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    partial = acc[:, 0]
    # a point's chunks in n_ranges contiguous ranges, each added in order from zero
    per = (n_chunks + n_ranges - 1) // n_ranges
    range_sum = dd.new_zeros((B * n, n_ranges, H))
    points = torch.arange(B * n, device=dev)
    for r in range(n_ranges):
        for p in range(int(per.max())):
            c = r * per + p
            sel = (p < per) & (c < n_chunks)
            if bool(sel.any()):
                range_sum[points[sel], r] = range_sum[points[sel], r] + partial[first[sel] + c[sel]]
    dz = range_sum[:, 0]
    for r in range(1, n_ranges):
        dz = dz + range_sum[:, r]
    return dz.reshape(B, n, H)


# ---------------------------------------------------------------------- wrappers


def group_forward(xyz, new_xyz, z, off, radius: float, nsample: int):
    """(B, N, 3) points, (B, M, 3) centers, Z (B, N, H), O (B, M, H) ->
    (D (B, nsample, M, H), idx (B, M, nsample) int32): the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xyz.device.type == "cpu":
        return group_forward_plain(xyz, new_xyz, z, off, radius, nsample)
    return _launch_fwd(xyz, new_xyz, z, off, radius, nsample)


def group_backward(dd, idx, n: int):
    """dD (B, ns, M, H), idx (B, M, ns) int32 -> dZ (B, n, H), summed in a fixed
    order: the CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if dd.device.type == "cpu":
        return group_backward_plain(dd, idx, n)
    return _launch_bwd(dd, idx, n)


def _check(name, t, dtype=torch.float32):
    if t.device.type != "cuda" or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"grouped_first_linear: {name} must be a contiguous {dtype} CUDA tensor, "
                         f"got {t.dtype} on {t.device}")


def _launch_fwd(xyz, new_xyz, z, off, radius, nsample):
    global fwd_launches
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz), ("z", z), ("off", off)):
        _check(name, t)
    B, N, _ = xyz.shape
    M = new_xyz.shape[1]
    H = z.shape[-1]
    if xyz.shape[-1] != 3 or new_xyz.shape != (B, M, 3) or z.shape != (B, N, H) or off.shape != (B, M, H):
        raise ValueError("grouped_first_linear: inconsistent shapes")
    check_forward_shapes(N, nsample, H)
    out = torch.empty((B, nsample, M, H), dtype=torch.float32, device=xyz.device)
    idx = torch.empty((B, M, nsample), dtype=torch.int32, device=xyz.device)
    fn = _build.function("group_forward")
    guard, stream = _build.on_device(xyz.device)
    with guard:
        err = fn(xyz.data_ptr(), new_xyz.data_ptr(), z.data_ptr(), off.data_ptr(), out.data_ptr(),
                 idx.data_ptr(), B, N, M, nsample, H, radius_sq(radius), stream)
    _build.check_launch(err, "group_forward")
    fwd_launches += 1
    return out, idx


@functools.lru_cache(maxsize=64)
def _bwd_scratch(B: int, n: int, M: int, ns: int, device_index: int):
    """(int32 words of tables, chunks per batch row) of the backward's scratch;
    its layout is csrc/group.cu's."""
    ints, max_chunks = ctypes.c_longlong(0), ctypes.c_int(0)
    err = _build.function("group_backward_scratch")(B, n, M, ns, ctypes.byref(ints), ctypes.byref(max_chunks))
    if err == -1:
        raise ValueError(f"grouped_first_linear: the backward's CSR build of N = {n} does not fit the device's "
                         "shared memory")
    if err != 0:
        raise RuntimeError("grouped_first_linear: cannot query the device's shared memory")
    return ints.value, max_chunks.value


def _launch_bwd(dd, idx, n):
    global bwd_launches
    _check("dD", dd)
    _check("idx", idx, torch.int32)
    B, ns, M, H = dd.shape
    if idx.shape != (B, M, ns):
        raise ValueError("grouped_first_linear: idx does not match dD")
    check_kernel_width(H)
    check_backward_points(n)
    dev = dd.device
    fn = _build.function("group_backward")
    guard, stream = _build.on_device(dev)
    with guard:
        ints, max_chunks = _bwd_scratch(B, n, M, ns, torch.cuda.current_device())
        dz = torch.empty((B, n, H), dtype=torch.float32, device=dev)
        scratch = torch.empty((ints,), dtype=torch.int32, device=dev)
        partial = torch.empty((B, max_chunks, H), dtype=torch.float32, device=dev)
        err = fn(dd.data_ptr(), idx.data_ptr(), scratch.data_ptr(), partial.data_ptr(), dz.data_ptr(),
                 B, n, M, ns, H, stream)
    _build.check_launch(err, "group_backward")
    bwd_launches += 1
    return dz


# ------------------------------------------------------------------- the function


class GroupedFirstLinear(torch.autograd.Function):
    """``grouped_first_linear`` with its backward (pallas_group.py
    ``_grouped_first_linear_bwd``): dZ from the backward kernel, then
    dO = sum over slots and the dense algebra for dxyz, dnew_xyz, dfeatures and
    dW1 in full float32."""

    @staticmethod
    def forward(ctx, xyz, new_xyz, features, w1, radius, nsample, normalize_xyz, use_xyz):
        z, off = fold_inputs(xyz, new_xyz, features, w1, radius, normalize_xyz, use_xyz)
        out, idx = group_forward(xyz, new_xyz, z, off, radius, nsample)
        ctx.save_for_backward(xyz, new_xyz, features, w1, idx)
        ctx.radius = radius if normalize_xyz else 1.0
        ctx.use_xyz = use_xyz
        return out

    @staticmethod
    def backward(ctx, dd):
        xyz, new_xyz, features, w1, idx = ctx.saved_tensors
        dz = group_backward(dd.contiguous(), idx, xyz.shape[1])
        dxyz = dnew_xyz = dfeats = None
        if ctx.use_xyz:
            do = dd.sum(dim=1)  # (B, M, H): every slot carries O once
            w1x = w1[:3] / ctx.radius
            dxyz = torch.matmul(dz, w1x.t())
            dnew_xyz = -torch.matmul(do, w1x.t())
            dw1 = (torch.matmul(xyz.reshape(-1, 3).t(), dz.reshape(-1, dz.shape[-1]))
                   - torch.matmul(new_xyz.reshape(-1, 3).t(), do.reshape(-1, do.shape[-1]))) / ctx.radius
            if features is not None:
                dfeats = torch.matmul(dz, w1[3:].t())
                dw1f = torch.matmul(features.reshape(-1, features.shape[-1]).t(), dz.reshape(-1, dz.shape[-1]))
                dw1 = torch.cat([dw1, dw1f], dim=0)
        else:
            dfeats = torch.matmul(dz, w1.t())
            dw1 = torch.matmul(features.reshape(-1, features.shape[-1]).t(), dz.reshape(-1, dz.shape[-1]))
        return dxyz, dnew_xyz, dfeats, dw1, None, None, None, None


def grouped_first_linear(xyz, new_xyz, features, w1, radius: float, nsample: int,
                         normalize_xyz: bool = True, use_xyz: bool = True):
    """Fused ball query + group + bias-free first linear layer.
    xyz (B, N, 3), new_xyz (B, M, 3), features (B, N, C) or None, w1 (C + 3, H)
    when ``use_xyz`` else (C, H), the (in, out) kernel of the stage MLP's layer 0
    -> (B, nsample, M, H) pre-BatchNorm activations, slot-major (pool over
    axis 1). Differentiable in xyz, new_xyz, features and w1. Inputs of another
    floating type (bf16 under mixed precision) are taken in float32, as the JAX
    function casts them: the output is float32 and each input's gradient comes
    back in that input's type."""
    def f32(t):
        return None if t is None else t.float()

    return GroupedFirstLinear.apply(f32(xyz), f32(new_xyz), f32(features), f32(w1), float(radius), int(nsample),
                                    bool(normalize_xyz), bool(use_xyz))
