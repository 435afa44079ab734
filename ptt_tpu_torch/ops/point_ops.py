"""Plain PyTorch point-cloud ops, channel-last like the JAX package's
``ops/point_ops.py``: clouds are (B, N, 3), features (B, N, C).

Every distance here is spelled out elementwise in one fixed order,
``((a0*b0 + a1*b1) + a2*b2)``, with each product and sum rounded on its own. A
matrix product would leave the order (and the use of fused multiply-adds) to
the library, and that differs between the CPU and the GPU; the fixed order
gives the same bits on both, and the same bits as the CUDA kernels in
``csrc/``, which use the ``__fmul_rn``/``__fadd_rn`` intrinsics. In-ball
membership and neighbour order then agree exactly between every path.

Point-axis sharding: under a point group (``ops/mesh_ctx.py``, the
POINT_SHARDING configurations) ``square_distance``, ``ball_query``, ``knn`` and
``three_nn`` split their query or center rows over the group's ranks and gather
the result: each row is computed against the full cloud by the same
elementwise arithmetic, so the result equals the unsplit one bit for bit. Each
has a ``_raw`` form that never splits, which the others call inside.
"""

from __future__ import annotations

import functools
import warnings

import torch

from . import mesh_ctx

# Rows fewer than this stay local under a point group: splitting a 128-seed
# kNN adds a gather for nothing (the JAX package's MIN_SHARD_POINTS).
MIN_SHARD_POINTS = 512

_declined_shapes: set = set()


def _point_group_for(rows: int):
    """The installed point group when it should split ``rows`` rows, else
    None. Rows that are enough but do not divide by the group's size run
    replicated, with a warning once per (rows, size)."""
    group = mesh_ctx.get_point_group()
    if group is None or rows < MIN_SHARD_POINTS:
        return None
    if rows % group.size:
        key = (rows, group.size)
        if key not in _declined_shapes:
            _declined_shapes.add(key)
            warnings.warn(f"point sharding declined: {rows} rows not divisible by the {group.size}-rank "
                          f"'{group.axis}' group; this op runs replicated; pad the configuration's point "
                          f"counts to a multiple of {group.size}", stacklevel=3)
        return None
    return group


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (x*x + y*y) + z*z."""
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def square_distance(src: torch.Tensor, dst: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """Pairwise squared distance in the matmul form |a|^2 + |b|^2 - 2ab, clamped
    at 0, in float32: (B, N, C) x (B, M, C) -> (B, N, M). For points (C = 3)
    every sum is spelled out in the fixed order above; wider rows (the 'ffps'
    feature space) use a float32 matrix product, as the JAX package does.
    ``exact``: the reference's elementwise ``sum((a - b) ** 2)`` instead, the
    channels summed left to right, ``((d0*d0 + d1*d1) + d2*d2)`` for points.
    Under a point group the ``src`` rows split (for C = 3 and the exact form
    bit-equal; a matrix product of fewer rows may take another kernel on the
    GPU)."""
    fn = functools.partial(_square_distance_raw, exact=exact)
    group = _point_group_for(src.shape[1])
    if group is not None:
        return mesh_ctx.shard_pointwise(fn, group, 1, 1)(src, dst)
    return fn(src, dst)


def _square_distance_raw(src: torch.Tensor, dst: torch.Tensor, exact: bool = False) -> torch.Tensor:
    src = src.float()
    dst = dst.float()
    if exact:
        d = src[:, :, None, :] - dst[:, None, :, :]
        d2 = d[..., 0] * d[..., 0]
        for c in range(1, d.shape[-1]):
            d2 = d2 + d[..., c] * d[..., c]
        return d2
    if src.shape[-1] != 3:
        cross = torch.matmul(src, dst.transpose(1, 2))
        d2 = ((src * src).sum(-1)[:, :, None] + (dst * dst).sum(-1)[:, None, :]) - 2.0 * cross
        return d2.clamp_min(0.0)
    a = src[:, :, None, :]
    b = dst[:, None, :, :]
    cross = (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]
    d2 = (_sq_norm(src)[:, :, None] + _sq_norm(dst)[:, None, :]) - 2.0 * cross
    return d2.clamp_min(0.0)


def _first_max(values: torch.Tensor) -> torch.Tensor:
    """(B, N) -> (B,) index of the first of equal maxima (torch.argmax does not
    promise the first)."""
    top = values.amax(dim=1, keepdim=True)
    lane = torch.arange(values.shape[1], device=values.device).expand_as(values)
    return torch.where(values == top, lane, values.shape[1]).amin(dim=1)


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy farthest point sampling: starts at index 0, then repeatedly takes
    the point whose distance to the chosen set is largest, ties to the lowest
    index. (B, N, 3) -> (B, npoint) int32."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    farthest = torch.zeros(B, dtype=torch.long, device=xyz.device)
    idxs = torch.zeros(B, npoint, dtype=torch.long, device=xyz.device)
    rows = torch.arange(B, device=xyz.device)
    for i in range(npoint):
        idxs[:, i] = farthest
        d = xyz - xyz[rows, farthest][:, None, :]
        d2 = _sq_norm(d)
        min_d2 = torch.minimum(min_d2, d2)
        farthest = _first_max(min_d2)
    return idxs.int()


def furthest_point_sample_with_dist(dist2: torch.Tensor, npoint: int) -> torch.Tensor:
    """Greedy farthest point sampling on a precomputed (B, N, N) squared-distance
    matrix ('ffps'), from index 0, ties to the lowest index. -> (B, npoint) int32."""
    dist2 = dist2.float()
    B, N, _ = dist2.shape
    min_d2 = torch.full((B, N), 1e10, dtype=torch.float32, device=dist2.device)
    farthest = torch.zeros(B, dtype=torch.long, device=dist2.device)
    idxs = torch.zeros(B, npoint, dtype=torch.long, device=dist2.device)
    rows = torch.arange(B, device=dist2.device)
    for i in range(npoint):
        idxs[:, i] = farthest
        min_d2 = torch.minimum(min_d2, dist2[rows, farthest])
        farthest = _first_max(min_d2)
    return idxs.int()


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M) -> (B, M, C)."""
    idx = idx.long()
    return torch.gather(points, 1, idx[..., None].expand(*idx.shape, points.shape[-1]))


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, M, ns) -> (B, M, ns, C)."""
    B, M, ns = idx.shape
    return gather_points(points, idx.reshape(B, M * ns)).reshape(B, M, ns, points.shape[-1])


@functools.lru_cache(maxsize=64)
def radius_sq(radius: float) -> float:
    """radius^2 rounded to float32, the threshold every in-ball test compares
    a float32 squared distance against."""
    return float(torch.tensor(radius * radius, dtype=torch.float32))


def ball_query(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    """For each center, the first ``nsample`` points with squared distance below
    float32(radius^2), in ascending index order. Short rows are padded with the
    first hit; a center with no hit takes point 0 in every slot.
    (B, N, 3) points, (B, M, 3) centers -> (B, M, nsample) int32. Under a point
    group the centers split."""
    group = _point_group_for(new_xyz.shape[1])
    if group is not None:
        fn = functools.partial(_ball_query_centers, radius, nsample)
        return mesh_ctx.shard_pointwise(fn, group, 1, 1)(new_xyz, xyz)
    return _ball_query_raw(radius, nsample, xyz, new_xyz)


def _ball_query_centers(radius, nsample, new_xyz, xyz):
    return _ball_query_raw(radius, nsample, xyz, new_xyz)


def _ball_query_raw(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> torch.Tensor:
    d2 = _square_distance_raw(new_xyz, xyz)  # (B, M, N)
    N = xyz.shape[1]
    order = torch.arange(N, device=xyz.device).expand_as(d2)
    # in-ball points keep their index as key, the others N + index: the k
    # smallest keys are the first k in-ball indices, in order
    key = torch.where(d2 < radius_sq(radius), order, order + N)
    k = min(nsample, N)
    key = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
    valid = key < N
    idx = torch.where(valid, key, key - N)
    first = idx[..., :1]
    idx = torch.where(valid, idx, first)
    if k < nsample:
        idx = torch.cat([idx, first.expand(*idx.shape[:-1], nsample - k)], dim=-1)
    return idx.int()


def uniform_resample_idx(idx: torch.Tensor, generator: torch.Generator | None = None):
    """Each ball-query row refilled from its unique members (the reference's
    QueryAndGroup(sample_uniformly=True), the JAX package's
    ``uniform_resample_idx``): the row's sorted unique indices first, every
    later slot one of them drawn uniformly from ``generator``, which lives on
    ``idx``'s device. One sort, a stable compaction and one draw for all rows.
    (B, M, ns) int -> (idx (B, M, ns) int32, unique_cnt (B, M) float32)."""
    ns = idx.shape[-1]
    srt = torch.sort(idx.long(), dim=-1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[..., 1:] = srt[..., 1:] != srt[..., :-1]
    cnt = first.sum(dim=-1)
    # the unique values to the front: a stable sort on their rank among the
    # first occurrences, ns (past the end) for the repeats
    rank = torch.where(first, torch.cumsum(first, dim=-1) - 1, ns)
    unique = torch.gather(srt, -1, torch.argsort(rank, dim=-1, stable=True))
    u = torch.rand(idx.shape, generator=generator, device=idx.device)
    r = (u * cnt[..., None]).long().clamp_max(cnt[..., None] - 1)
    fill = torch.gather(unique, -1, r)
    slots = torch.arange(ns, device=idx.device)
    out = torch.where(slots < cnt[..., None], unique, fill)
    return out.int(), cnt.float()


def query_and_group(radius, nsample, xyz, new_xyz, features=None, use_xyz=True,
                    normalize_xyz=False, sample_uniformly=False, ret_unique_cnt=False, generator=None):
    """Ball query + grouping. Returns (grouped (B, M, ns, [3+]C), grouped_xyz
    (B, M, ns, 3) relative to the centers, idx (B, M, ns)), and with
    ``ret_unique_cnt`` each row's unique count (B, M) after them.
    ``sample_uniformly`` refills the rows (``uniform_resample_idx``) from
    ``generator``; ``ret_unique_cnt`` needs it, as the reference asserts."""
    if ret_unique_cnt:
        assert sample_uniformly, "ret_unique_cnt requires sample_uniformly"
    idx = ball_query(radius, nsample, xyz, new_xyz)
    unique_cnt = None
    if sample_uniformly:
        assert generator is not None, "sample_uniformly needs a torch.Generator"
        idx, unique_cnt = uniform_resample_idx(idx, generator)
    grouped = _grouped(radius, xyz, new_xyz, features, use_xyz, normalize_xyz, idx)
    return (*grouped, unique_cnt) if ret_unique_cnt else grouped


def _grouped(radius, xyz, new_xyz, features, use_xyz, normalize_xyz, idx):
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:  # bf16 points (mixed precision): by the radius rounded to bf16, as jnp takes a Python float;
        # filled on the device, so that a CUDA graph can capture it (a host copy cannot be captured)
        grouped_xyz = grouped_xyz / (radius if grouped_xyz.dtype == torch.float32 else
                                     torch.full((), radius, dtype=grouped_xyz.dtype, device=grouped_xyz.device))
    if features is None:
        if not use_xyz:
            raise ValueError("cannot group with neither features nor xyz")
        return grouped_xyz, grouped_xyz, idx
    grouped_feats = group_points(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz, idx
    return grouped_feats, grouped_xyz, idx


def group_all(xyz: torch.Tensor, features: torch.Tensor | None = None, use_xyz: bool = True):
    """The whole cloud as one region (the reference's GroupAll, the SA stage
    with npoint None), channel-last: (grouped (B, 1, N, [3+]C),
    grouped_xyz (B, 1, N, 3)), the coordinates raw, not centered."""
    grouped_xyz = xyz[:, None]
    if features is None:
        return grouped_xyz, grouped_xyz
    grouped_feats = features[:, None]
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz
    return grouped_feats, grouped_xyz


def knn(k: int, query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The k nearest ref points of each query point (self included when query is
    ref), nearest first, ties to the lower index. -> (B, Nq, k) int32. Under a
    point group the queries split."""
    group = _point_group_for(query.shape[1])
    if group is not None:
        return mesh_ctx.shard_pointwise(functools.partial(_knn_raw, k), group, 1, 1)(query, ref)
    return _knn_raw(k, query, ref)


def _knn_raw(k: int, query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    d2 = _square_distance_raw(query, ref)
    return torch.argsort(d2, dim=-1, stable=True)[..., :k].int()


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """The three nearest known points of each unknown point: (dist (B, n, 3),
    the EUCLIDEAN distance, as _ext.three_nn gives it; idx (B, n, 3) int32),
    nearest first, ties to the lower index. Under a point group the unknown
    rows split."""
    group = _point_group_for(unknown.shape[1])
    if group is not None:
        return mesh_ctx.shard_pointwise(_three_nn_raw, group, 1, 1, n_out=2)(unknown, known)
    return _three_nn_raw(unknown, known)


def _three_nn_raw(unknown: torch.Tensor, known: torch.Tensor):
    d2 = _square_distance_raw(unknown, known)
    idx = torch.argsort(d2, dim=-1, stable=True)[..., :3]
    return torch.sqrt(torch.gather(d2, -1, idx).clamp_min(0.0)), idx.int()


def three_interpolate(features: torch.Tensor, idx: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Weighted 3-NN feature interpolation: (B, M, C) features, (B, n, 3) idx
    and weights -> (B, n, C), the sum over the three in order. Differentiable
    (the backward is the scatter-add of _ext.three_interpolate_grad)."""
    return (group_points(features, idx) * weight[..., None]).sum(dim=2)
