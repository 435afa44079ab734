"""Plain PyTorch point-cloud ops, channel-last like the JAX package's
``ops/point_ops.py``: clouds are (B, N, 3), features (B, N, C).

Every distance here is spelled out elementwise in one fixed order,
``((a0*b0 + a1*b1) + a2*b2)``, with each product and sum rounded on its own. A
matrix product would leave the order (and the use of fused multiply-adds) to
the library, and that differs between the CPU and the GPU; the fixed order
gives the same bits on both, and the same bits as the CUDA kernels in
``csrc/``, which use the ``__fmul_rn``/``__fadd_rn`` intrinsics. In-ball
membership and neighbour order then agree exactly between every path.
"""

from __future__ import annotations

import functools

import torch


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...): (x*x + y*y) + z*z."""
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance in the matmul form |a|^2 + |b|^2 - 2ab, clamped
    at 0, in float32: (B, N, C) x (B, M, C) -> (B, N, M). For points (C = 3)
    every sum is spelled out in the fixed order above; wider rows (the 'ffps'
    feature space) use a float32 matrix product, as the JAX package does."""
    src = src.float()
    dst = dst.float()
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
    (B, N, 3) points, (B, M, 3) centers -> (B, M, nsample) int32."""
    d2 = square_distance(new_xyz, xyz)  # (B, M, N)
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


def query_and_group(radius, nsample, xyz, new_xyz, features=None, use_xyz=True,
                    normalize_xyz=False):
    """Ball query + grouping. Returns (grouped (B, M, ns, [3+]C), grouped_xyz
    (B, M, ns, 3) relative to the centers, idx (B, M, ns))."""
    idx = ball_query(radius, nsample, xyz, new_xyz)
    grouped_xyz = group_points(xyz, idx) - new_xyz[:, :, None, :]
    if normalize_xyz:  # bf16 points (mixed precision): by the radius rounded to bf16, as jnp takes a Python float
        grouped_xyz = grouped_xyz / (radius if grouped_xyz.dtype == torch.float32 else grouped_xyz.new_tensor(radius))
    if features is None:
        if not use_xyz:
            raise ValueError("cannot group with neither features nor xyz")
        return grouped_xyz, grouped_xyz, idx
    grouped_feats = group_points(features, idx)
    if use_xyz:
        return torch.cat([grouped_xyz, grouped_feats], dim=-1), grouped_xyz, idx
    return grouped_feats, grouped_xyz, idx


def knn(k: int, query: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """The k nearest ref points of each query point (self included when query is
    ref), nearest first, ties to the lower index. -> (B, Nq, k) int32."""
    d2 = square_distance(query, ref)
    return torch.argsort(d2, dim=-1, stable=True)[..., :k].int()
