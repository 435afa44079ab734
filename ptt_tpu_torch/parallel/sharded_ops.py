"""Point-axis sharded ops with the group in hand (the JAX package's
``parallel/sharded_ops.py``).

Each rank of a point group (``ops/mesh_ctx.py`` ``PointGroup``) owns a
contiguous slice of the QUERY points and computes distances, neighbourhoods
or attention against the full reference cloud, which every rank holds; the
slices are gathered along dim 1 in rank order. No collective runs inside an
op. Every op returns its unsharded counterpart's result bit for bit.

Two ways to use this, as in the JAX package:
  - implicit (the model path): install the group with
    ``ops.mesh_ctx.use_point_group(group)``, and ``point_ops.square_distance``
    / ``knn`` / ``ball_query`` / ``three_nn`` and the SA kernel split large row
    counts themselves; the test CLI does this for POINT_SHARDING configurations;
  - explicit (this module): the ``sharded_*`` wrappers, which split whatever
    rows they are given.
"""

from __future__ import annotations

import functools

from ..ops import mesh_ctx, point_ops
from ..utils import dist


def sharded_square_distance(query, ref, group):
    """(B, Nq, 3) x (B, Nr, 3) -> (B, Nq, Nr) with Nq split over ``group``."""
    return mesh_ctx.shard_pointwise(point_ops._square_distance_raw, group, 1, 1)(query, ref)


def sharded_knn(k: int, query, ref, group):
    """The k nearest reference indices of each query point, queries split."""
    return mesh_ctx.shard_pointwise(functools.partial(point_ops._knn_raw, k), group, 1, 1)(query, ref)


def sharded_ball_query(radius: float, nsample: int, xyz, new_xyz, group):
    """Ball query with the CENTERS split over ``group`` (xyz whole)."""
    fn = functools.partial(point_ops._ball_query_centers, radius, nsample)
    return mesh_ctx.shard_pointwise(fn, group, 1, 1)(new_xyz, xyz)


def sharded_vector_attention(apply_fn, xyz, features, group, k: int = 16):
    """A kNN vector-attention block with the point axis split.

    ``apply_fn(xyz_shard, feats_shard, xyz_full, feats_full, knn_idx_shard)
    -> out_shard`` is the computation of one rank's query points, a port
    module applied to them against the whole cloud; this wrapper finds the
    shard's kNN in the full cloud and splits and gathers. For the stock
    blocks prefer the implicit route: under ``use_point_group`` their own
    ``point_ops.knn`` calls split themselves."""

    def one(xyz_shard, feats_shard, xyz_full, feats_full):
        idx = point_ops._knn_raw(k, xyz_shard, xyz_full)
        return apply_fn(xyz_shard, feats_shard, xyz_full, feats_full, idx)

    return mesh_ctx.shard_pointwise(one, group, 2, 2)(xyz, features, xyz, features)


def replicate(x, group):
    """``x`` on every rank of ``group`` as its first rank holds it, in place."""
    return dist.group_broadcast_(x, group.ranks[0], group.group)


def shard_points(x, group):
    """This rank's slice of (B, N, ...) along N."""
    return x[:, group.rows(x.shape[1])]
