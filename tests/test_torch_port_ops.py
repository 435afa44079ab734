"""The port's plain point ops (``ptt_tpu_torch.ops.point_ops``) against the JAX
package's ``ptt_tpu.ops.point_ops`` on the same numpy inputs. Index-valued
results must agree bit for bit, including clouds with duplicated points, where
every tie rule is exercised."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.ops import point_ops as jops
from ptt_tpu_torch.ops import point_ops as tops

torch.set_num_threads(1)


def _cloud(rng, B, N, dup: bool):
    """(B, N, 3) float32, with the second half a copy of the first when ``dup``
    (resampling with replacement makes such clouds on the main path)."""
    if not dup:
        return rng.standard_normal((B, N, 3)).astype(np.float32)
    half = rng.standard_normal((B, N // 2, 3)).astype(np.float32)
    pts = np.concatenate([half, half[:, rng.permutation(N // 2)]], axis=1)
    return pts[:, :N]


@pytest.mark.parametrize("dup", [False, True])
def test_square_distance(rng, dup):
    a = _cloud(rng, 2, 200, dup)
    b = _cloud(rng, 2, 64, dup)
    ref = np.asarray(jops.square_distance(jnp.asarray(a), jnp.asarray(b)))
    got = tops.square_distance(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.shape == ref.shape and (got >= 0).all()
    # float32 matmul form; the summation order of the 3-term dot may differ
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,N,m,dup", [(1, 128, 16, False), (4, 256, 64, False), (2, 512, 512, False),
                                       (2, 256, 128, True)])
def test_furthest_point_sample(rng, B, N, m, dup):
    xyz = _cloud(rng, B, N, dup)
    ref = np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), m))
    got = tops.furthest_point_sample(torch.from_numpy(xyz), m).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("radius,ns,dup", [(0.4, 16, False), (0.8, 32, True), (0.3, 8, True),
                                           (0.05, 4, False)])
def test_ball_query(rng, radius, ns, dup):
    xyz = _cloud(rng, 2, 300, dup)
    centers = xyz[:, :96].copy()
    centers[:, -8:] += 50.0  # empty balls: every slot takes point 0
    ref = np.asarray(jops.ball_query(radius, ns, jnp.asarray(xyz), jnp.asarray(centers)))
    got = tops.ball_query(radius, ns, torch.from_numpy(xyz), torch.from_numpy(centers)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    assert (got[:, -8:] == 0).all()


def test_ball_query_more_slots_than_points(rng):
    xyz = rng.standard_normal((1, 10, 3)).astype(np.float32)
    ref = np.asarray(jops.ball_query(5.0, 16, jnp.asarray(xyz), jnp.asarray(xyz[:, :4])))
    got = tops.ball_query(5.0, 16, torch.from_numpy(xyz), torch.from_numpy(xyz[:, :4])).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k,dup", [(16, False), (16, True), (3, True)])
def test_knn(rng, k, dup):
    xyz = _cloud(rng, 2, 128, dup)
    ref = np.asarray(jops.knn(k, jnp.asarray(xyz), jnp.asarray(xyz)))
    got = tops.knn(k, torch.from_numpy(xyz), torch.from_numpy(xyz)).numpy()
    np.testing.assert_array_equal(got, ref)


def test_gather_and_group_points(rng):
    pts = rng.standard_normal((2, 50, 7)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 12, 5)).astype(np.int32)
    ref = np.asarray(jops.group_points(jnp.asarray(pts), jnp.asarray(idx)))
    got = tops.group_points(torch.from_numpy(pts), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    ref = np.asarray(jops.gather_points(jnp.asarray(pts), jnp.asarray(idx[:, :, 0])))
    got = tops.gather_points(torch.from_numpy(pts), torch.from_numpy(idx[:, :, 0])).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("C,use_xyz,normalize", [(5, True, True), (5, False, False), (0, True, False)])
def test_query_and_group(rng, C, use_xyz, normalize):
    xyz = _cloud(rng, 2, 200, True)
    centers = xyz[:, :40]
    feats = rng.standard_normal((2, 200, C)).astype(np.float32) if C else None
    ref = jops.query_and_group(0.6, 16, jnp.asarray(xyz), jnp.asarray(centers),
                               None if feats is None else jnp.asarray(feats),
                               use_xyz=use_xyz, normalize_xyz=normalize)
    got = tops.query_and_group(0.6, 16, torch.from_numpy(xyz), torch.from_numpy(centers),
                               None if feats is None else torch.from_numpy(feats),
                               use_xyz=use_xyz, normalize_xyz=normalize)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for g, r in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)
