"""The plain versions behind the port's two CUDA kernels (``ops/fps.py`` and
``ops/sa.py``) against the JAX package's Pallas kernels, run in interpret mode
on the CPU as the JAX package's own tests run them. On a CPU tensor each
wrapper takes its plain version; the kernels themselves are checked on the card
by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.ops import pallas_sa
from ptt_tpu.ops import point_ops as jops
from ptt_tpu.ops.pallas_fps import furthest_point_sample_pair as jpair
from ptt_tpu.ops.pallas_fps import furthest_point_sample_pallas
from ptt_tpu_torch.ops import fps, point_ops, sa

torch.set_num_threads(1)


def _dup_cloud(rng, B, N):
    base = rng.standard_normal((B, N // 2, 3)).astype(np.float32)
    return np.concatenate([base, base], axis=1)


# --------------------------------------------------------------------------- FPS


@pytest.mark.parametrize("B,N,m,dup", [(1, 128, 16, False), (4, 256, 64, False), (2, 512, 512, False),
                                       (1, 128, 32, True), (3, 256, 200, True)])
def test_fps_matches_pallas_and_jnp(rng, B, N, m, dup):
    xyz = _dup_cloud(rng, B, N) if dup else rng.standard_normal((B, N, 3)).astype(np.float32)
    got = fps.furthest_point_sample(torch.from_numpy(xyz), m).numpy()
    np.testing.assert_array_equal(got, np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), m, interpret=True)))
    np.testing.assert_array_equal(got, np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), m)))
    assert (got[:, 0] == 0).all()


@pytest.mark.parametrize("Na,Nb,ma,mb,dup", [(256, 128, 64, 32, False), (128, 128, 32, 32, False),
                                             (256, 128, 128, 64, True)])
def test_fps_pair_matches_pallas_pair(rng, Na, Nb, ma, mb, dup):
    if dup:
        a, b = _dup_cloud(rng, 3, Na), _dup_cloud(rng, 3, Nb)
    else:
        a = rng.standard_normal((3, Na, 3)).astype(np.float32)
        b = rng.standard_normal((3, Nb, 3)).astype(np.float32)
    ia, ib = fps.furthest_point_sample_pair(torch.from_numpy(a), ma, torch.from_numpy(b), mb)
    ja, jb = jpair(jnp.asarray(a), ma, jnp.asarray(b), mb)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(ib.numpy(), np.asarray(jb))
    # and equal to two separate runs
    np.testing.assert_array_equal(ib.numpy(), fps.furthest_point_sample(torch.from_numpy(b), mb).numpy())


def test_fps_pair_wants_larger_branch_first(rng):
    a = torch.zeros(1, 64, 3)
    b = torch.zeros(1, 128, 3)
    with pytest.raises(ValueError):
        fps.furthest_point_sample_pair(a, 16, b, 16)


# ---------------------------------------------------------------------------- SA


def _sa_inputs(rng, B, N, M, C, layers):
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    feats = rng.standard_normal((B, N, C)).astype(np.float32) if C else None
    Ws = [(rng.standard_normal(s) * 0.2).astype(np.float32) for s in layers]
    bs = [(rng.standard_normal((s[1],)) * 0.2).astype(np.float32) for s in layers]
    return xyz, new_xyz, feats, Ws, bs


def _both(xyz, new_xyz, feats, radius, ns, Ws, bs):
    ref = pallas_sa.fused_sa_inference(
        jnp.asarray(xyz), jnp.asarray(new_xyz), None if feats is None else jnp.asarray(feats),
        radius, ns, tuple(jnp.asarray(w) for w in Ws), tuple(jnp.asarray(b) for b in bs), interpret=True)
    got = sa.fused_sa_inference(
        torch.from_numpy(xyz), torch.from_numpy(new_xyz), None if feats is None else torch.from_numpy(feats),
        radius, ns, [torch.from_numpy(w) for w in Ws], [torch.from_numpy(b) for b in bs])
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("B,N,M,ns,C", [(2, 256, 128, 16, 8), (1, 512, 64, 32, 0), (2, 300, 96, 8, 5)])
def test_sa_matches_pallas(rng, B, N, M, ns, C):
    xyz, new_xyz, feats, Ws, bs = _sa_inputs(rng, B, N, M, C, [(C + 3, 16), (16, 32)])
    got, ref = _both(xyz, new_xyz, feats, 0.4, ns, Ws, bs)
    assert got.shape == ref.shape == (B, M, 32)
    # float32 summation order differs between the two paths
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_sa_empty_ball_matches_pallas(rng):
    B, N, M, ns = 1, 128, 64, 8
    xyz = (rng.standard_normal((B, N, 3)) * 10).astype(np.float32)
    far = (rng.standard_normal((B, M, 3)) + 100.0).astype(np.float32)
    Ws = [(rng.standard_normal((3, 8)) * 0.2).astype(np.float32)]
    bs = [(rng.standard_normal((8,)) * 0.2).astype(np.float32)]
    got, ref = _both(xyz, far, None, 0.3, ns, Ws, bs)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def test_sa_first_layer_fold_equals_grouped_layer0(rng):
    """The kernel's input: relu(Z[neighbour] + O[center]) equals layer 0 of the
    grouped composite (the decomposition of pallas_sa.py:204-225)."""
    B, N, M, ns, C, radius = 2, 200, 50, 16, 6, 0.5
    xyz, new_xyz, feats, Ws, bs = _sa_inputs(rng, B, N, M, C, [(C + 3, 24)])
    t = [torch.from_numpy(x) for x in (xyz, new_xyz, feats, Ws[0], bs[0])]
    z, off = sa._first_layer(t[0], t[1], t[2], radius, t[3], t[4], True, True)
    idx = point_ops.ball_query(radius, ns, t[0], t[1])
    folded = torch.relu(point_ops.group_points(z, idx) + off[:, :, None, :])
    grouped, _, _ = point_ops.query_and_group(radius, ns, t[0], t[1], t[2], normalize_xyz=True)
    direct = torch.relu(grouped @ t[3] + t[4])
    np.testing.assert_allclose(folded.numpy(), direct.numpy(), rtol=1e-5, atol=2e-5)


def test_fold_bn_matches_pallas(rng):
    w = rng.standard_normal((10, 6)).astype(np.float32)
    scale, bias, mean = (rng.standard_normal(6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    jw, jb = pallas_sa.fold_bn(*(jnp.asarray(x) for x in (w, scale, bias, mean, var)))
    tw, tb = sa.fold_bn(*(torch.from_numpy(x) for x in (w, scale, bias, mean, var)))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: there is no
    fallback to the plain version."""
    xyz = torch.zeros(1, 64, 3, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        fps.furthest_point_sample(xyz, 8)
    with pytest.raises((ValueError, RuntimeError)):
        sa.fused_sa_inference(xyz, xyz[:, :8], None, 0.3, 4, [torch.zeros(3, 8, device="meta")],
                              [torch.zeros(8, device="meta")])
