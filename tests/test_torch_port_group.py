"""The port's grouped first linear layer (``ptt_tpu_torch/ops/group.py``, the
training SA stage's ball query + group + layer 0) against the JAX package's
``ops/pallas_group.py`` kernel in interpret mode, on the shapes of
``tests/test_pallas_group.py``. On CPU tensors the port runs the plain versions
of its two CUDA kernels inside the same autograd Function; the kernels are
checked on the card by ``chip_smoke.py``.

Tolerances: forward rtol 1e-5 / atol 2e-5 (2e-4 where empty balls put far
centers' world-scale offsets into D, as in test_pallas_group.py); gradients
5e-4 relative to their scale (float32 sums in another order, and the JAX
kernel's hi/lo bf16 one-hot split)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.ops import point_ops as jops
from ptt_tpu.ops.pallas_group import grouped_first_linear as jgroup
from ptt_tpu_torch.ops import group, point_ops

torch.set_num_threads(1)


def _case(rng, B, N, M, C, H, far=False):
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    if far:
        xyz *= 5
        new_xyz = (rng.standard_normal((B, M, 3)) + 60.0).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32) if C else None
    w1 = (rng.standard_normal((C + 3, H)) * 0.2).astype(np.float32)
    return xyz, new_xyz, feats, w1


def _t(x, grad=False):
    return None if x is None else torch.from_numpy(x).requires_grad_(grad)


def _j(x):
    return None if x is None else jnp.asarray(x)


@pytest.mark.parametrize("B,N,M,ns,C,H,radius,far,atol", [
    (2, 256, 128, 16, 8, 64, 0.4, False, 2e-5),
    (1, 512, 64, 32, 0, 32, 0.4, False, 2e-5),
    (2, 192, 64, 16, 8, 32, 0.35, False, 2e-5),  # small radius: many pad rows
    (1, 128, 64, 8, 0, 16, 0.3, True, 2e-4),  # every ball empty: point 0 everywhere
])
def test_forward_matches_pallas(rng, B, N, M, ns, C, H, radius, far, atol):
    xyz, new_xyz, feats, w1 = _case(rng, B, N, M, C, H, far)
    ref = np.asarray(jgroup(_j(xyz), _j(new_xyz), _j(feats), _j(w1), radius, ns, interpret=True))
    got = group.grouped_first_linear(_t(xyz), _t(new_xyz), _t(feats), _t(w1), radius, ns)
    assert got.shape == ref.shape == (B, ns, M, H)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=atol)
    plain = group.grouped_first_linear_plain(_t(xyz), _t(new_xyz), _t(feats), _t(w1), radius, ns)
    np.testing.assert_allclose(plain.numpy(), ref, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("radius,ns,far", [(0.4, 16, False), (0.35, 32, False), (0.3, 8, True)])
def test_idx_matches_ball_query(rng, radius, ns, far):
    xyz, new_xyz, _, w1 = _case(rng, 2, 256, 64, 0, 16, far)
    z, off = group.fold_inputs(_t(xyz), _t(new_xyz), None, _t(w1), radius)
    _, idx = group.group_forward(_t(xyz), _t(new_xyz), z, off, radius, ns)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jops.ball_query(radius, ns, _j(xyz), _j(new_xyz))))


def _rel_close(got, ref, tol, name):
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= tol * scale, f"{name}: max error {err:.3e} > {tol} x {scale:.3e}"


@pytest.mark.parametrize("C", [8, 0])
def test_gradients_match_jax(rng, C):
    """d/d(xyz, new_xyz, features, w1) of sum(out * probe), with a small radius
    so that pad rows route gradients to first hits."""
    B, N, M, ns, H, radius = 2, 192, 64, 16, 32, 0.35
    xyz, new_xyz, feats, w1 = _case(rng, B, N, M, C, H)
    probe = rng.standard_normal((B, ns, M, H)).astype(np.float32)

    def jloss(x, c, f, w):
        return jnp.sum(jgroup(x, c, f, w, radius, ns, interpret=True) * probe)

    argnums = (0, 1, 3) if C == 0 else (0, 1, 2, 3)
    jgrads = jax.grad(jloss, argnums=argnums)(_j(xyz), _j(new_xyz), _j(feats), _j(w1))
    ts = [_t(xyz, True), _t(new_xyz, True), _t(feats, True), _t(w1, True)]
    (group.grouped_first_linear(*ts, radius, ns) * torch.from_numpy(probe)).sum().backward()
    names = [["xyz", "new_xyz", "w1"], ["xyz", "new_xyz", "features", "w1"]][C != 0]
    tgrads = [t.grad for t in ts if t is not None]
    for name, tg, jg in zip(names, tgrads, jgrads):
        _rel_close(tg.numpy(), np.asarray(jg), 5e-4, name)


@pytest.mark.parametrize("C", [8, 0])
def test_function_backward_equals_plain_autograd(rng, C):
    """The autograd Function (plain scatter + the dense algebra) against
    autograd through the plain composite, with an empty-ball center."""
    B, N, M, ns, H, radius = 2, 160, 48, 16, 24, 0.35
    xyz, new_xyz, feats, w1 = _case(rng, B, N, M, C, H)
    new_xyz[:, 0] += 50.0  # empty ball: every slot takes point 0
    probe = torch.from_numpy(rng.standard_normal((B, ns, M, H)).astype(np.float32))
    grads = []
    for fn in (group.grouped_first_linear, group.grouped_first_linear_plain):
        ts = [_t(xyz, True), _t(new_xyz, True), _t(feats, True), _t(w1, True)]
        (fn(*ts, radius, ns) * probe).sum().backward()
        grads.append([t.grad.numpy() for t in ts if t is not None])
    for k, (a, b) in enumerate(zip(*grads)):
        _rel_close(a, b, 1e-5, f"input {k}")


def test_plain_scatter_equals_autograd_of_plain_gather(rng):
    """group_backward_plain (index_add_) is the exact transpose of the gather
    in group_forward_plain."""
    B, N, M, ns, H, radius = 2, 200, 50, 16, 12, 0.4
    xyz, new_xyz, _, _ = _case(rng, B, N, M, 0, H)
    new_xyz[:, 1] += 40.0
    z = torch.from_numpy(rng.standard_normal((B, N, H)).astype(np.float32)).requires_grad_(True)
    off = torch.from_numpy(rng.standard_normal((B, M, H)).astype(np.float32))
    dd = torch.from_numpy(rng.standard_normal((B, ns, M, H)).astype(np.float32))
    d, idx = group.group_forward_plain(_t(xyz), _t(new_xyz), z, off, radius, ns)
    (d * dd).sum().backward()
    dz = group.group_backward(dd, idx, N)
    np.testing.assert_allclose(dz.numpy(), z.grad.numpy(), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), point_ops.ball_query(radius, ns, _t(xyz), _t(new_xyz)).numpy())


def test_wrappers_refuse_other_devices():
    """A tensor that is not on the CPU goes to the kernel or raises: there is
    no fallback to the plain version."""
    x = torch.zeros(1, 64, 3, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        group.group_forward(x, x[:, :8], torch.zeros(1, 64, 16, device="meta"),
                            torch.zeros(1, 8, 16, device="meta"), 0.3, 4)
    with pytest.raises((ValueError, RuntimeError)):
        group.group_backward(torch.zeros(1, 4, 8, 16, device="meta"),
                             torch.zeros(1, 8, 4, dtype=torch.int32, device="meta"), 64)


def test_slot_major_train_path_equals_composite(rng):
    """The SA stage's train path on the card — SharedMLP over the slot-major
    output of grouped_first_linear, max over axis 1 — against the composite
    (query_and_group -> SharedMLP -> max over axis 2) that the CPU takes:
    outputs, updated running statistics and parameter gradients."""
    import copy

    from ptt_tpu_torch.nn.sa_module import PointnetSAModule

    B, N, M, ns, C = 2, 256, 64, 16, 8
    xyz = _t(rng.standard_normal((B, N, 3)).astype(np.float32))
    feats = _t(rng.standard_normal((B, N, C)).astype(np.float32))
    torch.manual_seed(0)
    fused = PointnetSAModule([C, 16, 32], radius=0.4, nsample=ns).train()
    composite = copy.deepcopy(fused)
    inds = torch.arange(M, dtype=torch.int32).expand(B, M)
    new_xyz = point_ops.gather_points(xyz, inds)

    def first_linear(w1):
        return group.grouped_first_linear(xyz, new_xyz, feats, w1, 0.4, ns)

    out_f = fused.mlp(None, first_linear_apply=first_linear).amax(dim=1)
    _, out_c, _ = composite(xyz, feats, inds=inds)
    np.testing.assert_allclose(out_f.detach().numpy(), out_c.detach().numpy(), rtol=1e-4, atol=1e-4)
    (out_f ** 2).sum().backward()
    (out_c ** 2).sum().backward()
    for (name, a), b in zip(fused.named_parameters(), composite.parameters()):
        _rel_close(a.grad.numpy(), b.grad.numpy(), 5e-4, name)
    for (name, a), b in zip(fused.named_buffers(), composite.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)
