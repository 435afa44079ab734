"""``ptt_waymo.yaml`` on the CPU: what its 8192-point clouds ask of the port.

- FPS: the form past 2048 points (``ops/fps.py`` KERNEL_FORMS: 16 x 16), through
  ``furthest_point_sample_packed``, the kernel's round in plain PyTorch, bit
  for bit against the plain FPS and the JAX package, at N = 2049, 4096 and
  8192, also as the pair call that pads the template to the search cloud;
- the group backward: ``group_backward_ordered``, the kernel's summation order,
  at N = 8192 within 1e-5 of the largest entry of the plain scatter-add (float32
  sums in another order), and the CSR build's ranges and refusal;
- a narrowed ptt_waymo forward against the JAX package on an 8192-point
  search cloud: sample indices equal, pred_box_data within 2e-3 (the band of
  the other whole forwards), the same best proposal;
- ``config.check_ported`` accepting ptt_waymo and ptt_synth_ps, with the
  ``point_sharding_note`` of two ranks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.ops import point_ops as jops
from ptt_tpu_torch.config import check_ported, config_by_path, point_sharding_note
from ptt_tpu_torch.convert import state_dict_from_variables
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.ops import fps, group, point_ops
from tests.test_torch_port_large import _close, _narrowed, _perturb, _plain

torch.set_num_threads(1)

BWD_TOL = 1e-5


def _cloud(rng, kind, B, N):
    if kind == "duplicated":  # resampled from 600 distinct points, as a crop resampled to 8192 is
        base = rng.standard_normal((B, 600, 3)).astype(np.float32)
        return np.take_along_axis(base, rng.integers(0, 600, (B, N, 1)).repeat(3, axis=2), axis=1)
    return rng.standard_normal((B, N, 3)).astype(np.float32)


def _packed(xyz, npoint):
    return fps.furthest_point_sample_packed(xyz, npoint, *fps.kernel_form(xyz.shape[1]))


@pytest.mark.parametrize("kind", ["random", "duplicated"])
@pytest.mark.parametrize("N", [2049, 4096, 8192])
def test_new_forms_equal_plain_and_jax(rng, N, kind):
    xyz = _cloud(rng, kind, 2, N)
    got = _packed(torch.from_numpy(xyz), 20)
    assert fps.kernel_form(N) == (16, 16)
    assert torch.equal(got, point_ops.furthest_point_sample(torch.from_numpy(xyz), 20))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), 20)))


def test_pair_call_pads_the_template(rng):
    """ptt_waymo's stage-0 pair call at a small npoint: the 2048-point template
    padded to 8192 rows with copies of its point 0, both branches in one call
    of the new form, equal to two plain calls and to the JAX package."""
    search, template = _cloud(rng, "duplicated", 2, 8192), _cloud(rng, "random", 2, 2048)
    idx_s, idx_t = fps.furthest_point_sample_pair(torch.from_numpy(search), 24, torch.from_numpy(template), 12,
                                                  sample=_packed)
    for got, cloud, m in ((idx_s, search, 24), (idx_t, template, 12)):
        assert torch.equal(got, point_ops.furthest_point_sample(torch.from_numpy(cloud), m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(jops.furthest_point_sample(jnp.asarray(cloud), m)))


def test_forms_past_2048_and_the_refusal():
    assert fps.MAX_POINTS == 8192 and fps.kernel_form(8192) == fps.kernel_form(2049) == (16, 16)
    fps.check_kernel_shapes(8192, 2048)
    with pytest.raises(ValueError):
        fps.check_kernel_shapes(8193, 2048)


@pytest.mark.parametrize("heavy", [False, True], ids=["resampled", "heavy_duplication"])
def test_group_backward_ordered_at_8192(rng, heavy):
    """ptt_waymo's first train stage at B = 1, narrow H: 2048 centers of 32
    slots over 8192 points; ``heavy``: every center on one point, most rows on
    it."""
    N, M, ns, H = 8192, 2048, 32, 64
    xyz = torch.from_numpy(_cloud(rng, "duplicated", 1, N))
    centers = xyz[:, point_ops.furthest_point_sample(xyz, M)[0].long()]
    if heavy:
        centers = xyz[:, :1].expand(1, M, 3).contiguous()
    idx = point_ops.ball_query(0.3, ns, xyz, centers)
    dd = torch.from_numpy(rng.standard_normal((1, ns, M, H)).astype(np.float32))
    plain = group.group_backward_plain(dd, idx, N)
    ordered = group.group_backward_ordered(dd, idx, N)
    assert float((ordered - plain).abs().max() / plain.abs().max()) <= BWD_TOL
    assert torch.equal(ordered, group.group_backward_ordered(dd, idx, N))
    assert int(torch.bincount(idx.reshape(-1).long()).max()) > (M * ns // 2 if heavy else 32)


def test_csr_build_ranges_and_refusal():
    """The CSR build fits ptt_waymo's 8192 points in 4 ranges; the limit is the
    largest cloud whose counters fit one range in a block's 227 KB."""
    assert group.csr_ranges(3227) == 16 and group.csr_ranges(3228) == 8 and group.csr_ranges(8192) == 4
    for n in (1024, 8192, group.BACKWARD_MAX_POINTS):
        assert group.csr_shared_bytes(n, group.csr_ranges(n)) <= 227 * 1024
    assert group.csr_ranges(group.BACKWARD_MAX_POINTS) == 1 and group.csr_ranges(group.BACKWARD_MAX_POINTS + 1) == 0
    group.check_backward_points(8192)
    with pytest.raises(ValueError):
        group.check_backward_points(group.BACKWARD_MAX_POINTS + 1)


def test_ptt_waymo_forward_matches_jax():
    """The eval forward at ptt_waymo's point counts (8192 / 2048 points, stage 0
    to 2048 / 1024 centers) and narrowed widths, on the JAX package's perturbed
    init converted with strict=True."""
    cfg = _narrowed("tools/cfgs/kitti_models/ptt_waymo.yaml")
    rng = np.random.default_rng(7)
    scale = np.array([2.5, 1.2, 0.8], np.float32)
    batch = {"search_points": (rng.standard_normal((1, 8192, 3)) * scale).astype(np.float32),
             "template_points": (rng.standard_normal((1, 2048, 3)) * scale * 0.5).astype(np.float32)}
    batch["search_points"][:, 6000:] = batch["search_points"][:, :2192]  # resampling repeats points
    jm = jbuild(cfg.MODEL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = _perturb(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, train=False))(jb), rng)
    jo = jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, jb)

    tm = build_network(copy.deepcopy(_plain(cfg.MODEL)), device="cpu")
    tm.load_state_dict(state_dict_from_variables(jax.device_get(v)), strict=True)
    with torch.no_grad():
        to = tm({k: torch.from_numpy(a) for k, a in batch.items()})
    assert to["search_seeds"].shape[1] == 256
    for key in ("search_inds", "template_inds"):
        np.testing.assert_array_equal(to[key].numpy(), np.asarray(jo[key]))
    _close(to["pred_box_data"], jo["pred_box_data"], tol=2e-3)
    np.testing.assert_array_equal(to["pred_box_data"][..., 4].argmax(1).numpy(),
                                  np.asarray(jo["pred_box_data"])[..., 4].argmax(1))


@pytest.mark.parametrize("path", ["kitti_models/ptt_waymo.yaml", "synthetic_models/ptt_synth_ps.yaml"])
@pytest.mark.parametrize("training", [False, True])
def test_one_device_configs_are_accepted(path, training):
    """Accepted on one device and on two ranks of a node: evaluation splits the
    point axis over the ranks, training runs data-parallel and says so."""
    cfg = config_by_path(path)
    assert cfg["MODEL"]["POINT_SHARDING"]["ENABLED"]
    check_ported(cfg, training=training)
    note = point_sharding_note(cfg, ranks=2, training=training)
    if training:
        assert note.startswith("POINT_SHARDING: training splits no point axis") and "data-parallel" in note
    else:
        assert note == "POINT_SHARDING on: point axis 'point' sharded over the 2 ranks of a node"
