"""The port's device tracker (``ptt_tpu_torch.eval.device_loop``), synthetic data
and metrics, held against the JAX package on the CPU."""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.core import geometry as jgeo
from ptt_tpu.data.synthetic import SyntheticTrackingDataset
from ptt_tpu.eval import device_loop as jdl
from ptt_tpu.eval import metrics as jmetrics
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.core import geometry as tgeo
from ptt_tpu_torch.data.synthetic import make_tracklets
from ptt_tpu_torch.eval import device_loop as tdl
from ptt_tpu_torch.eval import metrics as tmetrics

torch.set_num_threads(1)

ASSET = Path(__file__).parent / "assets" / "ptt_synth_trained.npz"


def _rand_boxes(rng, B):
    vec = np.concatenate([rng.uniform(-5, 5, (B, 3)), rng.uniform(-np.pi, np.pi, (B, 1))], 1)
    wlh = np.array([1.8, 4.2, 1.6]) * rng.uniform(0.8, 1.2, (B, 3))
    return vec.astype(np.float32), wlh.astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ------------------------------------------------------------------- primitives


@pytest.mark.parametrize("offset", [0.0, "slack"])
def test_crop_canonical_matches_jax(rng, offset):
    B, N = 3, 700
    vec, wlh = _rand_boxes(rng, B)
    pts = rng.uniform(-8, 8, (B, N, 3)).astype(np.float32)
    valid = rng.random((B, N)) < 0.9
    offs = (0.6 * wlh[:, 1]).astype(np.float32) if offset == "slack" else np.zeros(B, np.float32)
    canon, mask = tdl.crop_canonical(_t(pts), _t(valid), _t(vec), _t(wlh), _t(offs), 1.25)
    for b in range(B):
        jc, jm = jdl.crop_canonical(jnp.asarray(pts[b]), jnp.asarray(valid[b]), jnp.asarray(vec[b]),
                                    jnp.asarray(wlh[b]), float(offs[b]), 1.25)
        np.testing.assert_allclose(canon[b].numpy(), np.asarray(jc), rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(jm))


def test_precrop_mask_matches_jax(rng):
    B, N = 3, 700
    vec, wlh = _rand_boxes(rng, B)
    pts = rng.uniform(-12, 12, (B, N, 3)).astype(np.float32)
    got = tdl.precrop_mask(_t(pts), _t(vec), _t(wlh), 0.0, 1.25).numpy()
    for b in range(B):
        ref = jdl.precrop_mask(jnp.asarray(pts[b]), jnp.asarray(vec[b]), jnp.asarray(wlh[b]), 0.0, 1.25)
        np.testing.assert_array_equal(got[b], np.asarray(ref))


@pytest.mark.parametrize("use_z", [True, False])
def test_decode_box_offset_matches_jax(rng, use_z):
    B = 5
    vec, _ = _rand_boxes(rng, B)
    off = np.concatenate([rng.normal(0, 0.3, (B, 3)), rng.normal(0, 10, (B, 1))], 1).astype(np.float32)
    got = tdl.decode_box_offset(_t(vec), _t(off), use_z).numpy()
    for b in range(B):
        ref = jdl.decode_box_offset(jnp.asarray(vec[b]), jnp.asarray(off[b]), use_z)
        np.testing.assert_allclose(got[b], np.asarray(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frac", [0.3, 0.01, 0.0])
def test_masked_resample_with_jax_picks(rng, frac):
    """Handed the picks jax.random.randint drew for the same key, the port picks
    the same rows (fractions 0.01 and 0.0 reach the <= 2 valid -> zeros branch)."""
    B, L, n_out = 3, 400, 128
    pts = rng.standard_normal((B, L, 3)).astype(np.float32)
    mask = rng.random((B, L)) < frac
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    picks = np.stack([
        np.asarray(jax.random.randint(keys[b], (n_out,), 0, max(int(mask[b].sum()), 1)))
        for b in range(B)
    ])
    out, count = tdl.masked_resample(_t(pts), _t(mask), n_out, picks=_t(picks))
    for b in range(B):
        ref, rc = jdl.masked_resample(jnp.asarray(pts[b]), jnp.asarray(mask[b]), n_out, keys[b])
        assert int(count[b]) == int(rc)
        np.testing.assert_array_equal(out[b].numpy(), np.asarray(ref))


def test_masked_resample_generator_draws_valid_rows(rng):
    B, L = 2, 300
    pts = rng.standard_normal((B, L, 3)).astype(np.float32)
    mask = rng.random((B, L)) < 0.2
    g = torch.Generator().manual_seed(0)
    out, _ = tdl.masked_resample(_t(pts), _t(mask), 256, generator=g)
    for b in range(B):
        valid_rows = {tuple(r) for r in pts[b][mask[b]]}
        assert all(tuple(r) in valid_rows for r in out[b].numpy())


# ------------------------------------------------------------------ data, metrics


def test_synthetic_tracklets_match_jax():
    cfg = {"NUM_TRACKLETS": 3, "FRAMES_PER_TRACKLET": 5, "SYNTH_SEED": 11}
    ds = SyntheticTrackingDataset(dict(cfg), training=False)
    ours = make_tracklets(cfg)
    assert len(ours) == ds.num_tracklets
    for i, (pcs, boxes, annos) in enumerate(ours):
        jpcs, jboxes, jannos = ds.get_test_item(i)
        assert annos == jannos
        for a, b in zip(pcs, jpcs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(boxes, jboxes):
            np.testing.assert_array_equal(a.center, b.center)
            np.testing.assert_array_equal(a.wlh, b.wlh)
            np.testing.assert_array_equal(a.orientation.elements, b.orientation.elements)


def test_metrics_match_jax(rng):
    succ_t, prec_t = tmetrics.Success(), tmetrics.Precision()
    succ_j, prec_j = jmetrics.Success(), jmetrics.Precision()
    for _ in range(40):
        center = rng.uniform(-5, 5, 3)
        wlh = np.array([1.8, 4.2, 1.6]) * rng.uniform(0.9, 1.1, 3)
        yaw = rng.uniform(-np.pi, np.pi)
        d = rng.normal(0, 0.4, 3)
        dyaw = rng.normal(0, 0.2)
        gt_t = tgeo.Box(center, wlh, tgeo.Quaternion(axis=[0, 0, 1], radians=yaw))
        pr_t = tgeo.Box(center + d, wlh, tgeo.Quaternion(axis=[0, 0, 1], radians=yaw + dyaw))
        gt_j = jgeo.Box(center, wlh, jgeo.Quaternion(axis=[0, 0, 1], radians=yaw))
        pr_j = jgeo.Box(center + d, wlh, jgeo.Quaternion(axis=[0, 0, 1], radians=yaw + dyaw))
        for z_axis in (False, True):
            ov_t = tmetrics.estimateOverlap(gt_t, pr_t, dim=3, ref_coord="lidar", z_axis=z_axis)
            ov_j = jmetrics.estimateOverlap(gt_j, pr_j, dim=3, ref_coord="lidar", z_axis=z_axis)
            assert ov_t == pytest.approx(ov_j, abs=1e-12)
        acc = tmetrics.estimateAccuracy(gt_t, pr_t)
        assert acc == pytest.approx(jmetrics.estimateAccuracy(gt_j, pr_j), abs=1e-12)
        succ_t.add_overlap(ov_t)
        succ_j.add_overlap(ov_j)
        prec_t.add_accuracy(acc)
        prec_j.add_accuracy(acc)
    assert succ_t.average == pytest.approx(succ_j.average, abs=1e-9)
    assert prec_t.average == pytest.approx(prec_j.average, abs=1e-9)


# --------------------------------------------------------------- the whole loop


OFFSET = np.array([0.12, -0.05, 0.02, 3.0], np.float32)


class JaxConstOffsetModel:
    """A fixed canonical-frame offset whatever the points (the JAX tests'
    ConstOffsetModel): trajectories then depend on the loop alone."""

    def apply(self, variables, batch, train=False):
        B = batch["search_points"].shape[0]
        data = np.zeros((B, 64, 5), np.float32)
        data[:, :, :4] = OFFSET
        data[:, 0, 4] = 5.0
        return {"pred_box_data": jnp.asarray(data)}


class TorchConstOffsetModel(torch.nn.Module):
    def forward(self, batch):
        B = batch["search_points"].shape[0]
        data = torch.zeros(B, 64, 5)
        data[:, :, :4] = torch.from_numpy(OFFSET)
        data[:, 0, 4] = 5.0
        return {"pred_box_data": data}


def _yaw(box):
    return np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0])


@functools.lru_cache(maxsize=1)
def _const_model_runs():
    """The JAX and the port's device evaluators over the same 2 x 8 synthetic
    frames with the constant-offset model: (JAX tracklets, JAX evaluator, its
    boxes, the port's tracklets, evaluator and boxes)."""
    jcfg = cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml")
    data_cfg = {"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 8}
    ds = SyntheticTrackingDataset(dict(data_cfg), training=False)
    jtracklets = [ds.get_test_item(i) for i in range(ds.num_tracklets)]
    tracklets = make_tracklets(data_cfg)

    jev = jdl.DeviceTrackingEvaluator(jcfg, JaxConstOffsetModel(), {}, max_points=2048, batch_size=2)
    tev = tdl.DeviceTrackingEvaluator(ptt_config(), TorchConstOffsetModel(), max_points=2048,
                                      batch_size=2, device="cpu")
    return jtracklets, jev, jev.track_batch(jtracklets), tracklets, tev, tev.track_batch(tracklets)


def test_tracker_loop_matches_jax_with_const_model():
    """Both evaluators score with their float32 C++ scorer (``native``), the
    same code: the boxes agree to 1e-5 and the summaries to 1e-6."""
    _, jev, jres, _, tev, tres = _const_model_runs()
    for jt, tt in zip(jres, tres):
        assert len(jt) == len(tt) == 8
        for jb, tb in zip(jt, tt):
            np.testing.assert_allclose(tb.center, jb.center, rtol=0, atol=1e-5)
            assert abs((_yaw(tb) - _yaw(jb) + np.pi) % (2 * np.pi) - np.pi) < 1e-5
    ts, js = tev.summary(), jev.summary()
    assert ts["frames"] == js["frames"] == 16
    assert ts["success"] == pytest.approx(js["success"], abs=1e-6)
    assert ts["precision"] == pytest.approx(js["precision"], abs=1e-6)


def test_tracker_loop_numpy_scores_match_jax():
    """The numpy metrics (the scorer for REF_COOR camera) on each package's
    boxes agree to 1e-6."""
    jtracklets, _, jres, tracklets, _, tres = _const_model_runs()
    ref, got = jmetrics.Evaluator(ref_coord="lidar"), tmetrics.Evaluator(ref_coord="lidar")
    for (_, jgts, _), jt, (_, gts, _), tt in zip(jtracklets, jres, tracklets, tres):
        for jgt, jb, gt, tb in zip(jgts, jt, gts, tt):
            ref.update_iou(jgt, jb)
            got.update_iou(gt, tb)
    assert got.Success_main.count == ref.Success_main.count == 16
    assert got.Success_main.average == pytest.approx(ref.Success_main.average, abs=1e-6)
    assert got.Precision_main.average == pytest.approx(ref.Precision_main.average, abs=1e-6)


def test_other_modes_raise():
    """A REF_BOX outside the three modes is refused, as the JAX tracker refuses
    it; the GT modes refuse to run without the ground truth."""
    cfg = ptt_config()
    with pytest.raises(ValueError):
        tdl.make_device_tracker(TorchConstOffsetModel(), cfg["DATA_CONFIG"], dict(cfg["TEST"], REF_BOX="oracle"))
    track = tdl.make_device_tracker(TorchConstOffsetModel(), cfg["DATA_CONFIG"], dict(cfg["TEST"], REF_BOX="current_gt"))
    with pytest.raises(ValueError):
        track(torch.zeros(1, 2, 8, 3), torch.full((1, 2), 8), torch.zeros(1, 4), torch.ones(1, 3))


# Both trackers with a deterministic resample (the first n_out valid rows,
# cycled) and a model whose offset depends on the search and template points:
# the loops then see the same clouds, so trajectories depend on how each mode
# crops, references and aggregates, and on nothing random.


def _jax_det_resample(pts, mask, n_out, key):
    count = jnp.sum(mask)
    pick = jnp.arange(n_out) % jnp.maximum(count, 1)
    out = jnp.take(pts, jnp.take(jnp.argsort(jnp.logical_not(mask), stable=True), pick), axis=0)
    return jnp.where(count > 2, out, jnp.zeros_like(out)), count


def _torch_det_resample(pts, mask, n_out, generator=None, picks=None):
    count = mask.sum(-1)
    picks = torch.arange(n_out)[None, :] % count.clamp_min(1)[:, None]
    return _ORIG_RESAMPLE(pts, mask, n_out, picks=picks)


_ORIG_RESAMPLE = tdl.masked_resample


def _point_offset(s, t):
    """[dx, dy, dz, dtheta_deg] from the mean search and template points."""
    return [0.12 + 0.05 * s[:, 0] - 0.03 * t[:, 0], -0.05 + 0.05 * s[:, 1] + 0.02 * t[:, 1],
            0.02 + 0.01 * t[:, 2], 3.0 + 2.0 * s[:, 0] - 1.0 * t[:, 1]]


class JaxPointModel:
    def apply(self, variables, batch, train=False):
        off = jnp.stack(_point_offset(batch["search_points"].mean(1), batch["template_points"].mean(1)), -1)
        data = jnp.zeros((off.shape[0], 64, 5), jnp.float32).at[:, :, :4].set(off[:, None])
        return {"pred_box_data": data.at[:, 0, 4].set(5.0)}


class TorchPointModel(torch.nn.Module):
    def forward(self, batch):
        off = torch.stack(_point_offset(batch["search_points"].mean(1), batch["template_points"].mean(1)), -1)
        data = torch.zeros(off.shape[0], 64, 5)
        data[:, :, :4] = off[:, None]
        data[:, 0, 4] = 5.0
        return {"pred_box_data": data}


@pytest.fixture(scope="module")
def mode_tracklets():
    data_cfg = {"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 8}
    ds = SyntheticTrackingDataset(dict(data_cfg), training=False)
    return [ds.get_test_item(i) for i in range(ds.num_tracklets)], make_tracklets(data_cfg)


@pytest.mark.parametrize("ref", ["previous_result", "previous_gt", "current_gt"])
@pytest.mark.parametrize("agg", ["firstandprevious", "first", "previous", "all"])
def test_tracker_modes_match_jax(monkeypatch, mode_tracklets, ref, agg):
    """All 12 TEST.REF_BOX x TEST.SHAPE_AGGREGATION modes reproduce the JAX
    device loop's trajectories: centers within 1e-5, yaws within 1e-5."""
    monkeypatch.setattr(jdl, "masked_resample_auto", _jax_det_resample)
    monkeypatch.setattr(tdl, "masked_resample", _torch_det_resample)
    jtracklets, tracklets = mode_tracklets
    jcfg = cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml")
    jcfg.TEST.REF_BOX, jcfg.TEST.SHAPE_AGGREGATION = ref, agg
    cfg = ptt_config()
    cfg["TEST"].update(REF_BOX=ref, SHAPE_AGGREGATION=agg)
    jres = jdl.DeviceTrackingEvaluator(jcfg, JaxPointModel(), {}, max_points=512, batch_size=2).track_batch(jtracklets)
    tres = tdl.DeviceTrackingEvaluator(cfg, TorchPointModel(), max_points=512, batch_size=2,
                                       device="cpu").track_batch(tracklets)
    moved = 0.0
    for jt, tt, (_, gts, _) in zip(jres, tres, tracklets):
        assert len(jt) == len(tt) == 8
        for jb, tb, gt in zip(jt, tt, gts):
            np.testing.assert_allclose(tb.center, jb.center, rtol=0, atol=1e-5)
            assert abs((_yaw(tb) - _yaw(jb) + np.pi) % (2 * np.pi) - np.pi) < 1e-5
            moved = max(moved, float(np.abs(tb.center - gt.center).max()))
    assert moved > 0.05  # the offsets moved the boxes off the ground truth


@pytest.mark.slow
def test_trained_asset_tracks_within_band():
    """The port's tracker on the agreement tracklets (8 x 24 frames, seed 11)
    with the trained asset lands within 2.0 of the asset's recorded host
    Success/Precision (the RNG stream differs from the host loop's)."""
    from ptt_tpu_torch.convert import npz_metadata, state_dict_from_npz
    from ptt_tpu_torch.nn import build_network

    cfg = ptt_config()
    model = build_network(cfg["MODEL"], device="cpu")
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    meta = npz_metadata(ASSET)
    tracklets = make_tracklets({"NUM_TRACKLETS": 8, "FRAMES_PER_TRACKLET": 24, "SYNTH_SEED": 11})
    ev = tdl.DeviceTrackingEvaluator(cfg, model, max_points=1024, batch_size=8, device="cpu")
    ev.track_batch(tracklets)
    s = ev.summary()
    assert s["frames"] == 192
    assert s["success"] >= 50.0, s
    assert abs(s["success"] - meta["host_success"]) < 2.0, (s, meta)
    assert abs(s["precision"] - meta["host_precision"]) < 2.0, (s, meta)
