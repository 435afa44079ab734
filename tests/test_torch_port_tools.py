"""The port's last modules against the JAX package on the CPU: the point ops'
other forms (``square_distance(exact=True)``, ``uniform_resample_idx``,
``query_and_group``'s options, ``group_all``), CosineSimAug without BatchNorm
and its weights both ways, ``core/box_utils``, ``utils/visualize``,
``__version__``, the evaluators on the native crop and scorer, and the six
tools (``convert_checkpoint``, ``fused_ab``, ``parity_decomposition``,
``compile_diag``, ``warmup``, ``train_ablate``) at small sizes."""

import copy
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ptt_tpu
from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.core import box_utils as jbox
from ptt_tpu.data.calibration import Calibration as JCalibration
from ptt_tpu.data.synthetic import SyntheticTrackingDataset as JSynthetic
from ptt_tpu.eval import device_loop as jdl
from ptt_tpu.eval.evaluator import TrackingEvaluator as JTrackingEvaluator
from ptt_tpu.nn import similarity as jsim
from ptt_tpu.ops import point_ops as jops
from ptt_tpu.train.checkpoint import load_variables_npz
from ptt_tpu.utils.torch_converter import export_state_dict
from ptt_tpu_torch import __version__
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.convert import (reference_state_dict, state_dict_from_npz, state_dict_from_reference,
                                   state_dict_from_variables, variables_from_state_dict)
from ptt_tpu_torch.core import box_utils
from ptt_tpu_torch.core.geometry import Box, Quaternion
from ptt_tpu_torch.data.calibration import Calibration
from ptt_tpu_torch.data.synthetic import make_tracklets
from ptt_tpu_torch.eval import device_loop as tdl
from ptt_tpu_torch.eval.evaluator import TrackingEvaluator
from ptt_tpu_torch.nn import build_network, similarity
from ptt_tpu_torch.ops import point_ops
from ptt_tpu_torch.tools import (bench_setup, compile_diag, convert_checkpoint, fused_ab, parity_decomposition,
                                 train_ablate, warmup)
from ptt_tpu_torch.train.checkpoint import load_params_from_file
from ptt_tpu_torch.utils import visualize
from ptt_tpu_torch.utils.profiling import train_step_flops
from tests.test_kitti_data import make_kitti_tree
from tests.test_torch_port_profiling import TINY_SETS
from tests.test_torch_port_tracker import JaxConstOffsetModel, TorchConstOffsetModel, _yaw

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
ASSET = REPO / "tests" / "assets" / "ptt_synth_trained.npz"


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- point ops


def test_square_distance_exact(rng):
    """Within 1e-6 of JAX's exact form, and on the CPU bit-equal to a numpy
    broadcast in the file's fixed order ((d0*d0 + d1*d1) + d2*d2)."""
    src = rng.uniform(-3, 3, (2, 64, 3)).astype(np.float32)
    dst = rng.uniform(-3, 3, (2, 48, 3)).astype(np.float32)
    got = point_ops.square_distance(_t(src), _t(dst), exact=True).numpy()
    np.testing.assert_allclose(got, np.asarray(jops.square_distance(jnp.asarray(src), jnp.asarray(dst), exact=True)),
                               rtol=0, atol=1e-6)
    d = src[:, :, None, :] - dst[:, None, :, :]
    np.testing.assert_array_equal(got, (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2])
    assert not np.array_equal(got, point_ops.square_distance(_t(src), _t(dst)).numpy())  # the other form


@pytest.mark.parametrize("features,use_xyz", [(True, True), (True, False), (False, True)])
def test_group_all_equals_jax(rng, features, use_xyz):
    xyz = rng.standard_normal((2, 40, 3)).astype(np.float32)
    feats = rng.standard_normal((2, 40, 5)).astype(np.float32) if features else None
    got = point_ops.group_all(_t(xyz), None if feats is None else _t(feats), use_xyz)
    ref = jops.group_all(jnp.asarray(xyz), None if feats is None else jnp.asarray(feats), use_xyz)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _ball_rows(rng, shape=(2, 16, 8), n=20):
    """Ball-query-like rows: a sorted prefix of distinct indices, then the first one repeated."""
    B, M, ns = shape
    out = np.empty(shape, np.int32)
    for b in range(B):
        for m in range(M):
            k = rng.integers(1, ns + 1)
            hits = np.sort(rng.choice(n, k, replace=False))
            out[b, m] = np.concatenate([hits, np.full(ns - k, hits[0])])
    return out


def test_uniform_resample_idx(rng):
    """The counts and the sorted unique front equal JAX's; every filled slot is
    a member of its row; the same generator seed gives the same rows."""
    idx = _ball_rows(rng)
    out, cnt = point_ops.uniform_resample_idx(_t(idx), torch.Generator().manual_seed(3))
    jout, jcnt = jops.uniform_resample_idx(jnp.asarray(idx), jax.random.PRNGKey(0))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))
    assert out.dtype == torch.int32 and cnt.dtype == torch.float32
    jout = np.asarray(jout)
    for b in range(idx.shape[0]):
        for m in range(idx.shape[1]):
            c = int(cnt[b, m])
            np.testing.assert_array_equal(out[b, m, :c].numpy(), jout[b, m, :c])
            np.testing.assert_array_equal(out[b, m, :c].numpy(), np.unique(idx[b, m]))
            assert set(out[b, m].tolist()) == set(idx[b, m].tolist())
    again, _ = point_ops.uniform_resample_idx(_t(idx), torch.Generator().manual_seed(3))
    assert torch.equal(out, again)


def test_query_and_group_options(rng):
    xyz = _t(rng.standard_normal((2, 64, 3)).astype(np.float32))
    feats = _t(rng.standard_normal((2, 64, 4)).astype(np.float32))
    with pytest.raises(AssertionError, match="requires sample_uniformly"):
        point_ops.query_and_group(0.8, 8, xyz, xyz[:, :16], feats, ret_unique_cnt=True)
    with pytest.raises(AssertionError, match="needs a torch.Generator"):
        point_ops.query_and_group(0.8, 8, xyz, xyz[:, :16], feats, sample_uniformly=True)
    grouped, gxyz, idx, cnt = point_ops.query_and_group(0.8, 8, xyz, xyz[:, :16], feats, sample_uniformly=True,
                                                        ret_unique_cnt=True, generator=torch.Generator().manual_seed(0))
    assert grouped.shape == (2, 16, 8, 7) and cnt.shape == (2, 16)
    plain = point_ops.ball_query(0.8, 8, xyz, xyz[:, :16])
    for b in range(2):
        for m in range(16):
            assert set(idx[b, m].tolist()) == set(plain[b, m].tolist())
            assert int(cnt[b, m]) == len(set(plain[b, m].tolist()))


# ------------------------------------------------------------ CosineSimAug, BN False


SIM_CFG = {"NAME": "CosineSimAug", "MLP": {"CHANNELS": [1 + 3 + 24, 32, 32, 32], "BN": False},
           "CONV": {"CHANNELS": [32, 32, 32], "BN": True}}


@pytest.fixture(scope="module")
def sim_pair():
    rng = np.random.default_rng(5)
    batch = {"search_feats": rng.standard_normal((2, 32, 24)), "template_feats": rng.standard_normal((2, 16, 24)),
             "template_seeds": rng.standard_normal((2, 16, 3))}
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    jm = jsim.CosineSimAug(SIM_CFG)
    v = jm.init(jax.random.PRNGKey(0), jb)
    v = jax.tree_util.tree_map(lambda x: x + 0.1 * jnp.asarray(rng.standard_normal(x.shape), jnp.float32), v)
    v = {"params": v["params"], "batch_stats": jax.tree_util.tree_map(jnp.abs, v["batch_stats"])}
    tm = similarity.CosineSimAug(SIM_CFG)
    tm.load_state_dict(state_dict_from_variables(jax.device_get(v), prefix="similarity_module"), strict=True)
    return jm, v, jb, tm, {k: torch.tensor(x, dtype=torch.float32) for k, x in batch.items()}


@pytest.mark.parametrize("train", [False, True])
def test_cosine_sim_aug_without_bn_matches_flax(sim_pair, train):
    """The concat path with layer 0's bias, eval and train, against flax with
    the weights carried JAX -> port and port -> JAX."""
    jm, v, jb, tm, tb = sim_pair
    assert all(lin.bias is not None for lin in tm.mlp.linears)
    tm = copy.deepcopy(tm).train(train)  # train mode moves the running statistics
    got = tm(dict(tb))["cosine_feats"].detach().numpy()
    if train:
        ref, _ = jm.apply(v, jb, train=True, mutable=["batch_stats"])
    else:
        ref = jm.apply(v, jb)
    np.testing.assert_allclose(got, np.asarray(ref["cosine_feats"]), rtol=2e-4, atol=2e-4)
    flat = variables_from_state_dict({f"similarity_module.{k}": x for k, x in tm.state_dict().items()})
    back = {}
    for key, x in flat.items():
        collection, _, *path = key.split("/")
        node = back.setdefault(collection, {})
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = jnp.asarray(x)
    if train:
        out, _ = jm.apply(back, jb, train=True, mutable=["batch_stats"])
    else:
        out = jm.apply(back, jb)
    np.testing.assert_allclose(np.asarray(out["cosine_feats"]), got, rtol=2e-4, atol=2e-4)


def test_cosine_sim_aug_without_bn_reference_keys(sim_pair):
    """The reference layout of the MLP without BatchNorm: a 1x1 convolution
    with a bias a layer. The JAX package's ``export_state_dict`` names both
    the kernel and the bias ``layer<j>.conv.weight`` and keeps the kernel, so
    its keys are the port's less the biases, and its tensors the port's at
    every shared key; the port's biases come back through the reference
    layout."""
    _, v, _, tm, _ = sim_pair
    state = {f"similarity_module.{k}": x for k, x in tm.state_dict().items()}
    ours = reference_state_dict(state)
    ref = export_state_dict({"similarity_module": v["params"]}, {"similarity_module": v["batch_stats"]})
    biases = {f"similarity_module.mlp.layer{j}.conv.bias" for j in range(3)}
    assert set(ours) == set(ref) | biases and not biases & set(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(ref[key]), err_msg=key)
    back, problems = state_dict_from_reference(ours, state)
    assert problems == [] and all(torch.equal(back[k], state[k]) for k in state)


# ---------------------------------------------------------------- box_utils


@pytest.fixture(scope="module")
def calib_file(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti_calib")
    make_kitti_tree(root, n_frames=1)
    return root / "training" / "calib" / "0000.txt"


def _boxes7(rng, n=10):
    boxes = np.zeros((n, 7))
    boxes[:, 0:3] = rng.uniform(-10, 10, (n, 3))
    boxes[:, 3:6] = rng.uniform(1, 4, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return boxes


def test_box_utils_match_jax(rng, calib_file):
    """Every function of the module on the same inputs, within 1e-6 or equal."""
    a, b = _boxes7(rng), _boxes7(rng)
    calib, jcalib = Calibration(calib_file), JCalibration(calib_file)
    pts = rng.uniform(-1, 2, (200, 3))
    cube = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 0], [1, 0, 1], [0, 1, 1], [1, 1, 1]], float)
    rng_limit = np.array([-8, -8, -5, 8, 8, 5])
    cam = jbox.boxes3d_lidar_to_kitti_camera(a, jcalib)
    cam[:, 2] = np.abs(cam[:, 2]) + 5.0  # in front of the camera
    cases = [
        ("in_hull", (pts, cube), (pts, cube)),
        ("boxes_to_corners_3d", (a,), (a,)),
        ("rotate_points_along_z_batch", (pts[None].repeat(3, 0), a[:3, 6]), (pts[None].repeat(3, 0), a[:3, 6])),
        ("mask_boxes_outside_range_numpy", (a, rng_limit, 2), (a, rng_limit, 2)),
        ("boxes3d_kitti_camera_to_lidar", (cam, calib), (cam, jcalib)),
        ("boxes3d_lidar_to_kitti_camera", (a, calib), (a, jcalib)),
        ("boxes3d_kitti_fakelidar_to_lidar", (a,), (a,)),
        ("boxes3d_kitti_lidar_to_fakelidar", (a,), (a,)),
        ("enlarge_box3d", (a, (0.5, 0.2, 0.1)), (a, (0.5, 0.2, 0.1))),
        ("boxes3d_kitti_camera_to_imageboxes", (cam, calib, (375, 1242)), (cam, jcalib, (375, 1242))),
        ("boxes_iou_normal", (a[:, :4], b[:, :4] + 12), (a[:, :4], b[:, :4] + 12)),
        ("boxes3d_lidar_to_aligned_bev_boxes", (a,), (a,)),
        ("boxes3d_nearest_bev_iou", (a, b), (a, b)),
    ]
    names = {name for name in dir(jbox) if callable(getattr(jbox, name)) and not name.startswith("_")
             and getattr(getattr(jbox, name), "__module__", "") == jbox.__name__}
    assert {c[0] for c in cases} == names
    for name, args, jargs in cases:
        got, ref = getattr(box_utils, name)(*args), getattr(jbox, name)(*jargs)
        if np.asarray(ref).dtype == bool:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6, err_msg=name)


# ---------------------------------------------------------------- visualize, version


def _box(center, yaw=0.3):
    return Box(center=np.asarray(center, float), wlh=np.array([1.8, 4.2, 1.6]),
               orientation=Quaternion(axis=[0, 0, 1], radians=yaw))


def test_visualize_functions_write_pngs(tmp_path, rng):
    from matplotlib.figure import Figure

    pts = rng.standard_normal((300, 3)) * 4
    gt, pred = _box([0, 0, 0.8]), _box([0.5, 0.2, 0.8], yaw=0.5)
    track = [_box([t, 0.1 * t, 0.8]) for t in range(6)]
    calls = {"pts": lambda p: visualize.visualize_pts(pts, save_path=p, title="cloud"),
             "bev": lambda p: visualize.draw_scenes(pts, gt_boxes=[gt], pred_boxes=pred, save_path=p),
             "3d": lambda p: visualize.draw_scenes_3d(pts, gt_boxes=gt, pred_boxes=[pred], save_path=p),
             "track": lambda p: visualize.draw_track(track, track[::-1], save_path=p)}
    for name, call in calls.items():
        path = tmp_path / f"{name}.png"
        assert isinstance(call(path), Figure)
        assert path.stat().st_size > 0


def test_package_imports_without_matplotlib():
    code = ("import sys; sys.modules['matplotlib'] = None\n"
            "import ptt_tpu_torch, ptt_tpu_torch.utils.visualize as v, ptt_tpu_torch.tools.fused_ab\n"
            "try:\n    v.visualize_pts([[0.0, 0.0, 0.0]])\nexcept ImportError as e:\n    print(e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "needs matplotlib" in out.stdout


def test_version_string():
    assert re.fullmatch(r"0\.1\.0(\+[0-9a-f]{4,40})?", __version__)
    assert __version__ == ptt_tpu.__version__


# ---------------------------------------------------------------- evaluators


@pytest.fixture(scope="module")
def stub_tracklets():
    data_cfg = {"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 8}
    ds = JSynthetic(dict(data_cfg), training=False)
    return [ds.get_test_item(i) for i in range(ds.num_tracklets)], make_tracklets(data_cfg)


def test_host_evaluator_native_crop_matches_jax(stub_tracklets):
    """Both host loops crop with their native library, with a model whose
    offset ignores the points: the same boxes (2e-4) and overlaps (1e-3), as
    ``test_torch_port_eval.py`` holds them."""
    jtracklets, tracklets = stub_tracklets
    jev = JTrackingEvaluator(cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml"), JaxConstOffsetModel(), {}, None)
    assert jev._native is not None
    tev = TrackingEvaluator(ptt_config(), TorchConstOffsetModel(), device="cpu")
    for jtrk, trk in zip(jtracklets, tracklets):
        for jb, tb in zip(jev.test_tracklet(*jtrk), tev.test_tracklet(*trk)):
            np.testing.assert_allclose(tb.center, jb.center, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tev.evaluator.Success_main.overlaps, jev.evaluator.Success_main.overlaps, atol=1e-3)
    np.testing.assert_allclose(tev.evaluator.Precision_main.accuracies, jev.evaluator.Precision_main.accuracies,
                               atol=1e-3)


@pytest.mark.parametrize("quantize", [True, False])
def test_device_evaluator_native_scorer_matches_jax(stub_tracklets, quantize):
    """Both device evaluators score with the native scorer, with the int16 and
    the float32 upload: boxes within 1e-5, Success and Precision within 1e-6."""
    jtracklets, tracklets = stub_tracklets
    jev = jdl.DeviceTrackingEvaluator(cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml"), JaxConstOffsetModel(),
                                      {}, max_points=2048, batch_size=2, quantize=quantize)
    tev = tdl.DeviceTrackingEvaluator(ptt_config(), TorchConstOffsetModel(), max_points=2048, batch_size=2,
                                      device="cpu", quantize=quantize)
    assert jev._native is not None and tev._native_score
    assert tev._pack(tracklets)["pcs"].dtype == (torch.int16 if quantize else torch.float32)
    for jt, tt in zip(jev.track_batch(jtracklets), tev.track_batch(tracklets)):
        for jb, tb in zip(jt, tt):
            np.testing.assert_allclose(tb.center, jb.center, rtol=0, atol=1e-5)
            assert abs((_yaw(tb) - _yaw(jb) + np.pi) % (2 * np.pi) - np.pi) < 1e-5
    ts, js = tev.summary(), jev.summary()
    assert ts["frames"] == js["frames"] == 16
    assert ts["success"] == pytest.approx(js["success"], abs=1e-6)
    assert ts["precision"] == pytest.approx(js["precision"], abs=1e-6)


# ---------------------------------------------------------------- the tools


def test_bench_setup_is_the_jax_bench_workload():
    cfg, model, tracklets, max_points = bench_setup.build_bench_setup(2, 3, device="cpu", set_cfgs=TINY_SETS)
    ds = JSynthetic(dict(cfg["DATA_CONFIG"], NUM_TRACKLETS=2, FRAMES_PER_TRACKLET=3, POINTS_PER_FRAME=600,
                         CLUTTER_POINTS=400), training=False)
    assert max_points == 2048 and not model.training
    for (pcs, boxes, _), (jpcs, jboxes, _) in zip(tracklets, (ds.get_test_item(i) for i in range(2))):
        for pc, jpc, box, jbox_ in zip(pcs, jpcs, boxes, jboxes):
            np.testing.assert_array_equal(pc, jpc)
            np.testing.assert_array_equal(box.center, jbox_.center)


def test_convert_checkpoint_reverse_forward_and_template(tmp_path, capsys):
    """The asset -> reference .pth equals the JAX package's export of it; the
    .pth -> forward -> ``load_params_from_file`` is the asset bit for bit;
    ``--template`` carries its buffers."""
    cfg = ["--cfg_file", "tools/cfgs/kitti_models/ptt.yaml", "--device", "cpu"]
    pth = tmp_path / "ref.pth"
    assert convert_checkpoint.main([*cfg, "--reverse", "--ckpt", str(ASSET), "--out", str(pth)]) == 0
    ours = torch.load(pth, weights_only=True)["model_state"]
    params, batch_stats, _ = load_variables_npz(ASSET)
    ref = export_state_dict(params, batch_stats)
    assert set(ours) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)

    out = tmp_path / "converted.pth"
    assert convert_checkpoint.main([*cfg, "--torch_ckpt", str(pth), "--out", str(out)]) == 0
    assert "wrote" in capsys.readouterr().out
    model = build_network(ptt_config()["MODEL"], device="cpu")
    load_params_from_file(out, model)
    asset = state_dict_from_npz(ASSET)
    assert all(torch.equal(model.state_dict()[k], asset[k]) for k in asset)

    template = dict(ours, **{"global_step": torch.tensor(7),
                             "centroid_voting_head.cls_loss_func.pos_weight": torch.tensor([2.0]),
                             "backbone_3d.SA_modules.0.mlp_module.layer0.normlayer.bn.num_batches_tracked":
                                 torch.tensor(11)})
    torch.save({"model_state": template}, tmp_path / "template.pth")
    exported = tmp_path / "exported.pth"
    assert convert_checkpoint.main([*cfg, "--reverse", "--ckpt", str(out), "--out", str(exported),
                                    "--template", str(tmp_path / "template.pth")]) == 0
    got = torch.load(exported, weights_only=True)["model_state"]
    assert set(got) == set(template) and int(got["global_step"]) == 7
    assert torch.equal(got["centroid_voting_head.cls_loss_func.pos_weight"], torch.tensor([2.0]))


def test_convert_checkpoint_strict_and_partial(tmp_path, capsys):
    cfg = ["--cfg_file", "tools/cfgs/kitti_models/ptt.yaml", "--device", "cpu"]
    model = build_network(ptt_config()["MODEL"], device="cpu")
    ref = reference_state_dict(model.state_dict())
    dropped = "backbone_3d.SA_modules.0.mlp_module.layer0.conv.weight"
    del ref[dropped]
    ref["extra.weight"] = torch.zeros(2)
    torch.save({"model_state": ref}, tmp_path / "partial.pth")
    with pytest.raises(ValueError, match="conversion incomplete"):
        convert_checkpoint.main([*cfg, "--torch_ckpt", str(tmp_path / "partial.pth"), "--out", str(tmp_path / "a.pth")])
    assert convert_checkpoint.main([*cfg, "--torch_ckpt", str(tmp_path / "partial.pth"), "--out",
                                    str(tmp_path / "b.pth"), "--no-strict"]) == 0
    text = capsys.readouterr().out
    assert "partial conversion: 1 missing, 1 unused torch tensors" in text and dropped in text
    assert "unused: extra.weight" in text
    converted = build_network(ptt_config()["MODEL"], device="cpu")
    load_params_from_file(tmp_path / "b.pth", converted)  # every tensor but the missing one is the file's
    ours, ref_state = converted.state_dict(), model.state_dict()
    assert [k for k in ours if not torch.equal(ours[k], ref_state[k])] == ["backbone_3d.sa_stages.0.mlp.linears.0.weight"]


def test_parity_decompose_rows():
    """The six rows in the JAX tool's order. With a model whose offset ignores
    the points, the host and device loops track the same boxes, so every row
    reads no difference."""
    tracklets = [(pcs[:6], boxes[:6], annos[:6])
                 for pcs, boxes, annos in make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 6})]
    rows = parity_decomposition.decompose(ptt_config(), TorchConstOffsetModel(), tracklets, torch.device("cpu"),
                                          max_points=1024, batch_size=2)
    assert [r[0] for r in rows] == list(parity_decomposition.ROW_NAMES)
    for _, a, b, ds, dp in rows:
        assert 0 < a[0] <= 100 and 0 < b[1] <= 100
        assert ds < 1e-6 and dp < 1e-6
    assert rows[1][1] == rows[2][2]  # the float32-upload device run, in two rows
    assert "| deployed: host vs device (int16 upload) |" in parity_decomposition.format_rows(rows)


def test_compile_diag_on_the_cpu(capsys):
    assert compile_diag.main(["--device", "cpu", "--tracklets", "2", "--frames", "4", "--max_points", "512",
                              "--set", *TINY_SETS]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"kernels=on build_dir=build/ptt_tpu_torch: nvcc build -, model to device [0-9.]+s, "
                        r"first eager step [0-9.]+s, capture -, first replay -", line), line


def test_byte_counter_hand_count_on_a_linear():
    """One Linear of (4, 6) inputs to 5 outputs: the addmm reads the bias,
    the input and the weight (its transpose is a view, not counted) and
    writes the output, float32."""
    lin = torch.nn.Linear(6, 5)
    x = torch.randn(4, 6)
    with train_ablate.ByteCounter() as counter:
        lin(x)
    assert counter.bytes == 4 * (5 + 4 * 6 + 6 * 5 + 4 * 5)


def test_train_ablate_floors_by_hand():
    """67 GFLOP in float32 is 1 ms at 67 TFLOP/s, 3.35 GB of unfused bytes
    1 ms at 3.35 TB/s: each floor's share of a 4 ms step is 25%; bf16's
    FLOP floor is 67/989 ms."""
    row = {"name": "x", "precision": "float32", "ms": 4.0, "flops": 67e9, "bytes": 3.35e9}
    f = train_ablate.roofline(row)
    assert f["flop_floor_ms"] == pytest.approx(1.0) and f["byte_floor_ms"] == pytest.approx(1.0)
    assert f["flop_pct"] == pytest.approx(25.0) and f["byte_pct"] == pytest.approx(25.0)
    assert f["gb_per_s"] == pytest.approx(837.5)
    assert train_ablate.roofline(dict(row, precision="bf16"))["flop_floor_ms"] == pytest.approx(67 / 989)
    table = train_ablate.format_rows([dict(row, name=name) for name, *_ in train_ablate.ROWS], True)
    assert "| FLOP floor / measured | unfused-byte floor / measured |" in table and "binds" not in table


def test_train_ablate_rows_on_the_cpu(capsys):
    from tests.test_torch_port_train import narrow_model_cfg

    assert train_ablate.main(["--device", "cpu", "--batch_size", "2", "--iters", "1", "--tracklets", "2",
                              "--frames", "4", "--set", *TINY_SETS]) == 0
    text = capsys.readouterr().out
    rows = [line.split(" | ") for line in text.splitlines() if line.startswith(("| full", "| fwd"))]
    assert [r[0][2:] for r in rows] == [name for name, *_ in train_ablate.ROWS]
    values = {r[0][2:]: [float(x) for x in r[1:4]] for r in rows}
    assert all(np.isfinite(v).all() and v[0] > 0 and v[1] > 0 and v[2] > 0 for v in values.values())
    # the kernel rows take the plain path's counts; forward only counts less
    assert values["full step, f32, kernels"][1:] == values["full step, f32, plain group path"][1:]
    assert values["fwd + loss only, f32, kernels"][1] < values["full step, f32, kernels"][1]
    assert "backward + optimizer by subtraction" in text

    # the full step's FLOPs are train_step_flops' (the optimizer adds no matrix product)
    from ptt_tpu_torch.data.loader import build_dataloader
    from ptt_tpu_torch.train.train_step import to_device

    model = build_network(narrow_model_cfg(), device="cpu", train=True)
    ds_cfg = dict(ptt_config()["DATA_CONFIG"], DATASET="SyntheticTrackingDataset", SEARCH_INPUT_SIZE=256,
                  TEMPLATE_INPUT_SIZE=128, NUM_TRACKLETS=2, FRAMES_PER_TRACKLET=4)
    _, loader = build_dataloader(ds_cfg, ["Car"], 2, workers=0, training=True)
    batch = to_device(next(iter(loader)), "cpu")
    flops, nbytes = train_ablate.step_cost(narrow_model_cfg(), model, batch, ptt_config()["OPTIMIZATION"], False, True)
    assert flops == train_step_flops(narrow_model_cfg(), model, batch) and nbytes > 0


def test_gpu_only_tools_refuse_the_cpu(capsys):
    assert fused_ab.main([]) != 0
    assert warmup.main([]) != 0
    assert warmup.main(["--seed-out", "cache_seeds"]) == 2
    err = capsys.readouterr().err
    assert "needs a GPU" in err and warmup.SEED_OUT_REFUSAL in err
