"""The port's KITTI data path against the JAX package's on the CPU: the label
parse, the calibration, the tracklets (both REF_COOR, with and without the
tracklet database), train items bit for bit (also with DATA_AUGMENTOR and a
DATA_PROCESSOR), test items, ``build_dataloader``'s batches, the database file,
``utils/file_io`` round trips, and the KITTI trees ``chip_smoke.py`` writes."""

import io
import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from ptt_tpu.data import calibration as jcalib
from ptt_tpu.data import kitti as jkitti
from ptt_tpu.data import kitti_label as jlabel
from ptt_tpu.data.loader import build_dataloader as jbuild_dataloader
from ptt_tpu.utils import file_io as jfile_io
from ptt_tpu_torch.config import config_by_path
from ptt_tpu_torch.data import ALL_DATASETS, NuscenesTrackingDataset
from ptt_tpu_torch.data import calibration, kitti, kitti_label
from ptt_tpu_torch.data.loader import build_dataloader
from ptt_tpu_torch.data.synthetic import make_tracklets
from ptt_tpu_torch.utils import file_io
from tests.test_kitti_data import base_cfg, make_kitti_tree

torch.set_num_threads(1)

BOX_TOL = 1e-9


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The JAX tests' 6-frame scene 0000, and scene 0001 of two cars in shared
    sweeps (one of them leaving after 4 frames) with DontCare rows."""
    root = tmp_path_factory.mktemp("kitti")
    make_kitti_tree(root, n_frames=6)
    clouds, tracks = chip_smoke.sweep_scene(np.random.default_rng(1), 6, [6, 4], n_points=6400)
    chip_smoke.write_kitti_scene(root, "0001", clouds, tracks)
    return root


def _cfg(root, ref="lidar", db=False, split="all", **extra):
    cfg = base_cfg(root, load_db=db)
    cfg.update(REF_COOR=ref, DATA_SPLIT={"train": split, "test": split}, **extra)
    return cfg


def _same_frames(ours, ref):
    assert len(ours) == len(ref)
    for ot, rt in zip(ours, ref):
        assert len(ot) == len(rt)
        for a, b in zip(ot, rt):
            assert a["pc"].dtype == b["pc"].dtype
            np.testing.assert_array_equal(a["pc"], b["pc"])
            np.testing.assert_allclose(a["box"].center, b["box"].center, rtol=0, atol=BOX_TOL)
            np.testing.assert_allclose(a["box"].wlh, b["box"].wlh, rtol=0, atol=BOX_TOL)
            np.testing.assert_allclose(a["box"].orientation.elements, b["box"].orientation.elements, rtol=0,
                                       atol=BOX_TOL)
            assert a["anno"].keys() == b["anno"].keys()
            for key in b["anno"]:
                _same_value(a["anno"][key], b["anno"][key], key)


def _same_value(a, b, key):
    """Strings and integers equal; floats equal to the last bit or one: pandas'
    default parser (the JAX package's) may round a 17-digit label value to the
    neighbouring double, where Python's float() rounds it correctly."""
    if isinstance(b, str) or key in ("frame", "track_id"):
        assert a == b, key
    else:
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=3e-16, atol=0, err_msg=key)


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("ref", ["lidar", "camera"])
@pytest.mark.parametrize("db", [False, True])
def test_tracklets_equal_jax(tree, tmp_path, training, ref, db):
    """Both REF_COOR, with and without the database (built, then read back)."""
    if db:  # each case its own database files
        for sub in ("training",):
            (tmp_path / sub).symlink_to(tree / sub)
        root = tmp_path
    else:
        root = tree
    cfg = _cfg(root, ref, db)
    ref_ds = jkitti.KittiTrackingDataset(cfg, "Car", training=training)
    for _ in range(2 if db else 1):
        ours = kitti.KittiTrackingDataset(cfg, "Car", training=training)
        _same_frames(ours.tracklets, ref_ds.tracklets)
    assert [len(t) for t in ours.tracklets] == [6, 6, 4]
    assert len(ours) == len(ref_ds)


def test_train_items_equal_jax(tree):
    cfg = _cfg(tree, split="train")
    ours, ref = kitti.KittiTrackingDataset(cfg, "Car"), jkitti.KittiTrackingDataset(cfg, "Car")
    assert len(ours) == len(ref) == 16 * 2
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")


def test_train_items_with_augmentor_and_processor_equal_jax(tree):
    """ptt_synth_aug.yaml's DATA_AUGMENTOR and a DATA_PROCESSOR queue, drawn
    from each item's generator in the JAX package's order."""
    augmentor = config_by_path("tools/cfgs/synthetic_models/ptt_synth_aug.yaml")["DATA_CONFIG"]["DATA_AUGMENTOR"]
    processor = [{"NAME": "sample_points", "NUM_POINTS": {"train": 700, "test": -1}},
                 {"NAME": "shuffle_points", "SHUFFLE_ENABLED": {"train": True, "test": False}}]
    cfg = _cfg(tree, split="all", DATA_AUGMENTOR=augmentor, DATA_PROCESSOR=processor)
    ours, ref = kitti.KittiTrackingDataset(cfg, "Car"), jkitti.KittiTrackingDataset(cfg, "Car")
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a["search_points"].shape == (700, 3)
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")


def test_test_items_equal_jax(tree):
    cfg = _cfg(tree)
    ours = kitti.KittiTrackingDataset(cfg, "Car", training=False)
    ref = jkitti.KittiTrackingDataset(cfg, "Car", training=False)
    assert len(ours) == len(ref) == 3
    for i in range(len(ref)):
        (pcs, boxes, annos), (rpcs, rboxes, rannos) = ours[i], ref[i]
        for a, b in zip(pcs, rpcs):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(boxes, rboxes):
            np.testing.assert_allclose(a.corners(), b.corners(), rtol=0, atol=BOX_TOL)
        assert [(x["scene"], x["frame"], x["track_id"]) for x in annos] == \
               [(x["scene"], x["frame"], x["track_id"]) for x in rannos]
    # test clouds are whole and shared by the tracklets of a scene
    assert ours[1][0][0] is ours[2][0][0] and len(ours[1][0][0]) == 6400


@pytest.mark.parametrize("training", [True, False])
def test_build_dataloader_batches_equal_jax(tree, training):
    cfg = _cfg(tree, split="all")
    ours_ds, ours = build_dataloader(cfg, "Car", 4, workers=2, training=training, seed=3)
    ref_ds, ref = jbuild_dataloader(cfg, "Car", 4, workers=2, training=training, seed=3)
    assert len(ours) == len(ref) and type(ours_ds) is ALL_DATASETS[cfg["DATASET"]]
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        got, want = list(ours), list(ref)
        assert len(got) == len(want) == len(ours)
        for a, b in zip(got, want):
            if training:
                for key in b:
                    np.testing.assert_array_equal(a[key], b[key])
            else:
                assert len(a) == len(b)
                for (pcs, boxes, _), (rpcs, rboxes, _) in zip(a, b):
                    assert all(np.array_equal(x, y) for x, y in zip(pcs, rpcs))
                    assert all(np.allclose(x.center, y.center, rtol=0, atol=BOX_TOL) for x, y in zip(boxes, rboxes))


@pytest.mark.parametrize("split", ["train", "TRAIN_TINY", "val", "val_tiny", "test", "TEST_TINY", "all", "train_val"])
def test_get_scenes_equal_jax(split):
    assert kitti.get_scenes(split) == jkitti.get_scenes(split)


def test_calibration_and_label_lines_equal_jax(tree, rng):
    path = tree / "training" / "calib" / "0000.txt"
    ours, ref = calibration.Calibration(path), jcalib.Calibration(path)
    pts = rng.uniform(-40, 40, (500, 3))
    for name in ("project_velo_to_ref", "project_ref_to_velo", "project_rect_to_ref", "project_ref_to_rect",
                 "project_rect_to_velo", "project_velo_to_rect", "project_rect_to_image", "project_velo_to_image"):
        np.testing.assert_allclose(getattr(ours, name)(pts), getattr(ref, name)(pts), rtol=0, atol=1e-12,
                                   err_msg=name)
    np.testing.assert_array_equal(calibration.inverse_rigid_trans(ours.V2C), jcalib.inverse_rigid_trans(ref.V2C))
    label = tree / "training" / "label_02" / "0001.txt"
    for a, b in zip(kitti_label.get_objects_from_label(label), jlabel.get_objects_from_label(label)):
        assert (a.frame_id, a.track_id, a.cls_type, a.cls_id) == (b.frame_id, b.track_id, b.cls_type, b.cls_id)
        np.testing.assert_array_equal(a.generate_corners3d(), b.generate_corners3d())
        assert a.to_kitti_format() == b.to_kitti_format() and a.to_str() == b.to_str()
    rows = kitti.read_label_file(label)
    assert [r["type"] for r in rows].count("DontCare") == 6 and {r["track_id"] for r in rows} == {-1, 0, 1}
    assert all(isinstance(r["frame"], int) and isinstance(r["x"], float) for r in rows)


def test_database_round_trip_and_name(tree, tmp_path):
    """The port's database holds numpy arrays and plain dicts only, each shared
    cloud once, under a name the JAX package never uses; a file of the JAX
    package's at its own name is not read."""
    (tmp_path / "training").symlink_to(tree / "training")
    cfg = _cfg(tmp_path, db=True)
    first = kitti.KittiTrackingDataset(cfg, "Car", training=False)
    path = first.database_path()
    assert path.exists() and path.name != first.jax_database_path().name
    assert path.name == "kitti_Car_lidar_-1.0_infos_test_torch.pkl"
    first.jax_database_path().write_bytes(b"not a pickle")

    class NoClasses(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("numpy"):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(f"{module}.{name}")

    with open(path, "rb") as f:
        db = NoClasses(f).load()
    frames = [fr for trk in db["tracklets"] for fr in trk]
    assert len(frames) == 16 and len({id(fr["pc"]) for fr in frames}) == 6 + 6
    # scene 0001's 6 clouds are stored once although two tracklets hold them
    assert path.stat().st_size < 1.2 * (6 * 6400 + 6 * 1200) * 12

    again = kitti.KittiTrackingDataset(cfg, "Car", training=False)
    _same_frames(again.tracklets, first.tracklets)
    assert again.tracklets[1][0]["pc"] is again.tracklets[2][0]["pc"]


def test_nuscenes_is_refused():
    with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
        NuscenesTrackingDataset({}, "car")


def test_chip_smoke_trees_read_back(tmp_path):
    """The agreement tracklets written as KITTI scenes, as chip_smoke.py phase 11
    writes them, read back as the same clouds and boxes (the label's full
    precision and the exact calibration)."""
    tracklets = make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 5, "SYNTH_SEED": 11})
    for i, (pcs, boxes, _) in enumerate(tracklets):
        chip_smoke.write_kitti_scene(tmp_path, f"{i:04d}", pcs, {i: dict(enumerate(boxes))})
    ds = kitti.KittiTrackingDataset(_cfg(tmp_path), "Car", training=False)
    assert len(ds) == 2
    for i, (pcs, boxes, _) in enumerate(tracklets):
        got_pcs, got_boxes, annos = ds[i]
        assert [a["scene"] for a in annos] == [f"{i:04d}"] * 5 and [a["frame"] for a in annos] == list(range(5))
        for a, b in zip(got_pcs, pcs):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got_boxes, boxes):
            np.testing.assert_allclose(a.center, b.center, rtol=0, atol=BOX_TOL)
            np.testing.assert_allclose(a.rotation_matrix, b.rotation_matrix, rtol=0, atol=BOX_TOL)
            np.testing.assert_allclose(a.wlh, b.wlh, rtol=0, atol=BOX_TOL)


# ------------------------------------------------------------------- file_io


@pytest.fixture
def pts(rng):
    return rng.standard_normal((100, 3)).astype(np.float32)


def test_bin_roundtrip(tmp_path, rng):
    pts4 = rng.standard_normal((50, 4)).astype(np.float32)
    pts4.tofile(tmp_path / "scan.bin")
    np.testing.assert_array_equal(file_io.get_pts_from_bin(tmp_path / "scan.bin"), pts4)


@pytest.mark.parametrize("binary", [False, True])
def test_pcd_roundtrip_both_ways(tmp_path, pts, binary):
    """Written by either package, read by both."""
    for writer in (file_io, jfile_io):
        path = writer.save_pts_as_pcd(pts, tmp_path / writer.__name__, "cloud.pcd", binary=binary)
        for reader in (file_io, jfile_io):
            np.testing.assert_allclose(reader.read_pcd(path), pts, atol=1e-5)
    assert (tmp_path / file_io.__name__ / "cloud.pcd").read_bytes() == (tmp_path / jfile_io.__name__ /
                                                                         "cloud.pcd").read_bytes()


def test_ply_roundtrip(tmp_path, pts):
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    path = file_io.write_ply(tmp_path / "mesh", pts, faces=faces)
    verts, out_faces = file_io.read_ply(path, triangular_mesh=True)
    np.testing.assert_allclose(np.stack([verts["x"], verts["y"], verts["z"]], 1), pts, atol=1e-6)
    np.testing.assert_array_equal(out_faces, faces)
    jverts, jfaces = jfile_io.read_ply(path, triangular_mesh=True)
    np.testing.assert_array_equal(jverts, verts)
    assert len(file_io.read_ply(file_io.save_ply(tmp_path / "pts.ply", pts))) == 100


def test_xyz_and_json_roundtrip(tmp_path, pts):
    file_io.save_xyz_file(pts, tmp_path / "pts.xyz")
    np.testing.assert_allclose(file_io.read_xyz_file(tmp_path / "pts.xyz"), pts, atol=1e-5)
    d = {"a": 1, "arr": np.arange(3), "f": np.float32(2.5)}
    file_io.save_dict_as_json(d, tmp_path / "d.json")
    assert file_io.load_json_as_dict(tmp_path / "d.json") == {"a": 1, "arr": [0, 1, 2], "f": 2.5}


def test_track_results_line_equals_jax(rng):
    corners = rng.standard_normal((8, 3))
    ours, ref = io.StringIO(), io.StringIO()
    file_io.save_track_results(ours, [0, 5, 1], corners)
    jfile_io.save_track_results(ref, [0, 5, 1], corners)
    assert ours.getvalue() == ref.getvalue() and len(ours.getvalue().split()) == 27
