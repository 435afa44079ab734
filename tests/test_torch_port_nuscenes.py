"""The port's nuScenes data path against the JAX package's on the CPU, on the
fixture release of ``tests/test_nuscenes_data.py`` (``make_nuscenes_tree``: the
JSON tables and LIDAR_TOP sweeps of one car tracklet among clutter and a
pedestrian instance): the tracklets chained through the annotations' ``next``
links with the split filter and the key-frame filter, the sensor -> ego ->
global transform, train items bit for bit, test items, the database in the
port's own format, the splits file, and the tree ``chip_smoke.py`` writes
for its nuScenes phase. Clouds and items equal to the bit; boxes to 1e-12."""

import pickle

import numpy as np
import pytest
import torch

import chip_smoke
from ptt_tpu.data import nuscenes as jnus
from ptt_tpu.data import nuscenes_splits as jsplits
from ptt_tpu_torch.config import config_by_path
from ptt_tpu_torch.data import nuscenes, nuscenes_splits
from ptt_tpu_torch.data.synthetic import make_tracklets
from tests.test_nuscenes_data import base_cfg, make_nuscenes_tree

torch.set_num_threads(1)

BOX_TOL = 1e-12


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("nuscenes")
    make_nuscenes_tree(root, n_frames=5)
    return root


def _same_frames(ours, ref):
    assert len(ours) == len(ref)
    for ot, rt in zip(ours, ref):
        assert len(ot) == len(rt)
        for a, b in zip(ot, rt):
            assert a["pc"].dtype == b["pc"].dtype
            np.testing.assert_array_equal(a["pc"], b["pc"])
            for x, y in ((a["box"].center, b["box"].center), (a["box"].wlh, b["box"].wlh),
                         (a["box"].orientation.elements, b["box"].orientation.elements)):
                np.testing.assert_allclose(x, y, rtol=0, atol=BOX_TOL)
            assert a["anno"] == b["anno"]


def test_splits_equal_jax():
    assert nuscenes_splits.create_splits_scenes() == jsplits.create_splits_scenes()
    assert nuscenes_splits.TRACKING_TO_GENERAL_CLASS == jsplits.TRACKING_TO_GENERAL_CLASS
    assert len(nuscenes_splits.get_split_scenes("val")) == 150


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("db", [False, True])
def test_tracklets_equal_jax(tree, tmp_path, training, db):
    """With the database, the first dataset builds it under a copy of the tree
    and the second reads it back."""
    root = tree
    if db:
        for sub in ("v1.0-trainval", "samples"):
            (tmp_path / sub).symlink_to(tree / sub)
        root = tmp_path
    split = {"train": "train_track", "test": "train_track"}  # scene-0004's split, both modes
    cfg = dict(base_cfg(root, load_db=db), DATA_SPLIT=split)
    ref = jnus.NuscenesTrackingDataset(dict(base_cfg(tree), DATA_SPLIT=split), "car", training=training)
    for _ in range(2 if db else 1):
        ours = nuscenes.NuscenesTrackingDataset(cfg, "car", training=training)
        _same_frames(ours.tracklets, ref.tracklets)
    assert [len(t) for t in ours.tracklets] == [5] and len(ours) == len(ref)


def test_split_filter(tree):
    cfg = dict(base_cfg(tree), DATA_SPLIT={"train": "val", "test": "val"})  # scene-0004 is not in val
    assert nuscenes.NuscenesTrackingDataset(cfg, "car").num_tracklets == 0
    assert jnus.NuscenesTrackingDataset(cfg, "car").num_tracklets == 0
    assert nuscenes.NuscenesTrackingDataset(base_cfg(tree), "pedestrian").num_tracklets == 0  # no annotations


@pytest.mark.parametrize("key_frame_only", [False, True])
def test_key_frame_filter_equals_jax(tmp_path, key_frame_only):
    make_nuscenes_tree(tmp_path, non_key_frames=(2,))
    cfg = dict(base_cfg(tmp_path), KEY_FRAME_ONLY=key_frame_only)
    ours = nuscenes.NuscenesTrackingDataset(cfg, "car")
    _same_frames(ours.tracklets, jnus.NuscenesTrackingDataset(cfg, "car").tracklets)
    assert [fr["anno"]["frame"] for fr in ours.tracklets[0]] == ([1000, 1001, 1003] if key_frame_only
                                                                  else [1000, 1001, 1002, 1003])


def test_train_and_test_items_equal_jax(tree):
    ours, ref = nuscenes.NuscenesTrackingDataset(base_cfg(tree), "car"), jnus.NuscenesTrackingDataset(base_cfg(tree), "car")
    assert len(ours) == len(ref) == 10
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")
    test_cfg = dict(base_cfg(tree), DATA_SPLIT={"train": "train_track", "test": "train_track"})
    (pcs, boxes, annos), (rpcs, rboxes, rannos) = (ds[0] for ds in (
        nuscenes.NuscenesTrackingDataset(test_cfg, "car", training=False),
        jnus.NuscenesTrackingDataset(test_cfg, "car", training=False)))
    assert len(pcs) == len(rpcs) == 5 and annos == rannos
    for a, b in zip(pcs, rpcs):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(boxes, rboxes):
        np.testing.assert_allclose(a.corners(), b.corners(), rtol=0, atol=BOX_TOL)


def test_database_is_the_ports_own(tree, tmp_path):
    """Numpy arrays and dicts only, under a name of the port's own beside the
    JAX package's, which is never read."""
    for sub in ("v1.0-trainval", "samples"):
        (tmp_path / sub).symlink_to(tree / sub)
    ds = nuscenes.NuscenesTrackingDataset(base_cfg(tmp_path, load_db=True), "car")
    path = ds.database_path()
    assert path.exists() and path.name.endswith("_torch.pkl") and not ds.jax_database_path().exists()

    class NoClasses(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("numpy"):
                return super().find_class(module, name)
            raise pickle.UnpicklingError(f"{module}.{name}")

    with open(path, "rb") as f:
        db = NoClasses(f).load()
    assert [len(t) for t in db["tracklets"]] == [5]
    ds.jax_database_path().write_bytes(b"not a database")
    _same_frames(nuscenes.NuscenesTrackingDataset(base_cfg(tmp_path, load_db=True), "car").tracklets, ds.tracklets)


def test_chip_smoke_tree_reads_back(tmp_path):
    """The agreement tracklets written as a nuScenes release, as chip_smoke.py's
    nuScenes phase writes them, read back by nuscenes_models/ptt.yaml's test
    split as the same clouds and boxes."""
    tracklets = make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 5, "SYNTH_SEED": 11})
    chip_smoke.write_nuscenes_tree(tmp_path, tracklets)
    cfg = dict(config_by_path("tools/cfgs/nuscenes_models/ptt.yaml")["DATA_CONFIG"], DATA_PATH=str(tmp_path))
    ds = nuscenes.NuscenesTrackingDataset(cfg, "trailer", training=False)
    assert len(ds) == 2
    for i, (pcs, boxes, _) in enumerate(tracklets):
        got_pcs, got_boxes, _ = ds[i]
        for a, b in zip(got_pcs, pcs):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got_boxes, boxes):
            np.testing.assert_array_equal(a.corners(), b.corners())
