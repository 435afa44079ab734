"""The port's training data path, checkpoints and trainer on the CPU: the
train-side geometry and the synthetic train items against the JAX package's
(bit for bit), the loader's batch order, the ptt_synth config against its YAML,
the weight bridge both ways, checkpoint retention and resume, and ``Trainer``
for two tiny epochs with a resume."""

import logging

import numpy as np
import pytest
import torch

from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.core import geometry as jgeo
from ptt_tpu.data.loader import DataLoader as JDataLoader
from ptt_tpu.data.synthetic import SyntheticTrackingDataset as JSynthetic
from ptt_tpu.train.checkpoint import load_variables_npz
from ptt_tpu_torch.config import ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_npz, variables_from_state_dict
from ptt_tpu_torch.core import geometry as geo
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.train.checkpoint import CheckpointManager, save_variables_npz
from ptt_tpu_torch.train.optim import Optimizer
from ptt_tpu_torch.train.trainer import Trainer
from tests.test_torch_port_train import narrow_model_cfg, small_data_cfg

torch.set_num_threads(1)

ASSET = "tests/assets/ptt_synth_trained.npz"
LOG = logging.getLogger("test_torch_port_data")


# --------------------------------------------------------------------- geometry


def _boxes(rng, n):
    out = []
    for _ in range(n):
        center, wlh, yaw = rng.uniform(-10, 10, 3), rng.uniform(1.0, 4.5, 3), rng.uniform(-np.pi, np.pi)
        out.append((geo.Box(center, wlh, geo.Quaternion(axis=[0, 0, 1], angle=yaw)),
                    jgeo.Box(center, wlh, jgeo.Quaternion(axis=[0, 0, 1], angle=yaw))))
    return out


def _cloud_near(rng, box, n=800):
    return (box.center + rng.standard_normal((n, 3)) * box.wlh).astype(np.float32)


def test_geometry_matches_jax(rng):
    for tb, jb in _boxes(rng, 6):
        pts = _cloud_near(rng, tb)
        np.testing.assert_array_equal(geo.rotate_points_along_z(pts, 0.7), jgeo.rotate_points_along_z(pts, 0.7))
        np.testing.assert_array_equal(geo.transform_points(pts, tb.rotation_matrix, tb.center),
                                      jgeo.transform_points(pts, jb.rotation_matrix, jb.center))
        np.testing.assert_array_equal(geo.crop_pc(pts, tb, offset=0.3, scale=1.25),
                                      jgeo.crop_pc(pts, jb, offset=0.3, scale=1.25))
        np.testing.assert_array_equal(geo.points_in_box_label(pts, tb, scale=1.25),
                                      jgeo.points_in_box_label(pts, jb, scale=1.25))
        got = geo.crop_center_pc(pts, tb, gt_box=tb, sample_offsets=[0.2, -0.1, 3.0], scale=1.25)
        ref = jgeo.crop_center_pc(pts, jb, gt_box=jb, sample_offsets=[0.2, -0.1, 3.0], scale=1.25)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(geo.crop_center_pc(pts, tb, scale=1.25, normalize=True),
                                      jgeo.crop_center_pc(pts, jb, scale=1.25, normalize=True))
        np.testing.assert_array_equal(geo.get_model([pts, pts[::2]], [tb, tb], scale=1.25),
                                      jgeo.get_model([pts, pts[::2]], [jb, jb], scale=1.25))
        for use_z in (True, False):
            r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
            a = geo.get_box_by_offset(tb, [2.5, 3.0, 0.4, 12.0], use_z, rng=r1)
            b = jgeo.get_box_by_offset(jb, [2.5, 3.0, 0.4, 12.0], use_z, rng=r2)
            np.testing.assert_array_equal(a.center, b.center)
            np.testing.assert_array_equal(a.orientation.elements, b.orientation.elements)
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        label = np.arange(len(pts), dtype=np.float64)
        for a, b in zip(geo.regularize_pc(pts, 300, label=label, reg=[1.0], rng=r1),
                        jgeo.regularize_pc(pts, 300, label=label, reg=[1.0], rng=r2)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(geo.regularize_pc(np.zeros((2, 3)), 16), jgeo.regularize_pc(np.zeros((2, 3)), 16))
    r1, r2 = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(geo.KalmanFiltering(bnd=[1, 1, 5], rng=r1).sample(4),
                                  jgeo.KalmanFiltering(bnd=[1, 1, 5], rng=r2).sample(4))
    q = geo.Quaternion(axis=[0.2, 0.3, 1.0], angle=1.1)
    jq = jgeo.Quaternion(axis=[0.2, 0.3, 1.0], angle=1.1)
    np.testing.assert_array_equal(geo.Quaternion(matrix=q.rotation_matrix).elements,
                                  jgeo.Quaternion(matrix=jq.rotation_matrix).elements)
    np.testing.assert_array_equal((q * q.inverse).elements, (jq * jq.inverse).elements)


# ------------------------------------------------------------------------ items


def test_synthetic_train_items_equal_jax():
    """The first 16 train items of ptt_synth.yaml's dataset, bit for bit."""
    cfg = ptt_synth_config()["DATA_CONFIG"]
    ours = SyntheticTrackingDataset(cfg, seed=3)
    ref = JSynthetic(cfg, "Car", training=True, seed=3)
    assert len(ours) == len(ref) == 64 * 24 * 4
    for i in range(16):
        a, b = ours[i], ref[i]
        assert a.keys() == b.keys()
        for key in b:
            assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"item {i} {key}")


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_order_equals_jax(shuffle, drop_last):
    """Same seed and epoch -> the same items in the same batches."""
    ds = list(range(23))

    class Items:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            return {"i": np.asarray(ds[i])}

    for epoch in (0, 1, 5):
        a = DataLoader(Items(), 4, shuffle=shuffle, drop_last=drop_last, seed=11, num_workers=2)
        b = JDataLoader(Items(), 4, shuffle=shuffle, drop_last=drop_last, seed=11, num_workers=2)
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        got, ref = [x["i"].tolist() for x in a], [x["i"].tolist() for x in b]
        assert got == ref and len(got) == len(a) == len(b)


# ---------------------------------------------------------------- config, bridge


def test_ptt_synth_config_matches_yaml():
    cfg = cfg_from_yaml_file("tools/cfgs/synthetic_models/ptt_synth.yaml")
    ours = ptt_synth_config()
    for section in ("OPTIMIZATION", "DATA_CONFIG"):
        for key, value in ours[section].items():
            ref = cfg[section][key]
            ref = float(ref) if key == "EPS" else ref  # the YAML loader keeps "1e-06" as a string
            assert value == ref, (section, key)
    assert ours["TRAIN"] == cfg.TRAIN
    assert ours["MODEL"] == cfg.MODEL


def test_weight_bridge_round_trip():
    """asset npz -> state_dict -> npz layout gives back every array."""
    params, batch_stats, _ = load_variables_npz(ASSET)
    back = variables_from_state_dict(state_dict_from_npz(ASSET))
    ref = {f"params/{k}": v for k, v in _flat(params).items()}
    ref.update({f"batch_stats/{k}": v for k, v in _flat(batch_stats).items()})
    assert set(back) == set(ref)
    for key, value in ref.items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


# -------------------------------------------------------------- checkpoints


def test_checkpoint_round_trip_and_retention(tmp_path):
    model = build_network(narrow_model_cfg(), device="cpu", train=True)
    opt = Optimizer(model.parameters(), ptt_synth_config()["OPTIMIZATION"], iters_per_epoch=4)
    for p in opt.params:
        p.grad = torch.ones_like(p)
    opt.step()
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_epoch() is None and mgr.restore(model, opt) == (0, 0)
    for epoch in (1, 2, 3):
        mgr.save(model, opt, epoch, step=4 * epoch)
    assert mgr.epochs() == [2, 3] and mgr.latest_epoch() == 3
    expected = {k: v.clone() for k, v in model.state_dict().items()}
    mu = [m.clone() for m in opt.mu]

    fresh = build_network(narrow_model_cfg(), device="cpu", train=True)
    fresh_opt = Optimizer(fresh.parameters(), ptt_synth_config()["OPTIMIZATION"], iters_per_epoch=4)
    assert CheckpointManager(tmp_path / "ckpt").restore(fresh, fresh_opt) == (3, 12)
    for key, value in fresh.state_dict().items():
        assert torch.equal(value, expected[key]), key
    assert fresh_opt.count == 1 and all(torch.equal(a, b) for a, b in zip(fresh_opt.mu, mu))

    save_variables_npz(tmp_path / "model.npz", fresh, metadata={"epoch": 3})
    with np.load(tmp_path / "model.npz") as data:
        assert int(data["__meta__/epoch"]) == 3
        ref = variables_from_state_dict(fresh.state_dict())
        assert {k for k in data.files if not k.startswith("__meta__")} == set(ref)


# ----------------------------------------------------------------- the trainer


def test_trainer_two_epochs_then_resume(tmp_path):
    """Two tiny epochs on the CPU (4 steps each): finite losses, a checkpoint
    per epoch, the eval hook's best model; then a new Trainer resumes at epoch
    2, step 8, and a third epoch continues from there."""
    data_cfg = dict(small_data_cfg(), NUM_TRACKLETS=2, FRAMES_PER_TRACKLET=2)  # 16 items
    optim_cfg = dict(ptt_synth_config()["OPTIMIZATION"], NUM_EPOCHS=2)
    model_cfg = narrow_model_cfg()

    def make(total_epochs, seen):
        torch.manual_seed(0)
        loader = DataLoader(SyntheticTrackingDataset(data_cfg), 4, shuffle=True, drop_last=True, num_workers=2)
        return Trainer(build_network(model_cfg, device="cpu"), model_cfg, optim_cfg, loader, tmp_path, LOG,
                       total_epochs=total_epochs, max_ckpt_save_num=5, device="cpu",
                       eval_fn=lambda model, epoch: seen.append((epoch, model.training)) or {"succ": float(epoch)})

    seen = []
    trainer = make(2, seen).resume()
    trainer.train()
    assert trainer.accumulated_iter == 8 and trainer.optimizer.count == 8
    assert seen == [(1, False), (2, False)]
    assert trainer.ckpt.epochs() == [1, 2] and (tmp_path / "ckpt_best.npz").exists()
    after_two = {k: v.clone() for k, v in trainer.model.state_dict().items()}

    seen = []
    resumed = make(3, seen).resume()
    assert (resumed.start_epoch, resumed.accumulated_iter) == (2, 8)
    for key, value in resumed.model.state_dict().items():
        assert torch.equal(value, after_two[key]), key
    resumed.train()
    assert resumed.accumulated_iter == 12 and seen == [(3, False)]
    assert resumed.ckpt.latest_epoch() == 3
    assert all(torch.isfinite(p).all() for p in resumed.model.parameters())


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg()), 4, drop_last=True)
    with pytest.raises(RuntimeError):
        Trainer(build_network(narrow_model_cfg(), device="cpu"), narrow_model_cfg(),
                ptt_synth_config()["OPTIMIZATION"], loader, "unused", LOG)
