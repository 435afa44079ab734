"""Synthetic tracklets: car-like boxes on smooth trajectories, sampled on their
visible faces, with ground and pole clutter around them.

A copy of the JAX package's ``data/synthetic.py`` generator with the same numpy
draw order, so the same config and seed give the same clouds and boxes bit for
bit. ``make_tracklets`` returns the eval split as the evaluator consumes it, a
list of ``(pcs, boxes, annos)`` per tracklet; ``SyntheticTrackingDataset``
serves the train split's items to the trainer, or with ``training=False`` the
eval split's tracklets as test items.
"""

from __future__ import annotations

import numpy as np

from ..core.geometry import Box, Quaternion
from .dataset import TrackingDataset

# the eval split draws from a disjoint stream (the JAX dataset's test offset)
_EVAL_SEED_OFFSET = 100003


def _sample_box_surface(rng, box: Box, n: int) -> np.ndarray:
    """~n points on the two sides, the back and the top of an oriented box."""
    w, l, h = box.wlh
    fracs = np.array([0.35, 0.35, 0.15, 0.15])
    counts = (fracs * n).astype(int)
    counts[0] += n - counts.sum()
    pts = []
    for sgn, c in zip((1, -1), counts[:2]):
        x = rng.uniform(-l / 2, l / 2, c)
        z = rng.uniform(-h / 2, h / 2, c)
        y = np.full(c, sgn * w / 2) + rng.normal(0, 0.02, c)
        pts.append(np.stack([x, y, z], axis=1))
    c = counts[2]
    y = rng.uniform(-w / 2, w / 2, c)
    z = rng.uniform(-h / 2, h / 2, c)
    x = np.full(c, -l / 2) + rng.normal(0, 0.02, c)
    pts.append(np.stack([x, y, z], axis=1))
    c = counts[3]
    x = rng.uniform(-l / 2, l / 2, c)
    y = rng.uniform(-w / 2, w / 2, c)
    z = np.full(c, h / 2) + rng.normal(0, 0.02, c)
    pts.append(np.stack([x, y, z], axis=1))

    local = np.concatenate(pts, axis=0)
    return local @ box.rotation_matrix.T + box.center


def _make_tracklet(rng, n_frames, n_pts, n_clutter, tid):
    wlh = np.array([1.8, 4.4, 1.6]) * rng.uniform(0.9, 1.1, 3)
    pos = rng.uniform(-15, 15, 3)
    pos[2] = wlh[2] / 2
    yaw = rng.uniform(-np.pi, np.pi)
    speed = rng.uniform(0.3, 1.2)
    yaw_rate = rng.uniform(-0.05, 0.05)

    pcs, boxes, annos = [], [], []
    for f in range(n_frames):
        box = Box(pos.copy(), wlh.copy(), Quaternion(axis=[0, 0, 1], angle=yaw))
        obj_pts = _sample_box_surface(rng, box, n_pts)
        cl_xy = box.center[:2] + rng.uniform(-8, 8, (n_clutter, 2))
        cl_z = np.abs(rng.normal(0, 0.05, n_clutter))
        clutter = np.column_stack([cl_xy, cl_z])
        n_pole = n_clutter // 10
        pole_xy = box.center[:2] + rng.uniform(-6, 6, (n_pole, 2))
        poles = np.column_stack(
            [np.repeat(pole_xy, 3, axis=0), rng.uniform(0, 2.5, n_pole * 3)]
        )
        pcs.append(np.concatenate([obj_pts, clutter, poles]).astype(np.float32))
        boxes.append(box)
        annos.append({"scene": f"synth{tid:02d}", "frame": f, "track_id": tid})
        heading = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        pos = pos + speed * heading
        yaw = yaw + yaw_rate
    return pcs, boxes, annos


def _generate(data_cfg: dict, seed_offset: int) -> list:
    n_trk = int(data_cfg.get("NUM_TRACKLETS", 4))
    n_frames = int(data_cfg.get("FRAMES_PER_TRACKLET", 12))
    n_pts = int(data_cfg.get("POINTS_PER_FRAME", 600))
    n_clutter = int(data_cfg.get("CLUTTER_POINTS", 400))
    rng = np.random.default_rng(int(data_cfg.get("SYNTH_SEED", 1234)) + seed_offset)
    return [_make_tracklet(rng, n_frames, n_pts, n_clutter, tid) for tid in range(n_trk)]


class SyntheticTrackingDataset(TrackingDataset):
    """The tracklets of ``dataset_cfg`` (optional keys NUM_TRACKLETS,
    FRAMES_PER_TRACKLET, POINTS_PER_FRAME, CLUTTER_POINTS, SYNTH_SEED): the
    train split as train items, or the eval split as test items."""

    def __init__(self, dataset_cfg: dict, class_names="Car", training: bool = True, root_path=None, logger=None,
                 seed: int = 0):
        super().__init__(dataset_cfg, class_names, training, root_path, logger, seed)
        tracklets = _generate(dataset_cfg, 0 if training else _EVAL_SEED_OFFSET)
        self.tracklets = [[{"pc": pc, "box": box, "anno": anno} for pc, box, anno in zip(*trk)]
                          for trk in tracklets]
        self._finalize()


def make_tracklets(data_cfg: dict) -> list:
    """Eval-split tracklets for the optional config keys NUM_TRACKLETS,
    FRAMES_PER_TRACKLET, POINTS_PER_FRAME, CLUTTER_POINTS and SYNTH_SEED.
    Returns a list of ``(pcs, boxes, annos)``, one per tracklet."""
    return _generate(data_cfg, _EVAL_SEED_OFFSET)
