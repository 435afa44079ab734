"""Synthetic tracklets: car-like boxes on smooth trajectories, sampled on their
visible faces, with ground and pole clutter around them.

A frozen copy of the port's ``data/synthetic.py`` generator, same numpy draw
order: ``make_tracklets(n, frames, points, clutter, seed)`` gives the same
clouds and boxes as the port's ``make_tracklets`` with SYNTH_SEED = seed. The
eval split draws from ``seed + EVAL_SEED_OFFSET``, the train split from
``seed``.
"""

from __future__ import annotations

import numpy as np

from .geometry import Box, Quaternion

EVAL_SEED_OFFSET = 100003


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
        poles = np.column_stack([np.repeat(pole_xy, 3, axis=0), rng.uniform(0, 2.5, n_pole * 3)])
        pcs.append(np.concatenate([obj_pts, clutter, poles]).astype(np.float32))
        boxes.append(box)
        annos.append({"scene": f"synth{tid:02d}", "frame": f, "track_id": tid})
        heading = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        pos = pos + speed * heading
        yaw = yaw + yaw_rate
    return pcs, boxes, annos


def generate(n_tracklets: int, n_frames: int, n_points: int, n_clutter: int, seed: int) -> list:
    """``n_tracklets`` tracklets from ``np.random.default_rng(seed)``: a list of
    ``(pcs, boxes, annos)``, each frame's cloud (n_points + n_clutter +
    3 * (n_clutter // 10), 3) float32."""
    rng = np.random.default_rng(int(seed))
    return [_make_tracklet(rng, n_frames, n_points, n_clutter, tid) for tid in range(n_tracklets)]


def make_tracklets(n_tracklets: int, n_frames: int, n_points: int, n_clutter: int, seed: int) -> list:
    """The eval split: ``generate`` from ``seed + EVAL_SEED_OFFSET``."""
    return generate(n_tracklets, n_frames, n_points, n_clutter, int(seed) + EVAL_SEED_OFFSET)
