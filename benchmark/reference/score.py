"""The reference scorer: Success (the area under the curve of the share of
frames whose 3D IoU with the ground truth reaches each of 21 thresholds in
[0, 1]) and Precision (the same over the center error, 21 thresholds in
[0, 2 m]), both in percent, as the published PTT / P2B evaluation defines
them, including its vertical-extent quirk (the overlap's height taken from
center[1] and h, ``z_axis`` False) and its shortcut for boxes that are equal
within ``np.allclose``. The bird's-eye overlap is a Sutherland-Hodgman clip of
the two footprints (lidar: the bottom face's x-y corners; camera: corners 0,
1, 5, 4 in x-z), in float64.

A predicted box keeps the first frame's size, as the tracker predicts only
center and yaw. In lidar coordinates the scorer takes both boxes as the
published evaluation's batched scorer does, as float32 [x, y, z, w, l, h,
yaw] rows (so the first frame, the given box, scores an error of exactly 0);
in camera coordinates the ground truth as it is. Imports numpy only.
"""

from __future__ import annotations

import numpy as np

from ..gen.geometry import Box, Quaternion

THRESHOLDS = 21


def _area(poly) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _signed(poly) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _cross(u, v):
    return u[0] * v[1] - u[1] * v[0]


def _meet(p1, p2, a, b):
    d1, d2 = p2 - p1, b - a
    den = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(den) < 1e-12:
        return p2
    return p1 + ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / den * d1


def _clip(subject, clip):
    if _signed(clip) < 0:
        clip = clip[::-1]
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        if not out:
            break
        inp, out = out, []
        prev = inp[-1]
        prev_side = _cross(b - a, prev - a)
        for cur in inp:
            side = _cross(b - a, cur - a)
            if side >= 0:
                if prev_side < 0:
                    out.append(_meet(prev, cur, a, b))
                out.append(cur)
            elif prev_side >= 0:
                out.append(_meet(prev, cur, a, b))
            prev, prev_side = cur, side
    return np.array(out) if out else np.zeros((0, 2))


def _footprint(box: Box, ref_coord: str):
    if ref_coord == "camera":
        return box.corners()[[0, 2]].T[[0, 1, 5, 4]]
    return box.bottom_corners().T[:, :2]


def overlap(a: Box, b: Box, ref_coord: str) -> float:
    if a == b:
        return 1.0
    pa, pb = _footprint(a, ref_coord), _footprint(b, ref_coord)
    inter = _clip(pa, pb)
    area = _area(inter) if inter.shape[0] >= 3 else 0.0
    top = min(a.center[1], b.center[1])
    bottom = max(a.center[1] - a.wlh[2], b.center[1] - b.wlh[2])
    vol = area * max(0.0, top - bottom)
    return vol / (np.prod(a.wlh) + np.prod(b.wlh) - vol)


def _float32_box(box: Box) -> Box:
    yaw = np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0])
    return Box(np.asarray(box.center, np.float32).astype(np.float64),
               np.asarray(box.wlh, np.float32).astype(np.float64),
               Quaternion(axis=[0, 0, 1], radians=float(np.float32(yaw))))


def frame_scores(gt_boxes, pred: np.ndarray, ref_coord: str):
    """(overlaps, center errors) of one tracklet's (T, 4) predicted
    [cx, cy, cz, yaw] against its ground-truth ``Box``es."""
    ref_coord = ref_coord.lower()
    wlh = np.asarray(gt_boxes[0].wlh, np.float64)
    if ref_coord == "lidar":
        wlh = wlh.astype(np.float32).astype(np.float64)
        gt_boxes = [_float32_box(g) for g in gt_boxes]
    ious, errs = [], []
    for gt, p in zip(gt_boxes, pred):
        box = Box(np.asarray(p[:3], np.float64), wlh, Quaternion(axis=[0, 0, 1], radians=float(p[3])))
        ious.append(overlap(gt, box, ref_coord))
        errs.append(float(np.linalg.norm(gt.center - box.center)))
    return np.asarray(ious), np.asarray(errs)


def auc(values: np.ndarray, top: float, at_least: bool) -> float:
    """The area under the share-of-frames curve over THRESHOLDS thresholds in
    [0, top], in percent of the largest area."""
    x = np.linspace(0, top, THRESHOLDS)
    y = np.array([np.mean(values >= t) if at_least else np.mean(values <= t) for t in x])
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum()) * 100 / top


def success_precision(ious: np.ndarray, errs: np.ndarray):
    return auc(ious, 1.0, True), auc(errs, 2.0, False)
