"""Tracking metrics, copied from the JAX package's ``eval/metrics.py``: Success
(AUC of 3D IoU over 21 thresholds in [0, 1]) and Precision (AUC of center error
over 21 thresholds in [0, 2 m]), with the BEV intersection as pure-numpy convex
clipping. The 3D IoU keeps the reference's camera-convention vertical extent by
default (``z_axis=False``), like the published numbers.
"""

from __future__ import annotations

import numpy as np


def polygon_area(poly: np.ndarray) -> float:
    """Shoelace area of an (N, 2) polygon (vertices in order)."""
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def polygon_signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def _cross2(u, v) -> float:
    return u[0] * v[1] - u[1] * v[0]


def _line_intersect(p1, p2, a, b):
    """Intersection of segment p1-p2 with the infinite line a-b."""
    d1 = p2 - p1
    d2 = b - a
    denom = d1[0] * d2[1] - d1[1] * d2[0]
    if abs(denom) < 1e-12:
        return p2
    t = ((a[0] - p1[0]) * d2[1] - (a[1] - p1[1]) * d2[0]) / denom
    return p1 + t * d1


def clip_polygon(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman: clip ``subject`` by the convex polygon ``clip``."""
    if polygon_signed_area(clip) < 0:
        clip = clip[::-1]
    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        if not output:
            break
        input_pts = output
        output = []
        prev = input_pts[-1]
        prev_side = _cross2(edge, prev - a)
        for cur in input_pts:
            cur_side = _cross2(edge, cur - a)
            if cur_side >= 0:
                if prev_side < 0:
                    output.append(_line_intersect(prev, cur, a, b))
                output.append(cur)
            elif prev_side >= 0:
                output.append(_line_intersect(prev, cur, a, b))
            prev, prev_side = cur, cur_side
    return np.array(output) if output else np.zeros((0, 2))


def polygon_intersection_area(poly_a: np.ndarray, poly_b: np.ndarray) -> float:
    inter = clip_polygon(poly_a, poly_b)
    if inter.shape[0] < 3:
        return 0.0
    return polygon_area(inter)


def _box_to_bev_polygon(box, ref_coord: str) -> np.ndarray:
    if ref_coord.lower() == "camera":
        return box.corners()[[0, 2]].T[[0, 1, 5, 4]]
    return box.bottom_corners().T[:, :2]


def estimateAccuracy(box_a, box_b, dim: int = 3) -> float:
    """Center L2 error."""
    if dim == 3:
        return float(np.linalg.norm(box_a.center - box_b.center, ord=2))
    return float(np.linalg.norm(box_a.center[[0, 2]] - box_b.center[[0, 2]], ord=2))


def estimateOverlap(box_a, box_b, dim: int = 2, ref_coord: str = "camera",
                    z_axis: bool = False) -> float:
    """2D/3D IoU; ``z_axis=True`` takes the vertical extent along z."""
    if box_a == box_b:
        return 1.0

    poly_a = _box_to_bev_polygon(box_a, ref_coord)
    poly_b = _box_to_bev_polygon(box_b, ref_coord)
    inter_area = polygon_intersection_area(poly_a, poly_b)
    if dim == 2:
        union_area = polygon_area(poly_a) + polygon_area(poly_b) - inter_area
        return inter_area / union_area if union_area > 0 else 0.0

    if z_axis:
        zmax = min(box_a.center[2] + box_a.wlh[2] / 2, box_b.center[2] + box_b.wlh[2] / 2)
        zmin = max(box_a.center[2] - box_a.wlh[2] / 2, box_b.center[2] - box_b.wlh[2] / 2)
        inter_vol = inter_area * max(0.0, zmax - zmin)
    else:
        ymax = min(box_a.center[1], box_b.center[1])
        ymin = max(box_a.center[1] - box_a.wlh[2], box_b.center[1] - box_b.wlh[2])
        inter_vol = inter_area * max(0.0, ymax - ymin)
    vol_a = box_a.wlh[0] * box_a.wlh[1] * box_a.wlh[2]
    vol_b = box_b.wlh[0] * box_b.wlh[1] * box_b.wlh[2]
    return inter_vol / (vol_a + vol_b - inter_vol)


def _trapezoid(y: np.ndarray, x: np.ndarray) -> float:
    # numpy.trapezoid's arithmetic, spelled out: the name differs across numpy
    # versions (trapz before 2.0)
    return float((np.diff(x) * (y[1:] + y[:-1]) / 2.0).sum())


class Success:
    """AUC of the IoU-threshold success curve, in percent."""

    def __init__(self, n: int = 21, max_overlap: float = 1.0):
        self.max_overlap = max_overlap
        self.Xaxis = np.linspace(0, max_overlap, n)
        self.reset()

    def reset(self):
        self.overlaps = []

    def add_overlap(self, val):
        self.overlaps.append(float(val))

    @property
    def count(self):
        return len(self.overlaps)

    @property
    def value(self):
        ov = np.asarray(self.overlaps)
        return np.array([np.mean(ov >= t) for t in self.Xaxis])

    @property
    def average(self):
        if not self.overlaps:
            return 0.0
        return _trapezoid(self.value, self.Xaxis) * 100 / self.max_overlap


class Precision:
    """AUC of the center-error-threshold curve, in percent."""

    def __init__(self, n: int = 21, max_accuracy: float = 2.0):
        self.max_accuracy = max_accuracy
        self.Xaxis = np.linspace(0, max_accuracy, n)
        self.reset()

    def reset(self):
        self.accuracies = []

    def add_accuracy(self, val):
        self.accuracies.append(float(val))

    @property
    def count(self):
        return len(self.accuracies)

    @property
    def value(self):
        acc = np.asarray(self.accuracies)
        return np.array([np.mean(acc <= t) for t in self.Xaxis])

    @property
    def average(self):
        if not self.accuracies:
            return 0.0
        return _trapezoid(self.value, self.Xaxis) * 100 / self.max_accuracy


class Evaluator:
    """Main + per-tracklet accumulators; the context manager resets the
    per-tracklet ones."""

    def __init__(self, ref_coord: str = "lidar", z_axis: bool = False):
        self.ref_coord = ref_coord
        self.z_axis = z_axis
        self.Success_main = Success()
        self.Precision_main = Precision()
        self.Success_batch = Success()
        self.Precision_batch = Precision()

    def update_iou(self, gt_box, pred_box, iou_dims: int = 3):
        overlap = estimateOverlap(
            gt_box, pred_box, dim=iou_dims, ref_coord=self.ref_coord, z_axis=self.z_axis
        )
        accuracy = estimateAccuracy(gt_box, pred_box, dim=iou_dims)
        self.Success_main.add_overlap(overlap)
        self.Precision_main.add_accuracy(accuracy)
        self.Success_batch.add_overlap(overlap)
        self.Precision_batch.add_accuracy(accuracy)
        return overlap, accuracy

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.Success_batch.reset()
        self.Precision_batch.reset()


def merged_main_metrics(evaluator):
    """Global (success, precision, frames) over every process of a group:
    each process's per-frame overlap and accuracy lists gathered
    (``merge_metric_lists``) and the AUCs computed over their union, as the
    JAX package merges them. Under a point group only the group's first rank
    contributes its lists: the others tracked the same frames. With no group:
    the local averages."""
    from ..ops.mesh_ctx import leads
    from ..utils.dist import get_dist_info, merge_metric_lists

    if get_dist_info()[1] == 1:
        return evaluator.Success_main.average, evaluator.Precision_main.average, evaluator.Success_main.count
    s = Success()
    s.overlaps = list(merge_metric_lists(evaluator.Success_main.overlaps, contribute=leads()))
    p = Precision()
    p.accuracies = list(merge_metric_lists(evaluator.Precision_main.accuracies, contribute=leads()))
    return s.average, p.average, s.count
