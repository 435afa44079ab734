"""Batched box utilities (the JAX package's ``core/box_utils.py``, a numpy
module copied here; the reference's ptt/utils/box_utils.py:10-280).

Array-of-boxes operations beside the single-Box geometry of ``geometry.py``:
hull membership, batched corners, KITTI camera <-> lidar box conversions
(``calib`` is a ``data/calibration.py`` ``Calibration``), image-plane
projection, range masking, and axis-aligned BEV IoU. All numpy; ``in_hull``
keeps scipy's Delaunay, as the reference did.

Box parametrizations:
  lidar boxes7: [x, y, z, dx(l), dy(w), dz(h), heading] with z at the box CENTER
  camera boxes7: [x, y, z, l, h, w, ry] with y at the box BOTTOM (KITTI labels)
"""

from __future__ import annotations

import numpy as np


def in_hull(p: np.ndarray, hull) -> np.ndarray:
    """Boolean mask of points inside the convex hull of ``hull`` points
    (reference :10-24; Delaunay-based)."""
    from scipy.spatial import Delaunay

    if not isinstance(hull, Delaunay):
        hull = Delaunay(hull)
    return hull.find_simplex(p) >= 0


def boxes_to_corners_3d(boxes3d: np.ndarray) -> np.ndarray:
    """(N, 7) lidar boxes -> (N, 8, 3) corners (reference :27-52 template order):

          7 -------- 4
         /|         /|
        6 -------- 5 .
        | |        | |
        . 3 -------- 0
        |/         |/
        2 -------- 1
    """
    boxes3d = np.asarray(boxes3d, np.float64)
    template = np.array([
        [1, -1, -1], [1, 1, -1], [-1, 1, -1], [-1, -1, -1],
        [1, -1, 1], [1, 1, 1], [-1, 1, 1], [-1, -1, 1],
    ], np.float64) / 2
    corners = boxes3d[:, None, 3:6] * template[None]  # (N, 8, 3)
    corners = rotate_points_along_z_batch(corners, boxes3d[:, 6])
    return corners + boxes3d[:, None, 0:3]


def rotate_points_along_z_batch(points: np.ndarray, angles: np.ndarray) -> np.ndarray:
    """(N, M, 3) rotated per-row by (N,) angles."""
    c, s = np.cos(angles), np.sin(angles)
    zeros, ones = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [c, s, zeros, -s, c, zeros, zeros, zeros, ones], axis=1
    ).reshape(-1, 3, 3)
    return points @ rot


def mask_boxes_outside_range_numpy(boxes: np.ndarray, limit_range, min_num_corners: int = 1):
    """Keep boxes with >= min_num_corners BEV corners inside the range
    (reference :55-71)."""
    corners = boxes_to_corners_3d(boxes)[:, :, :2]
    mask = ((corners >= limit_range[0:2]) & (corners <= limit_range[3:5])).all(axis=2)
    return mask.sum(axis=1) >= min_num_corners


def boxes3d_kitti_camera_to_lidar(boxes3d_camera: np.ndarray, calib) -> np.ndarray:
    """(N, 7) [x, y, z, l, h, w, ry] rect-camera (bottom-center) ->
    (N, 7) [x, y, z, dx, dy, dz, heading] lidar (geometric center)
    (reference :74-90)."""
    boxes3d_camera = np.asarray(boxes3d_camera, np.float64)
    xyz_camera = boxes3d_camera[:, 0:3]
    l, h, w = boxes3d_camera[:, 3:4], boxes3d_camera[:, 4:5], boxes3d_camera[:, 5:6]
    r = boxes3d_camera[:, 6:7]
    xyz_lidar = calib.project_rect_to_velo(xyz_camera)
    xyz_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate([xyz_lidar, l, w, h, -(np.pi / 2 + r)], axis=-1)


def boxes3d_lidar_to_kitti_camera(boxes3d_lidar: np.ndarray, calib) -> np.ndarray:
    """Inverse of the above (reference :143-159)."""
    boxes3d_lidar = np.asarray(boxes3d_lidar, np.float64)
    xyz_lidar = boxes3d_lidar[:, 0:3].copy()
    l, w, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    xyz_lidar[:, 2] -= h[:, 0] / 2
    xyz_cam = calib.project_velo_to_rect(xyz_lidar)
    return np.concatenate([xyz_cam, l, h, w, -(r + np.pi / 2)], axis=-1)


def boxes3d_kitti_fakelidar_to_lidar(boxes3d_lidar: np.ndarray) -> np.ndarray:
    """Legacy [x, y, z_bottom, w, l, h, ry-camera-style] -> standard lidar boxes7
    (reference :93-107)."""
    boxes3d_lidar = np.asarray(boxes3d_lidar, np.float64).copy()
    w, l, h = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    r = boxes3d_lidar[:, 6:7]
    boxes3d_lidar[:, 2] += h[:, 0] / 2
    return np.concatenate(
        [boxes3d_lidar[:, 0:3], l, w, h, -(r + np.pi / 2)], axis=-1
    )


def boxes3d_kitti_lidar_to_fakelidar(boxes3d_lidar: np.ndarray) -> np.ndarray:
    """Inverse legacy conversion (reference :110-124)."""
    boxes3d_lidar = np.asarray(boxes3d_lidar, np.float64).copy()
    dx, dy, dz = boxes3d_lidar[:, 3:4], boxes3d_lidar[:, 4:5], boxes3d_lidar[:, 5:6]
    heading = boxes3d_lidar[:, 6:7]
    boxes3d_lidar[:, 2] -= dz[:, 0] / 2
    return np.concatenate(
        [boxes3d_lidar[:, 0:3], dy, dx, dz, -heading - np.pi / 2], axis=-1
    )


def enlarge_box3d(boxes3d: np.ndarray, extra_width=(0, 0, 0)) -> np.ndarray:
    """Grow each box by per-axis widths (reference :127-140)."""
    out = np.asarray(boxes3d, np.float64).copy()
    out[:, 3:6] += 2 * np.asarray(extra_width, np.float64)
    return out


def boxes3d_kitti_camera_to_imageboxes(boxes3d, calib, image_shape=None) -> np.ndarray:
    """Camera boxes -> (N, 4) [x1, y1, x2, y2] image boxes via corner projection
    (reference :208-228)."""
    boxes3d = np.asarray(boxes3d, np.float64)
    # camera-frame corners (bottom-centered y)
    l, h, w = boxes3d[:, 3], boxes3d[:, 4], boxes3d[:, 5]
    x_c = np.stack([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2], 1)
    y_c = np.stack([np.zeros_like(h)] * 4 + [-h] * 4, 1)
    z_c = np.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], 1)
    ry = boxes3d[:, 6]
    cos, sin = np.cos(ry), np.sin(ry)
    x_r = cos[:, None] * x_c + sin[:, None] * z_c
    z_r = -sin[:, None] * x_c + cos[:, None] * z_c
    corners = np.stack([x_r, y_c, z_r], axis=2) + boxes3d[:, None, 0:3]  # (N, 8, 3)

    pts_img = []
    for corner in corners:
        uvd = calib.cart2hom(corner) @ calib.P.T
        pts_img.append(uvd[:, :2] / uvd[:, 2:3])
    pts_img = np.stack(pts_img)  # (N, 8, 2)
    boxes2d = np.concatenate([pts_img.min(axis=1), pts_img.max(axis=1)], axis=1)
    if image_shape is not None:
        boxes2d[:, [0, 2]] = np.clip(boxes2d[:, [0, 2]], 0, image_shape[1] - 1)
        boxes2d[:, [1, 3]] = np.clip(boxes2d[:, [1, 3]], 0, image_shape[0] - 1)
    return boxes2d


def boxes_iou_normal(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Axis-aligned (N, 4) x (M, 4) IoU matrix (reference :231-251)."""
    boxes_a, boxes_b = np.asarray(boxes_a), np.asarray(boxes_b)
    x_min = np.maximum(boxes_a[:, None, 0], boxes_b[None, :, 0])
    x_max = np.minimum(boxes_a[:, None, 2], boxes_b[None, :, 2])
    y_min = np.maximum(boxes_a[:, None, 1], boxes_b[None, :, 1])
    y_max = np.minimum(boxes_a[:, None, 3], boxes_b[None, :, 3])
    inter = np.clip(x_max - x_min, 0, None) * np.clip(y_max - y_min, 0, None)
    area_a = (boxes_a[:, 2] - boxes_a[:, 0]) * (boxes_a[:, 3] - boxes_a[:, 1])
    area_b = (boxes_b[:, 2] - boxes_b[:, 0]) * (boxes_b[:, 3] - boxes_b[:, 1])
    return inter / np.clip(area_a[:, None] + area_b[None, :] - inter, 1e-6, None)


def boxes3d_lidar_to_aligned_bev_boxes(boxes3d: np.ndarray) -> np.ndarray:
    """Lidar boxes7 -> axis-aligned BEV [x1, y1, x2, y2], rotating dims to the
    nearest axis (reference :254-265)."""
    boxes3d = np.asarray(boxes3d, np.float64)
    rot_angle = np.abs(boxes3d[:, 6] - np.floor(boxes3d[:, 6] / np.pi + 0.5) * np.pi)
    choose_dims = np.where(rot_angle[:, None] < np.pi / 4, boxes3d[:, 3:5], boxes3d[:, [4, 3]])
    return np.concatenate(
        [boxes3d[:, 0:2] - choose_dims / 2, boxes3d[:, 0:2] + choose_dims / 2], axis=-1
    )


def boxes3d_nearest_bev_iou(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Axis-aligned-approximation BEV IoU between lidar box sets (reference :268-280)."""
    return boxes_iou_normal(
        boxes3d_lidar_to_aligned_bev_boxes(boxes_a),
        boxes3d_lidar_to_aligned_bev_boxes(boxes_b),
    )
