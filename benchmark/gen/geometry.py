"""Host-side geometry of the benchmark's generators and reference scorer:
``Quaternion``, ``Box``, and the train-side crops, labels, box perturbation,
resampling and offset sampler. Pure numpy, float64. A frozen copy of the
port's ``core/geometry.py`` (same operations in the same order, so the same
inputs and generator give the same bits); the benchmark keeps its own so that
a change to the program cannot change the traffic or the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class Quaternion:
    """Unit quaternion (w, x, y, z): construction from elements or axis/angle,
    and the rotation matrix."""

    __slots__ = ("q",)

    def __init__(self, elements=None, *, axis=None, angle=None, radians=None, matrix=None):
        if matrix is not None:
            self.q = _quat_from_matrix(np.asarray(matrix, dtype=np.float64))
        elif axis is not None:
            theta = float(angle if angle is not None else radians)
            ax = np.asarray(axis, dtype=np.float64)
            n = np.linalg.norm(ax)
            if n == 0:
                raise ValueError("zero axis")
            ax = ax / n
            half = theta / 2.0
            self.q = np.concatenate(([np.cos(half)], np.sin(half) * ax))
        elif elements is not None:
            self.q = np.asarray(elements, dtype=np.float64).reshape(4)
        else:
            self.q = np.array([1.0, 0.0, 0.0, 0.0])

    @property
    def elements(self):
        return self.q

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )

    @property
    def inverse(self):
        conj = self.q * np.array([1.0, -1.0, -1.0, -1.0])
        return Quaternion(conj / np.dot(self.q, self.q))

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion(
            [
                w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            ]
        )

    def __repr__(self):
        return f"Quaternion({self.q.tolist()})"


def _quat_from_matrix(m: np.ndarray) -> np.ndarray:
    """Shepperd's method; accepts a 3x3 (or 4x4 homogeneous) rotation matrix."""
    m = m[:3, :3]
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (m[2, 1] - m[1, 2]) / s
        y = (m[0, 2] - m[2, 0]) / s
        z = (m[1, 0] - m[0, 1]) / s
    elif m[0, 0] > m[1, 1] and m[0, 0] > m[2, 2]:
        s = np.sqrt(1.0 + m[0, 0] - m[1, 1] - m[2, 2]) * 2
        w = (m[2, 1] - m[1, 2]) / s
        x = 0.25 * s
        y = (m[0, 1] + m[1, 0]) / s
        z = (m[0, 2] + m[2, 0]) / s
    elif m[1, 1] > m[2, 2]:
        s = np.sqrt(1.0 + m[1, 1] - m[0, 0] - m[2, 2]) * 2
        w = (m[0, 2] - m[2, 0]) / s
        x = (m[0, 1] + m[1, 0]) / s
        y = 0.25 * s
        z = (m[1, 2] + m[2, 1]) / s
    else:
        s = np.sqrt(1.0 + m[2, 2] - m[0, 0] - m[1, 1]) * 2
        w = (m[1, 0] - m[0, 1]) / s
        x = (m[0, 2] + m[2, 0]) / s
        y = (m[1, 2] + m[2, 1]) / s
        z = 0.25 * s
    q = np.array([w, x, y, z])
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


@dataclass
class Box:
    """3D oriented box: ``center`` (3,), ``wlh`` = (width, length, height),
    ``orientation``. Corners follow the reference convention (x forward along
    the length, y left, z up)."""

    center: np.ndarray
    wlh: np.ndarray
    orientation: Quaternion

    def __post_init__(self):
        self.center = np.array(self.center, dtype=np.float64).reshape(3)
        self.wlh = np.array(self.wlh, dtype=np.float64).reshape(3)

    def copy(self) -> "Box":
        return Box(self.center.copy(), self.wlh.copy(), Quaternion(self.orientation.elements.copy()))

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.orientation.rotation_matrix

    def translate(self, x):
        self.center = self.center + np.asarray(x, dtype=np.float64)
        return self

    def rotate(self, quaternion: Quaternion):
        self.center = quaternion.rotation_matrix @ self.center
        self.orientation = quaternion * self.orientation
        return self

    def corners(self) -> np.ndarray:
        """(3, 8) corner coordinates."""
        w, l, h = self.wlh
        x_c = (l / 2) * np.array([1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
        y_c = (w / 2) * np.array([1, -1, -1, 1, 1, -1, -1, 1], dtype=np.float64)
        z_c = (h / 2) * np.array([1, 1, -1, -1, 1, 1, -1, -1], dtype=np.float64)
        corners = self.orientation.rotation_matrix @ np.vstack((x_c, y_c, z_c))
        return corners + self.center.reshape(3, 1)

    def bottom_corners(self) -> np.ndarray:
        """(3, 4) corners of the bottom face (z-min)."""
        return self.corners()[:, [2, 3, 7, 6]]

    def __eq__(self, other):
        return (
            np.allclose(self.center, other.center)
            and np.allclose(self.wlh, other.wlh)
            and np.allclose(self.orientation.elements, other.orientation.elements)
        )


# ------------------------------------------------------------- train-side crops


def transform_points(points: np.ndarray, rot: np.ndarray | None = None, trans=None) -> np.ndarray:
    """``p' = R p + t`` on (N, 3) points (row vectors)."""
    out = np.asarray(points, dtype=np.float64)
    if rot is not None:
        out = out @ np.asarray(rot).T
    if trans is not None:
        out = out + np.asarray(trans, dtype=np.float64)
    return out


def _aabb_mask(points: np.ndarray, box: Box, offset: float = 0.0, scale: float = 1.0) -> np.ndarray:
    """Inside-mask (open interval) of the axis-aligned bounds of ``box``, scaled
    by ``scale`` and padded by ``offset``."""
    b = box.copy()
    b.wlh = b.wlh * scale
    corners = b.corners()
    maxi = corners.max(axis=1) + offset
    mini = corners.min(axis=1) - offset
    return np.all((points[:, :3] > mini) & (points[:, :3] < maxi), axis=1)


def crop_pc(points: np.ndarray, box: Box, label=None, offset: float = 0.0, scale: float = 1.0):
    """AABB crop around a (scaled, padded) box: the points (and labels) inside."""
    mask = _aabb_mask(points, box, offset=offset, scale=scale)
    new_points = points[mask]
    if label is None:
        return new_points
    return new_points, label[mask]


def points_in_box_label(points: np.ndarray, box: Box, offset: float = 0.0, scale: float = 1.0) -> np.ndarray:
    """Binary in-box labels, computed in the box's canonical frame."""
    rot = box.rotation_matrix.T
    local = transform_points(points[:, :3], trans=-box.center)
    local = local @ rot.T

    b = box.copy()
    b.translate(-box.center)
    b.rotate(Quaternion(matrix=rot))
    b.wlh = b.wlh * scale
    corners = b.corners()
    maxi = corners.max(axis=1) + offset
    mini = corners.min(axis=1) - offset
    inside = np.all((local > mini) & (local < maxi), axis=1)
    return inside.astype(np.float64)


def normalize_points(points: np.ndarray, wlh) -> np.ndarray:
    """Divide (N, 3) points axis-wise by the box extent in the canonical
    frame's order (x = l, y = w, z = h)."""
    wlh = np.asarray(wlh, dtype=np.float64).reshape(3)
    return np.asarray(points, dtype=np.float64) / np.array([wlh[1], wlh[0], wlh[2]])


def crop_center_pc(points: np.ndarray, sample_box: Box, gt_box: Box | None = None, sample_offsets=None,
                   offset: float = 0.0, scale: float = 1.0, refine_box: bool = True,
                   normalize: bool = False):
    """Crop the search region around ``sample_box`` in the box's canonical
    frame: a loose AABB pre-crop (offset * 2, scale * 4), the rigid transform,
    then a tight crop, with ``gt_box.wlh[1] * 0.6`` extra slack when a
    ground-truth box is given. With ``gt_box``, also the per-point in-box labels
    and the regression target [cx, cy, cz, -theta_offset_deg]."""
    pts = crop_pc(points, sample_box, offset=2 * offset, scale=4 * scale)
    box = sample_box.copy()

    label = reg = None
    if gt_box is not None:
        label = points_in_box_label(pts, gt_box, offset=offset if refine_box else 0.0,
                                    scale=scale if refine_box else 1.0)

    rot = box.rotation_matrix.T
    trans = -box.center
    pts = transform_points(pts, trans=trans)
    pts = pts @ rot.T
    box.translate(trans)
    box.rotate(Quaternion(matrix=rot))

    if gt_box is not None:
        pts, label = crop_pc(pts, box, label, offset=offset + gt_box.wlh[1] * 0.6, scale=scale)
        gt_local = gt_box.copy()
        gt_local.translate(trans)
        gt_local.rotate(Quaternion(matrix=rot))
        if sample_offsets is not None:
            reg = np.array([gt_local.center[0], gt_local.center[1], gt_local.center[2], -sample_offsets[-1]])
        if normalize:
            pts = normalize_points(pts, sample_box.wlh)
        return pts, label, reg
    pts = crop_pc(pts, box, offset=offset, scale=scale)
    if normalize:
        pts = normalize_points(pts, sample_box.wlh)
    return pts


def get_model(pcs, boxes, offset: float = 0.0, scale: float = 1.0):
    """Fuse the crops of several frames, each in its own box's canonical frame,
    into one template cloud."""
    if len(pcs) == 0:
        return np.zeros((0, 3))
    parts = []
    for pc, box in zip(pcs, boxes):
        cropped = crop_center_pc(pc, box, offset=offset, scale=scale)
        if cropped.shape[0] > 0:
            parts.append(cropped)
    if not parts:
        return np.zeros((0, 3))
    return np.concatenate(parts, axis=0)


def get_box_by_offset(box: Box, offset, use_z: bool = False, rng: np.random.Generator | None = None) -> Box:
    """Perturb ``box`` by (x, y, z[, theta]) in its canonical frame; ``offset[-1]``
    is an angle in degrees. Offsets larger than the box extent are redrawn
    uniform(-1, 1)."""
    offset = np.array(offset, dtype=np.float64)
    rot_quat = Quaternion(matrix=box.rotation_matrix)
    trans = np.array(box.center)

    new_box = box.copy()
    new_box.translate(-trans)
    new_box.rotate(rot_quat.inverse)

    new_box.rotate(Quaternion(axis=[0, 0, 1], angle=np.deg2rad(offset[-1])))
    _uniform = rng.uniform if rng is not None else np.random.uniform
    if offset[0] > new_box.wlh[0]:
        offset[0] = _uniform(-1, 1)
    if offset[1] > min(new_box.wlh[1], 2):
        offset[1] = _uniform(-1, 1)

    new_box.translate(np.array([offset[0], offset[1], offset[2] if use_z else 0.0]))
    new_box.rotate(rot_quat)
    new_box.translate(trans)
    return new_box


def regularize_pc(points: np.ndarray, input_size: int, label=None, reg=None, istrain: bool = True,
                  rng: np.random.Generator | None = None, seed_for_test: int = 1):
    """Resample (N, C) points to exactly ``input_size`` rows, uniform with
    replacement from ``rng`` (the global numpy RNG, reseeded on the test path,
    without one); with <= 2 points, an all-zeros cloud."""
    points = np.asarray(points, dtype=np.float32)
    n, c = points.shape
    if input_size <= 0:
        return points if label is None else (points, label, reg)

    if n > 2:
        if n != input_size:
            if rng is None:
                if not istrain:
                    np.random.seed(seed_for_test)
                idx = np.random.randint(0, n, size=input_size)
            else:
                idx = rng.integers(0, n, size=input_size)
            points = points[idx]
            if label is not None:
                label = label[idx]
    else:
        points = np.zeros((input_size, c), dtype=np.float32)
        if label is not None:
            label = np.zeros(input_size)
    return points if label is None else (points, label, reg)


class KalmanFiltering:
    """Gaussian offset sampler with score-weighted adaptation."""

    def __init__(self, bnd=None, rng: np.random.Generator | None = None):
        self.bnd = [1, 1, 10] if bnd is None else bnd
        self.rng = rng
        self.reset()

    def sample(self, n=10):
        if self.rng is not None:
            return self.rng.multivariate_normal(self.mean, self.cov, size=n)
        return np.random.multivariate_normal(self.mean, self.cov, size=n)

    def addData(self, data, score):
        score = score.clip(min=1e-5)
        self.data = np.concatenate((self.data, data))
        self.score = np.concatenate((self.score, score))
        self.mean = np.average(self.data, weights=self.score, axis=0)
        self.cov = np.cov(self.data.T, ddof=0, aweights=self.score)

    def reset(self):
        self.mean = np.zeros(len(self.bnd))
        self.cov = np.diag(self.bnd)
        self.data = np.zeros((0, len(self.bnd)))
        self.score = np.array([])
