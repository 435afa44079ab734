"""Host-side box geometry: the subset of the JAX package's ``core/geometry.py``
(``Quaternion``, ``Box``) that the synthetic data, the evaluator and the metrics
use. Pure numpy, float64, copied so the port imports nothing of ``ptt_tpu``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


class Quaternion:
    """Unit quaternion (w, x, y, z): construction from elements or axis/angle,
    and the rotation matrix."""

    __slots__ = ("q",)

    def __init__(self, elements=None, *, axis=None, angle=None, radians=None):
        if axis is not None:
            theta = float(angle if angle is not None else radians)
            ax = np.asarray(axis, dtype=np.float64)
            n = np.linalg.norm(ax)
            if n == 0:
                raise ValueError("zero axis")
            half = theta / 2.0
            self.q = np.concatenate(([np.cos(half)], np.sin(half) * (ax / n)))
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

    def __repr__(self):
        return f"Quaternion({self.q.tolist()})"


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

    @property
    def rotation_matrix(self) -> np.ndarray:
        return self.orientation.rotation_matrix

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
