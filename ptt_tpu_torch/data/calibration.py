"""KITTI tracking calibration (the JAX package's ``data/calibration.py``): the
``P2``, ``R_rect`` and ``Tr_velo_cam`` matrices of a ``calib/<scene>.txt`` file
and the projections between velodyne, reference-camera, rectified-camera and
image coordinates. Label centres are rectified-camera coordinates; LiDAR points
are velodyne coordinates."""

from __future__ import annotations

import numpy as np


def inverse_rigid_trans(tr: np.ndarray) -> np.ndarray:
    """The inverse of a 3x4 rigid transform [R|t]: [R^T | -R^T t]."""
    inv = np.zeros_like(tr)
    inv[0:3, 0:3] = tr[0:3, 0:3].T
    inv[0:3, 3] = -tr[0:3, 0:3].T @ tr[0:3, 3]
    return inv


class Calibration:
    def __init__(self, calib_file):
        data = self._read(calib_file)
        # tracking calib files write "P2:" with a colon, detection files without
        self.P = self._get(data, ["P2:", "P2"]).reshape(3, 4)
        self.V2C = self._get(data, ["Tr_velo_cam", "Tr_velo_to_cam", "Tr_velo_to_cam:"]).reshape(3, 4)
        self.C2V = inverse_rigid_trans(self.V2C)
        self.R0 = self._get(data, ["R_rect", "R0_rect", "R0_rect:"]).reshape(3, 3)

        self.c_u = self.P[0, 2]
        self.c_v = self.P[1, 2]
        self.f_u = self.P[0, 0]
        self.f_v = self.P[1, 1]
        self.b_x = self.P[0, 3] / (-self.f_u)
        self.b_y = self.P[1, 3] / (-self.f_v)

    @staticmethod
    def _get(data, keys):
        for k in keys:
            if k in data:
                return data[k]
        raise KeyError(f"none of {keys} in calib file (has {list(data)})")

    @staticmethod
    def _read(filepath):
        data = {}
        with open(filepath, "r") as f:
            for line in f:
                vals = line.split()
                if not vals:
                    continue
                try:
                    data[vals[0]] = np.array([float(x) for x in vals[1:]])
                except ValueError:
                    continue
        return data

    @staticmethod
    def cart2hom(pts):
        return np.hstack((pts, np.ones((pts.shape[0], 1))))

    # 3d <-> 3d
    def project_velo_to_ref(self, pts_velo):
        return self.cart2hom(pts_velo) @ self.V2C.T

    def project_ref_to_velo(self, pts_ref):
        return self.cart2hom(pts_ref) @ self.C2V.T

    def project_rect_to_ref(self, pts_rect):
        return (np.linalg.inv(self.R0) @ pts_rect.T).T

    def project_ref_to_rect(self, pts_ref):
        return (self.R0 @ pts_ref.T).T

    def project_rect_to_velo(self, pts_rect):
        return self.project_ref_to_velo(self.project_rect_to_ref(pts_rect))

    def project_velo_to_rect(self, pts_velo):
        return self.project_ref_to_rect(self.project_velo_to_ref(pts_velo))

    # 3d -> image
    def project_rect_to_image(self, pts_rect):
        pts_2d = self.cart2hom(pts_rect) @ self.P.T
        pts_2d[:, 0] /= pts_2d[:, 2]
        pts_2d[:, 1] /= pts_2d[:, 2]
        return pts_2d[:, 0:2]

    def project_velo_to_image(self, pts_velo):
        return self.project_rect_to_image(self.project_velo_to_rect(pts_velo))
