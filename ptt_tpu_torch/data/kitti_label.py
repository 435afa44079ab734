"""KITTI tracking label lines as objects (the JAX package's ``data/kitti_label.py``):
one ``Track3d`` per line of a ``label_02`` file, with typed fields, its
camera-frame corners and the KITTI line format. (``data/kitti.py`` parses the
same files into the tracklet dicts it needs.)"""

from __future__ import annotations

import numpy as np

CLS_TYPE_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def cls_type_to_id(cls_type: str) -> int:
    return CLS_TYPE_TO_ID.get(cls_type, -1)


def get_objects_from_label(label_file) -> list:
    with open(label_file) as f:
        return [Track3d(line) for line in f if line.strip()]


class Track3d:
    """One KITTI tracking label line: frame, track id, class, truncation and
    occlusion, 2D box, camera-frame size (h, w, l), bottom-centre location, yaw."""

    def __init__(self, line: str):
        label = line.strip().split(" ")
        self.src = line
        self.frame_id = label[0]
        self.track_id = label[1]
        self.cls_type = label[2]
        self.cls_id = cls_type_to_id(self.cls_type)
        self.truncation = float(label[3])
        self.occlusion = float(label[4])  # 0 visible .. 3 unknown
        self.alpha = float(label[5])
        self.box2d = np.array([float(x) for x in label[6:10]], dtype=np.float32)
        self.h = float(label[10])
        self.w = float(label[11])
        self.l = float(label[12])  # noqa: E741 (KITTI's field name)
        self.loc = np.array([float(x) for x in label[13:16]], dtype=np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.loc))
        self.ry = float(label[16])

    def generate_corners3d(self) -> np.ndarray:
        """(8, 3) camera-frame corners; the label's location is the bottom centre."""
        l, h, w = self.l, self.h, self.w
        x = np.array([l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2])
        y = np.array([0, 0, 0, 0, -h, -h, -h, -h], dtype=np.float64)
        z = np.array([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2])
        c, s = np.cos(self.ry), np.sin(self.ry)
        rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        return (rot @ np.vstack([x, y, z])).T + self.loc

    def to_str(self) -> str:
        return (
            f"{self.cls_type} {self.truncation:.3f} {self.occlusion:.3f} "
            f"{self.alpha:.3f} box2d: {self.box2d} hwl: [{self.h:.3f} {self.w:.3f} "
            f"{self.l:.3f}] pos: {self.loc} ry: {self.ry:.3f}"
        )

    def to_kitti_format(self) -> str:
        b = self.box2d
        return (
            f"{self.cls_type} {self.truncation:.2f} {int(self.occlusion)} "
            f"{self.alpha:.2f} {b[0]:.2f} {b[1]:.2f} {b[2]:.2f} {b[3]:.2f} "
            f"{self.h:.2f} {self.w:.2f} {self.l:.2f} "
            f"{self.loc[0]:.2f} {self.loc[1]:.2f} {self.loc[2]:.2f} {self.ry:.2f}"
        )
