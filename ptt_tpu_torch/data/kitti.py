"""KITTI tracking dataset (the JAX package's ``data/kitti.py``).

A tree ``<DATA_PATH>/training/{velodyne/<scene>/<frame>.bin, label_02/<scene>.txt,
calib/<scene>.txt}``. The scenes of a split (``get_scenes``) are read in name
order; each label file's rows of the class are grouped by ``track_id`` in order
of first appearance and ordered by frame, one tracklet each. A label's centre
(the box's bottom, rectified-camera frame) goes to the velodyne frame and up by
half the height; the box is built in the LiDAR or the camera frame
(``REF_COOR``). Train clouds are cropped to the box padded by
LIDAR_CROP_OFFSET at load; test clouds are whole, one array per (scene, frame)
shared by every tracklet of the scene.

The label files are parsed with plain Python, to the JAX package's columns and
values: int ``frame`` and ``track_id``, str ``type``, float the rest.

With LOAD_FROM_DATABASE the tracklets are kept in a database file under
DATA_PATH, written by the first run and read by the next. It holds numpy arrays
and plain dicts only (a frame's cloud, its box's centre, size and quaternion,
its anno), each shared cloud once, under a name of the port's own: the JAX
package's database file, which holds its own classes, is never read.
"""

from __future__ import annotations

import os
import pickle
from pathlib import Path

import numpy as np

from ..core.geometry import Box, Quaternion, crop_pc
from .calibration import Calibration
from .dataset import TrackingDataset

LABEL_COLUMNS = [
    "frame", "track_id", "type", "truncated", "occluded", "alpha",
    "bbox_left", "bbox_top", "bbox_right", "bbox_bottom",
    "height", "width", "length", "x", "y", "z", "rotation_y",
]
_INT_COLUMNS = ("frame", "track_id")
DATABASE_FORMAT = "ptt_tpu_torch tracklet database 1"


def get_scenes(split: str) -> list:
    """The scene numbers of a split, with the *_TINY debug splits; a name with
    none of TRAIN, VAL, TEST reads every scene."""
    s = split.upper()
    if "TRAIN" in s:
        return [0] if "TINY" in s else list(range(0, 17))
    if "VAL" in s:
        return [3] if "TINY" in s else list(range(17, 19))
    if "TEST" in s:
        return [0] if "TINY" in s else list(range(19, 21))
    return list(range(21))


def read_label_file(path) -> list:
    """The rows of a ``label_02`` file as dicts of LABEL_COLUMNS."""
    rows = []
    with open(path) as f:
        for line in f:
            fields = line.split()
            if not fields:
                continue
            row = {}
            for name, value in zip(LABEL_COLUMNS, fields):
                row[name] = int(value) if name in _INT_COLUMNS else value if name == "type" else float(value)
            rows.append(row)
    return rows


def box_to_arrays(box: Box) -> dict:
    return {"center": box.center, "wlh": box.wlh, "orientation": box.orientation.elements}


def box_from_arrays(d: dict) -> Box:
    return Box(d["center"], d["wlh"], Quaternion(d["orientation"]))


def read_database(path) -> list:
    """The tracklets of a database file written by ``write_database``."""
    with open(path, "rb") as f:
        db = pickle.load(f)
    if not isinstance(db, dict) or db.get("format") != DATABASE_FORMAT:
        raise ValueError(f"{path} is not a {DATABASE_FORMAT!r} file")
    return [[{"pc": fr["pc"], "box": box_from_arrays(fr), "anno": fr["anno"]} for fr in trk] for trk in db["tracklets"]]


def write_database(path, tracklets) -> None:
    """``tracklets`` as numpy arrays and dicts at ``path``, written whole or not
    at all; a cloud shared by several frames is stored once."""
    db = {"format": DATABASE_FORMAT,
          "tracklets": [[dict(pc=fr["pc"], anno=fr["anno"], **box_to_arrays(fr["box"])) for fr in trk]
                        for trk in tracklets]}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(db, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)


class KittiTrackingDataset(TrackingDataset):
    def __init__(self, dataset_cfg: dict, class_names, training: bool = True, root_path=None, logger=None,
                 seed: int = 0):
        super().__init__(dataset_cfg, class_names, training, root_path, logger, seed)
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.root_path = Path(root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        self.root_split_path = self.root_path / "training"
        self.ref_coor = dataset_cfg.get("REF_COOR", "lidar").upper()
        self.preload_offset = float(dataset_cfg.get("LIDAR_CROP_OFFSET", 10.0)) if self.training else -1.0
        self._lidar_cache: dict = {}
        self._calib_cache: dict = {}

        self.per_sequence_anno = self._get_tracklet_annos(get_scenes(self.split))
        if bool(dataset_cfg.get("LOAD_FROM_DATABASE", False)):
            self._load_or_build_database()
        else:
            self.tracklets = [[self._frame_from_anno(a) for a in trk] for trk in self.per_sequence_anno]
        self._lidar_cache.clear()  # the frames hold what they need; the loader's workers get no whole sweeps
        self._finalize()

    def _get_tracklet_annos(self, scene_ids) -> list:
        lidar_path = self.root_split_path / "velodyne"
        label_path = self.root_split_path / "label_02"
        scenes = sorted(p for p in os.listdir(lidar_path) if (lidar_path / p).is_dir() and int(p) in scene_ids)
        tracklets = []
        for scene in scenes:
            by_track: dict = {}
            for row in read_label_file(label_path / f"{scene}.txt"):
                if row["type"] == self.class_names:
                    by_track.setdefault(row["track_id"], []).append(dict(scene=scene, **row))
            tracklets.extend(sorted(rows, key=lambda r: r["frame"]) for rows in by_track.values())
        return tracklets

    def _get_calib(self, scene) -> Calibration:
        if scene not in self._calib_cache:
            self._calib_cache[scene] = Calibration(self.root_split_path / "calib" / f"{scene}.txt")
        return self._calib_cache[scene]

    def _get_box(self, anno) -> Box:
        wlh = [anno["width"], anno["length"], anno["height"]]
        if self.ref_coor == "LIDAR":
            return Box(anno["ctr_in_lidar"], wlh, Quaternion(axis=[0, 0, 1], radians=anno["rotation_y_lidar"]))
        if self.ref_coor == "CAMERA":
            orientation = Quaternion(axis=[0, 1, 0], radians=anno["rotation_y"]) * Quaternion(
                axis=[1, 0, 0], radians=np.pi / 2)
            return Box(anno["ctr_in_camera"], wlh, orientation)
        raise ValueError("REF_COOR must be CAMERA or LIDAR")

    def _get_lidar(self, anno, box) -> np.ndarray:
        key = (anno["scene"], anno["frame"])
        pc = self._lidar_cache.get(key)
        if pc is None:
            lidar_file = self.root_split_path / "velodyne" / anno["scene"] / f"{int(anno['frame']):06}.bin"
            try:
                pts = np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)[:, :3]
            except (OSError, ValueError) as e:
                # as the JAX package: a frame that cannot be read is a 1-point cloud, logged
                self.logger(f"lidar read failed for {lidar_file}: {e}")
                pts = np.zeros((1, 3), dtype=np.float32)
            if self.ref_coor == "CAMERA":
                pts = self._get_calib(anno["scene"]).project_velo_to_ref(pts.astype(np.float64))
            self._lidar_cache[key] = pc = pts
        if self.preload_offset > 0:
            pc = crop_pc(pc, box, offset=self.preload_offset)
        return pc

    def _frame_from_anno(self, anno) -> dict:
        """The frame of a label row: the rectified-camera bottom centre projected
        to the velodyne frame and raised by h/2 to the box's centre."""
        anno = dict(anno)
        calib = self._get_calib(anno["scene"])
        center_lidar = calib.project_rect_to_velo(np.array([anno["x"], anno["y"], anno["z"]]).reshape(1, 3))
        center_lidar[0, 2] += anno["height"] / 2
        anno["ctr_in_camera"] = [anno["x"], anno["y"] - anno["height"] / 2, anno["z"]]
        anno["ctr_in_lidar"] = center_lidar[0].tolist()
        anno["rotation_y_lidar"] = -(np.pi / 2 + anno["rotation_y"])
        box = self._get_box(anno)
        return {"pc": self._get_lidar(anno, box), "box": box, "anno": anno}

    def jax_database_path(self) -> Path:
        """Where the JAX package keeps its database for this dataset (never read here)."""
        parts = self.dataset_cfg["INFO_PATH"][self.mode].split("_")
        prefix = [str(self.class_names), self.dataset_cfg.get("REF_COOR", "lidar"), str(self.preload_offset)]
        return self.root_path / "_".join([parts[0]] + prefix + parts[1:])

    def database_path(self) -> Path:
        jax_path = self.jax_database_path()
        return jax_path.with_name(f"{jax_path.stem}_torch.pkl")

    def _load_or_build_database(self):
        path = self.database_path()
        if path.exists():
            self.logger(f"loading tracklet database from {path}")
            self.tracklets = read_database(path)
            return
        self.logger(f"generating tracklet database at {path}")
        self.tracklets = [[self._frame_from_anno(a) for a in trk] for trk in self.per_sequence_anno]
        write_database(path, self.tracklets)
