"""nuScenes tracking dataset (the JAX package's ``data/nuscenes.py``), without
the nuScenes devkit: a release is a set of JSON tables (scene, sample,
sample_data, sample_annotation, instance, ego_pose, calibrated_sensor,
category, log) under ``<DATA_PATH>/<VERSION>/``; ``NuscenesTables`` loads and
indexes them by token.

A tracklet is one instance of the class's category (``TRACKING_TO_GENERAL_CLASS``)
followed along its annotations' ``next`` chain, keeping the annotations whose
scene is in the split and that hold at least INIT_POINTS_THRESHOLD lidar
points; with KEY_FRAME_ONLY an annotation whose LIDAR_TOP sweep is not a key
frame is skipped. A frame's cloud is its LIDAR_TOP sweep moved from the
sensor to the global frame (sensor -> ego -> global), cropped in training to
the box padded by LIDAR_CROP_OFFSET.

With LOAD_FROM_DATABASE the tracklets are kept in a database file under
DATA_PATH, in the port's own format (``kitti.write_database``: numpy arrays
and dicts), beside the name the JAX package gives its own database file,
which is never read.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from ..core.geometry import Box, Quaternion, crop_pc
from .dataset import TrackingDataset
from .kitti import read_database, write_database
from .nuscenes_splits import TRACKING_TO_GENERAL_CLASS, get_split_scenes


class NuscenesTables:
    """The JSON tables of one nuScenes version directory, indexed by token."""

    TABLES = ("scene", "sample", "sample_data", "sample_annotation", "instance", "ego_pose",
              "calibrated_sensor", "category", "log")

    def __init__(self, dataroot, version: str):
        self.dataroot = Path(dataroot)
        table_dir = self.dataroot / version
        if not table_dir.exists():
            raise FileNotFoundError(f"nuScenes tables not found at {table_dir}")
        self._tables, self._index = {}, {}
        for name in self.TABLES:
            with open(table_dir / f"{name}.json") as f:
                rows = json.load(f)
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    def table(self, table: str) -> list:
        return self._tables[table]


def transform_matrix(translation, rotation_wxyz, inverse: bool = False) -> np.ndarray:
    """The 4 x 4 pose of a translation and a (w, x, y, z) rotation, or its inverse."""
    tm = np.eye(4)
    rot = Quaternion(rotation_wxyz).rotation_matrix
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = -rot.T @ np.array(translation)
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = np.array(translation)
    return tm


class NuscenesTrackingDataset(TrackingDataset):
    def __init__(self, dataset_cfg: dict, class_names, training: bool = True, root_path=None, logger=None,
                 seed: int = 0):
        super().__init__(dataset_cfg, class_names, training, root_path, logger, seed)
        self.root_path = Path(root_path if root_path is not None else dataset_cfg["DATA_PATH"])
        self.version = dataset_cfg.get("VERSION", "v1.0-trainval")
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.key_frame_only = bool(dataset_cfg.get("KEY_FRAME_ONLY", False))
        self.min_points = int(dataset_cfg.get("INIT_POINTS_THRESHOLD", 1))
        self.preload_offset = float(dataset_cfg.get("LIDAR_CROP_OFFSET", 10.0)) if self.training else -1.0

        use_db = bool(dataset_cfg.get("LOAD_FROM_DATABASE", False))
        if use_db and self.database_path().exists():
            self.logger(f"loading tracklet database from {self.database_path()}")
            self.tracklets = read_database(self.database_path())
        else:
            self.nusc = NuscenesTables(self.root_path, self.version)
            self.tracklets = [[self._frame_from_anno(a) for a in trk] for trk in self._collect_tracklet_annos()]
            if use_db:
                self.logger(f"generating tracklet database at {self.database_path()}")
                write_database(self.database_path(), self.tracklets)
        self._finalize()

    def jax_database_path(self) -> Path:
        """Where the JAX package keeps its database for this dataset (never read
        here): the class, the crop offset, the split and, with KEY_FRAME_ONLY,
        'kf' ride the name, so that a database of other tracklets is not served."""
        parts = self.dataset_cfg["INFO_PATH"][self.mode].split("_")
        prefix = [str(self.class_names), str(self.preload_offset), self.split] + (["kf"] if self.key_frame_only else [])
        return self.root_path / "_".join([parts[0]] + prefix + parts[1:])

    def database_path(self) -> Path:
        jax_path = self.jax_database_path()
        return jax_path.with_name(f"{jax_path.stem}_torch.pkl")

    def _collect_tracklet_annos(self) -> list:
        scene_names = set(get_split_scenes(self.split))
        general_class = TRACKING_TO_GENERAL_CLASS.get(self.class_names, self.class_names)
        tracklets = []
        for instance in self.nusc.table("instance"):
            if general_class not in self.nusc.get("category", instance["category_token"])["name"]:
                continue
            chain = []
            token = instance["first_annotation_token"]
            while token:
                anno = self.nusc.get("sample_annotation", token)
                token = anno["next"]
                sample = self.nusc.get("sample", anno["sample_token"])
                if self.key_frame_only and not self.nusc.get(
                        "sample_data", sample["data"]["LIDAR_TOP"]).get("is_key_frame", True):
                    continue
                scene = self.nusc.get("scene", sample["scene_token"])
                if scene["name"] in scene_names and anno["num_lidar_pts"] >= self.min_points:
                    chain.append(anno)
            if len(chain) >= 2:
                tracklets.append(chain)
        return tracklets

    def _frame_from_anno(self, anno) -> dict:
        sample = self.nusc.get("sample", anno["sample_token"])
        pc = self._load_lidar_global(self.nusc.get("sample_data", sample["data"]["LIDAR_TOP"]))
        box = Box(np.array(anno["translation"]), np.array(anno["size"]), Quaternion(anno["rotation"]))  # size is (w, l, h)
        if self.preload_offset > 0:
            pc = crop_pc(pc, box, offset=self.preload_offset)
        return {"pc": pc.astype(np.float32), "box": box,
                "anno": {"scene": self.nusc.get("scene", sample["scene_token"])["name"],
                         "frame": sample["timestamp"], "track_id": anno["instance_token"]}}

    def _load_lidar_global(self, sample_data) -> np.ndarray:
        """A LIDAR_TOP sweep (x, y, z, intensity, ring float32 rows) in the global frame."""
        scan = np.fromfile(str(self.root_path / sample_data["filename"]), dtype=np.float32).reshape(-1, 5)[:, :3]
        cs = self.nusc.get("calibrated_sensor", sample_data["calibrated_sensor_token"])
        ego = self.nusc.get("ego_pose", sample_data["ego_pose_token"])
        tm = transform_matrix(ego["translation"], ego["rotation"]) @ transform_matrix(cs["translation"], cs["rotation"])
        return scan @ tm[:3, :3].T + tm[:3, 3]
