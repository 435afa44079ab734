"""nuScenes scene splits and tracking classes (the JAX package's
``data/nuscenes_splits.py``): the standard public splits (700 train / 150 val /
150 test scenes, with the detect/track halves of train that the BAT and PTT
papers use), kept in ``nuscenes_splits.json`` beside this module, the port's
own copy of the JAX package's file.
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

_SPLITS_JSON = Path(__file__).parent / "nuscenes_splits.json"


@lru_cache(maxsize=1)
def _load() -> dict:
    with open(_SPLITS_JSON) as f:
        return json.load(f)


def create_splits_scenes() -> dict:
    """{'train', 'val', 'test', 'mini_train', 'mini_val', 'train_detect',
    'train_track'} -> list of scene names; checks the 1000 scenes."""
    splits = dict(_load()["scene_splits"])
    all_scenes = splits["train"] + splits["val"] + splits["test"]
    if len(all_scenes) != 1000 or len(set(all_scenes)) != 1000:
        raise ValueError("nuscenes_splits.json: the train, val and test splits are not 1000 distinct scenes")
    return splits


def get_split_scenes(split: str) -> list:
    return create_splits_scenes()[split]


# a tracking class -> the category-name substring its instances are chosen by
TRACKING_TO_GENERAL_CLASS = {
    "car": "vehicle.car",
    "Car": "vehicle.car",
    "truck": "vehicle.truck",
    "bus": "vehicle.bus",
    "trailer": "vehicle.trailer",
    "pedestrian": "human.pedestrian",
    "bicycle": "vehicle.bicycle",
    "motorcycle": "vehicle.motorcycle",
}
