"""Point feature encoder (the JAX package's ``data/encoder.py``): keeps the used
feature channels of every ``*points*`` array of an item."""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config: dict):
        if list(config["src_feature_list"])[0:3] != ["x", "y", "z"]:
            raise ValueError("src_feature_list must start with x, y, z")
        self.config = config
        self.used = list(config["used_feature_list"])
        self.src = list(config["src_feature_list"])
        self.num_point_features = len(self.used)

    def forward(self, data_dict: dict) -> dict:
        encoder = getattr(self, self.config["encoding_type"])
        for key, val in list(data_dict.items()):
            if "points" in key:
                data_dict[key] = encoder(val)
        return data_dict

    def absolute_coordinates_encoding(self, points: np.ndarray) -> np.ndarray:
        if points.shape[-1] == 3 and self.used == ["x", "y", "z"]:
            return points
        idx = [self.src.index(f) for f in self.used]
        return points[:, idx]
