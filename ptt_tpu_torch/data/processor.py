"""The point processor queue of DATA_PROCESSOR (the JAX package's
``data/processor.py``), run on a train item's ``search_points`` and
``template_points`` (the per-point ``cls_label`` follows the search points) with
the item's own generator:

  shuffle_points: a random permutation, where SHUFFLE_ENABLED[mode] says so;
  sample_points:  resample to NUM_POINTS[mode]; when there are too many points,
                  those nearer than 40 m are subsampled first, so that the
                  sparse far points are kept.
"""

from __future__ import annotations

from functools import partial

import numpy as np

POINT_KEYS = ("search_points", "template_points")


class DataProcessor:
    def __init__(self, processor_configs, training: bool, point_keys=POINT_KEYS):
        self.training = training
        self.mode = "train" if training else "test"
        self.point_keys = point_keys
        self.queue = [getattr(self, cfg["NAME"])(config=cfg) for cfg in processor_configs]

    def _map_points(self, data_dict, fn, rng):
        for key in self.point_keys:
            if key in data_dict:
                label = data_dict.get("cls_label") if key == "search_points" else None
                pts, label = fn(np.asarray(data_dict[key]), label, rng)
                data_dict[key] = pts
                if label is not None:
                    data_dict["cls_label"] = label
        return data_dict

    def shuffle_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if not config["SHUFFLE_ENABLED"][self.mode]:
            return data_dict

        def _shuffle(pts, label, rng):
            idx = rng.permutation(pts.shape[0])
            return pts[idx], (label[idx] if label is not None else None)

        return self._map_points(data_dict, _shuffle, rng)

    def sample_points(self, data_dict=None, config=None, rng=None):
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config["NUM_POINTS"][self.mode]
        if num_points == -1:
            return data_dict

        def _sample(pts, label, rng):
            n = len(pts)
            if num_points < n:
                depth = np.linalg.norm(pts[:, 0:3], axis=1)
                near = np.where(depth < 40.0)[0]
                far = np.where(depth >= 40.0)[0]
                if num_points > len(far):
                    near_pick = rng.choice(near, num_points - len(far), replace=False)
                    choice = np.concatenate([near_pick, far]) if len(far) else near_pick
                else:
                    choice = rng.choice(np.arange(n), num_points, replace=False)
            else:
                choice = np.arange(n, dtype=np.int64)
                if num_points > n:
                    extra = rng.choice(choice, num_points - n, replace=n < num_points - n)
                    choice = np.concatenate([choice, extra])
            rng.shuffle(choice)
            return pts[choice], (label[choice] if label is not None else None)

        return self._map_points(data_dict, _sample, rng)

    def forward(self, data_dict: dict, rng: np.random.Generator) -> dict:
        for proc in self.queue:
            data_dict = proc(data_dict=data_dict, rng=rng)
        return data_dict
