"""Tracking dataset base (the JAX package's ``data/dataset.py``): its train
items. (The evaluator takes whole tracklets, ``data/synthetic.py``
``make_tracklets``.)

A train item: a Kalman-sampled box offset, the canonical-frame search crop with
per-point in-box labels and the 4-dof regression target, resampled to
SEARCH_INPUT_SIZE; the template, the first and previous frames' crops fused (the
previous box slightly offset), resampled to TEMPLATE_INPUT_SIZE. A degenerate
crop (<= 20 points) retries at a random index. Each item draws from its own
``np.random.Generator`` seeded by ``SeedSequence([seed, index])``, in the JAX
package's order, so both packages give the same items bit for bit.

DATA_AUGMENTOR and DATA_PROCESSOR are not ported (ROADMAP.md).
"""

from __future__ import annotations

import numpy as np

from ..core import geometry as geo
from .encoder import PointFeatureEncoder


class TrackingDataset:
    """Base class. Subclasses fill ``self.tracklets``, a list of tracklets, each
    a list of frame dicts {'pc': (N, 3) float array, 'box': geo.Box, 'anno':
    dict}, then call ``_finalize``."""

    def __init__(self, dataset_cfg: dict, seed: int = 0):
        for key in ("DATA_AUGMENTOR", "DATA_PROCESSOR"):
            if dataset_cfg.get(key):
                raise NotImplementedError(f"DATA_CONFIG.{key} is not ported yet")
        self.dataset_cfg = dataset_cfg
        self.seed = seed
        self.num_candidates_perframe = int(dataset_cfg.get("NUM_CANDIDATES_PERFRAME", 4))
        self.sample_interval = int(dataset_cfg.get("SAMPLED_INTERVAL", 1))
        self.use_z = bool(dataset_cfg.get("USE_Z_AXIS", False))
        pfe_cfg = dataset_cfg.get("POINT_FEATURE_ENCODING")
        self.point_feature_encoder = PointFeatureEncoder(pfe_cfg) if pfe_cfg else None
        self.tracklets: list[list[dict]] = []
        self._frame_map: list[tuple[int, int]] = []

    def _finalize(self):
        self._frame_map = [(t, f) for t, trk in enumerate(self.tracklets) for f in range(len(trk))]

    def __len__(self):
        return len(self._frame_map) * self.num_candidates_perframe // self.sample_interval

    def __getitem__(self, index):
        index *= self.sample_interval
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(index)]))
        item = self.get_train_item(index, rng)
        if self.point_feature_encoder is not None:
            item = self.point_feature_encoder.forward(item)
        return item

    def get_train_item(self, index, rng, _depth=0):
        if _depth > 50:
            raise RuntimeError("too many degenerate samples; dataset looks empty")
        anno_index = index // self.num_candidates_perframe
        aug_index = index % self.num_candidates_perframe
        tracklet_id, frame_id = self._frame_map[anno_index]
        cur = self.tracklets[tracklet_id][frame_id]

        search = self._prepare_search(cur, aug_index, rng)
        if search is None:
            return self.get_train_item(int(rng.integers(0, len(self))), rng, _depth + 1)
        search_pts, cls_label, reg_label = search

        first = self.tracklets[tracklet_id][0]
        prev = self.tracklets[tracklet_id][max(frame_id - 1, 0)]
        template_pts = self._prepare_template([first, prev], aug_index, rng)
        if template_pts is None:
            return self.get_train_item(int(rng.integers(0, len(self))), rng, _depth + 1)

        return {
            "search_points": np.asarray(search_pts, dtype=np.float32),
            "template_points": np.asarray(template_pts, dtype=np.float32),
            "cls_label": np.asarray(cls_label, dtype=np.float32),
            "reg_label": np.asarray(reg_label, dtype=np.float32),
        }

    def _prepare_search(self, frame, aug_index, rng):
        cfg = self.dataset_cfg
        if aug_index == 0:
            offsets = np.zeros(3)
        else:
            offsets = geo.KalmanFiltering(bnd=[1, 1, 5], rng=rng).sample(1)[0]
        sample_box = geo.get_box_by_offset(frame["box"], offsets, self.use_z, rng=rng)
        pts, label, reg = geo.crop_center_pc(
            frame["pc"], sample_box, gt_box=frame["box"], sample_offsets=offsets,
            offset=float(cfg.get("SEARCH_BB_OFFSET", 0.0)), scale=float(cfg.get("SEARCH_BB_SCALE", 1.25)),
            refine_box=bool(cfg.get("REFINE_BOX_SIZE", True)),
        )
        if pts.shape[0] <= 20:
            return None
        return geo.regularize_pc(pts, int(cfg["SEARCH_INPUT_SIZE"]), label=label, reg=reg, rng=rng)

    def _prepare_template(self, frames, aug_index, rng):
        cfg = self.dataset_cfg
        if aug_index == 0:
            offsets = np.zeros(3)
        else:
            offsets = rng.uniform(low=-0.3, high=0.3, size=3)
            offsets[2] = offsets[2] * 5.0
        pcs = [f["pc"] for f in frames]
        boxes = [f["box"] for f in frames]
        boxes[-1] = geo.get_box_by_offset(boxes[-1], offsets, self.use_z, rng=rng)
        template = geo.get_model(pcs, boxes, offset=float(cfg.get("MODEL_BB_OFFSET", 0.0)),
                                 scale=float(cfg.get("MODEL_BB_SCALE", 1.25)))
        if template.shape[0] <= 20:
            return None
        return geo.regularize_pc(template, int(cfg["TEMPLATE_INPUT_SIZE"]), rng=rng)
