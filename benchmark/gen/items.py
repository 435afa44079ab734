"""Synthetic train items and batches, a frozen copy of the port's
``data/dataset.py`` train item (``TrackingDataset.get_train_item`` with its
Kalman-sampled search offset, canonical crop, labels and fused template), for
the DATA_CONFIG of ``ptt.yaml`` and ``p2b.yaml``, which set no augmentor or
processor and whose point encoder keeps x, y, z as they are.

Item ``index`` draws from ``np.random.default_rng(SeedSequence([seed, index]))``
in the port's order, so the same tracklets, configuration and seed give the
port's items bit for bit.
"""

from __future__ import annotations

import numpy as np

from . import geometry as geo


class TrainItems:
    """The train items of ``tracklets`` (a list of ``(pcs, boxes, annos)``) under
    ``data_cfg``: ``len(self)`` = frames x NUM_CANDIDATES_PERFRAME."""

    def __init__(self, tracklets: list, data_cfg: dict, seed: int):
        self.cfg = data_cfg
        self.seed = int(seed)
        self.num_candidates = int(data_cfg.get("NUM_CANDIDATES_PERFRAME", 4))
        self.use_z = bool(data_cfg.get("USE_Z_AXIS", False))
        self.tracklets = [[{"pc": pc, "box": box} for pc, box, _ in zip(*trk)] for trk in tracklets]
        self.frame_map = [(t, f) for t, trk in enumerate(self.tracklets) for f in range(len(trk))]

    def __len__(self) -> int:
        return len(self.frame_map) * self.num_candidates

    def __getitem__(self, index: int) -> dict:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, int(index)]))
        return self._item(int(index), rng)

    def _item(self, index, rng, depth=0):
        if depth > 50:
            raise RuntimeError("too many degenerate samples")
        tracklet_id, frame_id = self.frame_map[index // self.num_candidates]
        aug_index = index % self.num_candidates
        cur = self.tracklets[tracklet_id][frame_id]
        search = self._search(cur, aug_index, rng)
        if search is None:
            return self._item(int(rng.integers(0, len(self))), rng, depth + 1)
        search_pts, cls_label, reg_label = search
        frames = [self.tracklets[tracklet_id][0], self.tracklets[tracklet_id][max(frame_id - 1, 0)]]
        template = self._template(frames, aug_index, rng)
        if template is None:
            return self._item(int(rng.integers(0, len(self))), rng, depth + 1)
        return {"search_points": np.asarray(search_pts, np.float32),
                "template_points": np.asarray(template, np.float32),
                "cls_label": np.asarray(cls_label, np.float32),
                "reg_label": np.asarray(reg_label, np.float32)}

    def _search(self, frame, aug_index, rng):
        cfg = self.cfg
        offsets = np.zeros(3) if aug_index == 0 else geo.KalmanFiltering(bnd=[1, 1, 5], rng=rng).sample(1)[0]
        sample_box = geo.get_box_by_offset(frame["box"], offsets, self.use_z, rng=rng)
        pts, label, reg = geo.crop_center_pc(
            frame["pc"], sample_box, gt_box=frame["box"], sample_offsets=offsets,
            offset=float(cfg.get("SEARCH_BB_OFFSET", 0.0)), scale=float(cfg.get("SEARCH_BB_SCALE", 1.25)),
            refine_box=bool(cfg.get("REFINE_BOX_SIZE", True)))
        if pts.shape[0] <= 20:
            return None
        return geo.regularize_pc(pts, int(cfg["SEARCH_INPUT_SIZE"]), label=label, reg=reg, rng=rng)

    def _template(self, frames, aug_index, rng):
        cfg = self.cfg
        if aug_index == 0:
            offsets = np.zeros(3)
        else:
            offsets = rng.uniform(low=-0.3, high=0.3, size=3)
            offsets[2] = offsets[2] * 5.0
        boxes = [f["box"] for f in frames]
        boxes[-1] = geo.get_box_by_offset(boxes[-1], offsets, self.use_z, rng=rng)
        template = geo.get_model([f["pc"] for f in frames], boxes, offset=float(cfg.get("MODEL_BB_OFFSET", 0.0)),
                                 scale=float(cfg.get("MODEL_BB_SCALE", 1.25)))
        if template.shape[0] <= 20:
            return None
        return geo.regularize_pc(template, int(cfg["TEMPLATE_INPUT_SIZE"]), rng=rng)


def batch_pool(items: TrainItems, n_batches: int, batch_size: int, seed: int) -> list:
    """``n_batches`` batches of ``batch_size`` distinct items, the item indices
    a permutation drawn from ``seed``: a list of dicts of (B, ...) arrays."""
    need = n_batches * batch_size
    if need > len(items):
        raise ValueError(f"{need} items asked of a set of {len(items)}")
    order = np.random.default_rng(np.random.SeedSequence([int(seed), 7])).permutation(len(items))[:need]
    pool = []
    for b in range(n_batches):
        rows = [items[int(i)] for i in order[b * batch_size:(b + 1) * batch_size]]
        pool.append({key: np.stack([r[key] for r in rows]) for key in rows[0]})
    return pool
