"""Device-resident tracking (the JAX package's ``eval/device_loop.py``): a batch of
tracklets is uploaded once, and the autoregressive per-frame loop (crop,
resample, PTT forward, best proposal, box decode) runs on the device. Only the
(B, T, 4) predicted boxes come back for scoring.

The JAX package compiles the loop into one ``lax.scan``; here it is a Python
loop over frames that enqueues device work and never waits for it, so the
host reads nothing until ``finish_batch``. Every primitive is batched over a
leading tracklet axis. All modes of the JAX tracker run:
``TEST.REF_BOX`` ``previous_result`` (deployment) and the ``previous_gt`` /
``current_gt`` diagnostics, which crop and decode around the ground truth
while the template follows the predicted trajectory; and
``TEST.SHAPE_AGGREGATION`` ``firstandprevious``, ``first``, ``previous`` and
``all`` (the crops of every earlier frame around its predicted box, one
resample over their union).

Resampling draws its picks from a ``torch.Generator`` (``uniform_picks``), so
the stream differs from the JAX tracker's; ``masked_resample`` also takes
explicit ``picks``. It picks the same rows from the same picks as the JAX
package's ``masked_resample`` and ``masked_resample_long``, with one prefix-sum
path for every row length. The evaluator reseeds its generator at every
dispatch, as the JAX evaluator derives its keys from its seed at every
dispatch, so a batch's boxes depend only on the seed and the batch.
"""

from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from .. import resolve_device
from ..core import geometry as geo
from .evaluator import (RESULT_FILE, aggregation_mode, anno_scene_frame, ref_box_mode, result_line,
                        save_candidate_pcd)
from .metrics import Evaluator

QUANT_SCALE = 1.0 / 256.0  # int16 fixed-point grid for the upload: 3.9 mm, range +-128 m
FRAME_BUCKET = 32  # tracklet lengths are padded to a multiple of this


def _rot_z(yaw: torch.Tensor) -> torch.Tensor:
    """(B,) -> (B, 3, 3) rotation about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack(
        [torch.stack([c, -s, zero], -1), torch.stack([s, c, zero], -1), torch.stack([zero, zero, one], -1)],
        -2,
    )


def crop_canonical(pts, valid, box_vec, wlh, offset, scale: float):
    """Points in the box's canonical frame and the mask of those inside the
    scaled box's AABB there. pts (B, N, 3), valid (B, N) bool, box_vec (B, 4) =
    [cx, cy, cz, yaw], wlh (B, 3), offset a float or (B,) -> (canon (B, N, 3),
    mask (B, N))."""
    canon = torch.matmul(pts - box_vec[:, None, :3], _rot_z(box_vec[:, 3]))
    offset = torch.as_tensor(offset, dtype=pts.dtype, device=pts.device).reshape(-1, 1)
    w, l, h = wlh.unbind(-1)
    half = torch.stack([l / 2 * scale, w / 2 * scale, h / 2 * scale], -1) + offset  # (B, 3)
    mask = (canon.abs() <= half[:, None, :]).all(-1) & valid
    return canon, mask


def precrop_mask(pts, box_vec, wlh, offset: float, scale: float):
    """The loose world-frame pre-crop: inside the AABB of the 4*scale-scaled
    box's corners padded by 2*offset. The search crop is this mask AND the
    slacked canonical crop. -> (B, N) bool."""
    yaw = box_vec[:, 3]
    c, s = torch.cos(yaw).abs(), torch.sin(yaw).abs()
    hx = 2.0 * scale * wlh[:, 1]
    hy = 2.0 * scale * wlh[:, 0]
    hz = 2.0 * scale * wlh[:, 2]
    half = torch.stack([c * hx + s * hy, s * hx + c * hy, hz], -1) + 2.0 * offset
    d = pts - box_vec[:, None, :3]
    half = half[:, None, :]
    return ((d < half) & (d > -half)).all(-1)


def uniform_picks(count, n_out: int, generator=None):
    """(B, n_out) draws from ``generator``, uniform in [0, count) per row
    (count (B,)); the picks ``masked_resample`` takes when it is given none."""
    hi = count[:, None].clamp_min(1)
    u = torch.rand(count.shape[0], n_out, generator=generator, device=count.device)
    return torch.minimum((u * hi).long(), hi - 1)


def masked_resample(pts, mask, n_out: int, generator=None, picks=None):
    """Uniform-with-replacement resample of each row's masked points to exactly
    ``n_out`` (rows with <= 2 valid points give zeros). The pick-th valid point
    is found by a binary search in the mask's prefix sum: O(L) + O(n_out log L)
    work, no sort, for rows up to the 'all' union of T frames. ``picks``
    (B, n_out), when given, replaces the draws from ``generator``.
    pts (B, L, 3), mask (B, L) -> (out (B, n_out, 3), count (B,))."""
    csum = torch.cumsum(mask, dim=-1)
    count = csum[:, -1]
    if picks is None:
        picks = uniform_picks(count, n_out, generator)
    rows = torch.searchsorted(csum, picks.long() + 1, side="left").clamp_max(mask.shape[1] - 1)
    out = torch.gather(pts, 1, rows[..., None].expand(-1, -1, pts.shape[-1]))
    return torch.where((count > 2)[:, None, None], out, torch.zeros_like(out)), count


def decode_box_offset(box_vec, offset4, use_z: bool):
    """Apply the network's canonical-frame offset [dx, dy, dz, dtheta_deg] to the
    reference boxes: (B, 4), (B, 4) -> (B, 4)."""
    dz = offset4[:, 2] if use_z else torch.zeros_like(offset4[:, 2])
    delta = torch.stack([offset4[:, 0], offset4[:, 1], dz], -1)
    new_center = box_vec[:, :3] + torch.matmul(delta[:, None, :], _rot_z(box_vec[:, 3]).transpose(1, 2))[:, 0]
    new_yaw = box_vec[:, 3] + offset4[:, 3] * (math.pi / 180.0)
    return torch.cat([new_center, new_yaw[:, None]], -1)


def make_device_tracker(model, data_cfg: dict, test_cfg: dict):
    """The batched whole-tracklet tracker. ``model`` maps {"search_points" (B, S, 3),
    "template_points" (B, P, 3)} to a dict with "pred_box_data" (B, np, 5).

    Returns ``track(pcs, counts, init_boxes, wlhs, generator, gt_boxes) -> (boxes, scores)``:
      pcs (B, T, N, 3) padded clouds, float32 or int16 on the QUANT_SCALE grid;
      counts (B, T) valid points per frame; init_boxes (B, 4) frame-0 boxes
      [cx, cy, cz, yaw]; wlhs (B, 3) box sizes (every predicted box keeps its
      tracklet's frame-0 size); gt_boxes (B, T, 4), needed by the GT REF_BOX
      modes only -> boxes (B, T, 4) with frame 0 = init_boxes, scores (B, T)
      best-proposal logits with frame 0 = +inf.
    """
    ref_mode = ref_box_mode(test_cfg)
    aggregation = aggregation_mode(test_cfg)
    search_size = int(data_cfg["SEARCH_INPUT_SIZE"])
    template_size = int(data_cfg["TEMPLATE_INPUT_SIZE"])
    search_offset = float(data_cfg.get("SEARCH_BB_OFFSET", 0.0))
    search_scale = float(data_cfg.get("SEARCH_BB_SCALE", 1.25))
    model_offset = float(data_cfg.get("MODEL_BB_OFFSET", 0.0))
    model_scale = float(data_cfg.get("MODEL_BB_SCALE", 1.25))
    use_z = bool(data_cfg.get("USE_Z_AXIS", False))

    @torch.no_grad()
    def track(pcs, counts, init_boxes, wlhs, generator=None, gt_boxes=None):
        if ref_mode != "PREVIOUS_RESULT" and gt_boxes is None:
            raise ValueError(f"REF_BOX={ref_mode} needs the gt_boxes (B, T, 4) array")
        B, T, N = pcs.shape[:3]
        # the search crop's slack of 0.6 * length (the reference evaluator's
        # crop_center_pc gt branch), per tracklet
        search_offsets = search_offset + 0.6 * wlhs[:, 1]
        valid = torch.arange(N, device=pcs.device)[None, None, :] < counts[:, :, None]

        def frames(t0, t1):
            f = pcs[:, t0:t1]
            return f.float() * QUANT_SCALE if f.dtype == torch.int16 else f

        def crop_model(pts, mask, boxes):
            return crop_canonical(pts, mask, boxes, wlhs, model_offset, model_scale)

        prev_boxes, prev_pts = init_boxes, frames(0, 1)[:, 0]
        first_canon, first_mask = crop_model(prev_pts, valid[:, 0], init_boxes)
        boxes, scores = [init_boxes], [torch.full((B,), math.inf, device=pcs.device)]
        for t in range(1, T):
            if ref_mode == "PREVIOUS_GT":
                ref_boxes = gt_boxes[:, t - 1]
            elif ref_mode == "CURRENT_GT":
                ref_boxes = gt_boxes[:, t]
            else:
                ref_boxes = prev_boxes
            cur_pts = frames(t, t + 1)[:, 0]
            search_canon, search_mask = crop_canonical(cur_pts, valid[:, t], ref_boxes, wlhs,
                                                       search_offsets, search_scale)
            search_mask &= precrop_mask(cur_pts, ref_boxes, wlhs, search_offset, search_scale)
            search, _ = masked_resample(search_canon, search_mask, search_size, generator)

            # the template follows the predicted trajectory in every REF_BOX mode
            if aggregation == "FIRST":
                tmpl, tmpl_mask = first_canon, first_mask
            elif aggregation == "ALL":
                # every frame f < t cropped around its predicted box (frame 0
                # around the given one), resampled once over the union
                hist = torch.stack(boxes, 1)  # (B, t, 4)
                canon, mask = crop_canonical(frames(0, t).reshape(B * t, N, 3), valid[:, :t].reshape(B * t, N),
                                             hist.reshape(B * t, 4), wlhs.repeat_interleave(t, 0),
                                             model_offset, model_scale)
                tmpl, tmpl_mask = canon.reshape(B, t * N, 3), mask.reshape(B, t * N)
            else:
                tmpl, tmpl_mask = crop_model(prev_pts, valid[:, t - 1], prev_boxes)
                if aggregation == "FIRSTANDPREVIOUS":
                    tmpl, tmpl_mask = torch.cat([first_canon, tmpl], 1), torch.cat([first_mask, tmpl_mask], 1)
            template, _ = masked_resample(tmpl, tmpl_mask, template_size, generator)

            data = model({"search_points": search, "template_points": template})["pred_box_data"]
            best_idx = torch.argmax(data[:, :, 4], dim=1)  # first of equal maxima
            best = torch.gather(data, 1, best_idx[:, None, None].expand(-1, 1, data.shape[-1]))[:, 0]
            prev_boxes, prev_pts = decode_box_offset(ref_boxes, best[:, :4], use_z), cur_pts
            boxes.append(prev_boxes)
            scores.append(best[:, 4])
        return torch.stack(boxes, 1), torch.stack(scores, 1)

    return track


class DeviceTrackingEvaluator:
    """Pads tracklets to (B, T, N) batches, runs the device tracker, and scores
    Success/Precision on the host with the numpy metrics.

    ``cfg`` holds the ``DATA_CONFIG`` and ``TEST`` sections (``config.ptt_config()``).
    ``model`` is the tracker, already on ``device``. Clouds go up as int16 on the
    QUANT_SCALE grid. Frames with more than ``max_points`` points are subsampled
    once on the host; tracklet lengths are padded to a multiple of FRAME_BUCKET
    and the batch to ``batch_size`` (last tracklet repeated, not scored). The GT
    REF_BOX modes also upload the (B, T, 4) ground truth, padded frames with the
    last box. With ``output_dir``, every scored frame is a line of
    ``<output_dir>/final_result/data/track_result.txt``, as the host evaluator
    writes it, and with TEST.SAVE_PCD each frame's search cloud is a file of
    ``<output_dir>/pcd/``: the crop and resample of the host evaluator around
    the boxes this tracker used, since the device's own clouds stay there.
    """

    def __init__(self, cfg: dict, model, max_points: int = 16384, batch_size: int = 8,
                 seed: int = 1, device="cuda", output_dir=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_points = int(max_points)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.track_fn = make_device_tracker(model, cfg["DATA_CONFIG"], cfg["TEST"])
        self.needs_gt = ref_box_mode(cfg["TEST"]) != "PREVIOUS_RESULT"
        self.generator = torch.Generator(device=self.device)  # reseeded at every dispatch
        self.evaluator = Evaluator(ref_coord=str(cfg["DATA_CONFIG"].get("REF_COOR", "lidar")))
        self._fp = None
        self._tracklet_num = 0
        if output_dir is not None:
            final_dir = Path(output_dir) / "final_result" / "data"
            final_dir.mkdir(parents=True, exist_ok=True)
            self._fp = open(final_dir / RESULT_FILE, "w")
        self._pcd_dir = None
        if output_dir is not None and bool(cfg["TEST"].get("SAVE_PCD", False)):
            self._pcd_dir = Path(output_dir) / "pcd"
            self._pcd_dir.mkdir(parents=True, exist_ok=True)

    def close(self):
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    @staticmethod
    def box_to_vec(box) -> np.ndarray:
        yaw = np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0])
        return np.array([*box.center, yaw], np.float32)

    def _pad_tracklet(self, pcs, T_pad, n_pad):
        rng = np.random.default_rng(self.seed)
        out = np.zeros((T_pad, n_pad, 3), np.int16)
        counts = np.zeros((T_pad,), np.int32)
        for t, pc in enumerate(pcs):
            pc = np.asarray(pc, np.float32)
            if pc.shape[0] > n_pad:
                pc = pc[rng.choice(pc.shape[0], n_pad, replace=False)]
            out[t, : pc.shape[0]] = np.clip(np.round(pc / QUANT_SCALE), -32768, 32767)
            counts[t] = pc.shape[0]
        return out, counts

    def dispatch_batch(self, tracklets):
        """Pack a batch of ``(pcs, boxes, annos)`` tracklets, upload it and enqueue
        the whole loop on the device. Returns a handle for ``finish_batch``; the
        host can score an earlier batch while the device runs this one.

        The generator is reseeded first, so the batch's draws depend on the seed
        alone. The draws are made as the work is enqueued: an earlier batch still
        running on the device drew all of its own before this call."""
        self.generator.manual_seed(self.seed)
        if len(tracklets) > self.batch_size:
            raise ValueError(f"dispatch_batch got {len(tracklets)} tracklets > batch_size={self.batch_size}")
        T_max = max(len(pcs) for pcs, _, _ in tracklets)
        T_pad = max(2, -(-T_max // FRAME_BUCKET) * FRAME_BUCKET)
        n_real = len(tracklets)
        B = max(n_real, self.batch_size)
        # the point axis is padded to the batch's largest frame (multiples of 256)
        n_max = max(min(len(pc), self.max_points) for pcs, _, _ in tracklets for pc in pcs)
        n_pad = min(self.max_points, max(256, -(-n_max // 256) * 256))

        pcs_arr = np.zeros((B, T_pad, n_pad, 3), np.int16)
        counts = np.zeros((B, T_pad), np.int32)
        init_boxes = np.zeros((B, 4), np.float32)
        wlhs = np.zeros((B, 3), np.float32)
        gt = np.zeros((B, T_pad, 4), np.float32) if self.needs_gt else None
        for b in range(B):
            pcs, boxes, _ = tracklets[min(b, n_real - 1)]
            pcs_arr[b], counts[b] = self._pad_tracklet(pcs, T_pad, n_pad)
            init_boxes[b] = self.box_to_vec(boxes[0])
            wlhs[b] = boxes[0].wlh
            if gt is not None:
                gt[b, : len(boxes)] = np.stack([self.box_to_vec(g) for g in boxes])
                gt[b, len(boxes):] = gt[b, len(boxes) - 1]  # padded frames reuse the last box

        dev = self.device
        boxes_dev, _ = self.track_fn(
            torch.from_numpy(pcs_arr).to(dev), torch.from_numpy(counts).to(dev),
            torch.from_numpy(init_boxes).to(dev), torch.from_numpy(wlhs).to(dev), self.generator,
            None if gt is None else torch.from_numpy(gt).to(dev),
        )
        return boxes_dev, wlhs, tracklets

    def finish_batch(self, handle):
        """Wait for a dispatched batch, score it, and return per-tracklet lists of
        predicted ``Box``es."""
        boxes_dev, wlhs, tracklets = handle
        return self._score(boxes_dev.cpu().numpy(), tracklets)

    def track_batch(self, tracklets):
        """Track and score ``tracklets`` in chunks of ``batch_size``."""
        results = []
        for i in range(0, len(tracklets), self.batch_size):
            results.extend(self.finish_batch(self.dispatch_batch(tracklets[i: i + self.batch_size])))
        return results

    def _save_pcds(self, pcs, gt_boxes, results, annos):
        """TEST.SAVE_PCD: each frame's search crop and resample on the host, as
        the host evaluator makes them, around the box this tracker cropped
        around, written in the world frame."""
        data_cfg = self.cfg["DATA_CONFIG"]
        mode = ref_box_mode(self.cfg["TEST"])
        for t in range(1, len(pcs)):
            ref_box = {"PREVIOUS_RESULT": results[t - 1], "PREVIOUS_GT": gt_boxes[t - 1],
                       "CURRENT_GT": gt_boxes[t]}[mode]
            crop, _, _ = geo.crop_center_pc(np.asarray(pcs[t], np.float32), ref_box, gt_box=gt_boxes[t],
                                            offset=float(data_cfg.get("SEARCH_BB_OFFSET", 0.0)),
                                            scale=float(data_cfg.get("SEARCH_BB_SCALE", 1.25)))
            crop = geo.regularize_pc(crop, int(data_cfg["SEARCH_INPUT_SIZE"]), istrain=False)
            anno = annos[t] if annos is not None and t < len(annos) else {}
            save_candidate_pcd(self._pcd_dir, crop, ref_box, anno, default_scene=self._tracklet_num,
                               default_frame=t)

    def _score(self, boxes_out, tracklets):
        all_results = []
        for b, (pcs, gt_boxes, annos) in enumerate(tracklets):
            results = [
                geo.Box(center=boxes_out[b, t, :3].astype(np.float64),
                        wlh=np.asarray(gt_boxes[0].wlh, np.float64),
                        orientation=geo.Quaternion(axis=[0, 0, 1], radians=float(boxes_out[b, t, 3])))
                for t in range(len(pcs))
            ]
            with self.evaluator:
                for gt, pred in zip(gt_boxes, results):
                    self.evaluator.update_iou(gt, pred)
            # 1-based tracklet numbers, counted before writing, as the host
            # evaluator's, so the two loops' result files line up row by row
            self._tracklet_num += 1
            if self._pcd_dir is not None:
                self._save_pcds(pcs, gt_boxes, results, annos)
            if self._fp is not None:
                for t, box in enumerate(results):
                    anno = annos[t] if annos is not None and t < len(annos) else {}
                    scene, _, frame = anno_scene_frame(anno, default_scene=-1, default_frame=t)
                    self._fp.write(result_line(scene, frame, self._tracklet_num, box))
                self._fp.flush()
            all_results.append(results)
        return all_results

    def summary(self) -> dict:
        return {
            "success": self.evaluator.Success_main.average,
            "precision": self.evaluator.Precision_main.average,
            "frames": self.evaluator.Success_main.count,
        }


def eval_one_epoch_device(cfg, model, dataloader, epoch_id="?", logger=None, max_points: int = 16384,
                          batch_size: int = 8, result_dir=None, device="cuda"):
    """The device tracker over every tracklet of ``dataloader`` (an iterable of
    batches, each a list of (pcs, boxes, annos) tracklets), in dispatch batches
    of ``batch_size``, two deep: batch k + 1 is enqueued on the device before
    the host waits for and scores batch k. Returns (success, precision, frames
    per second)."""
    emit = logger.info if logger is not None else print
    ev = DeviceTrackingEvaluator(cfg, model, max_points=max_points, batch_size=batch_size, device=device,
                                 output_dir=result_dir)
    pending, in_flight, n_frames = [], None, 0
    start = time.perf_counter()

    def dispatch(chunk):
        nonlocal in_flight
        handle = ev.dispatch_batch(chunk)
        if in_flight is not None:
            ev.finish_batch(in_flight)
        in_flight = handle

    for batch in dataloader:
        for trk in batch:
            pending.append(trk)
            n_frames += len(trk[0])
            if len(pending) == batch_size:
                dispatch(pending)
                pending = []
    if pending:
        dispatch(pending)
    if in_flight is not None:
        ev.finish_batch(in_flight)
    ev.close()
    elapsed = time.perf_counter() - start
    s = ev.summary()
    emit(f"[device eval] epoch {epoch_id}: Succ/Prec {s['success']:.1f}/{s['precision']:.1f}  "
         f"({s['frames']} frames in {elapsed:.1f}s = {n_frames / elapsed:.1f} fps)")
    return s["success"], s["precision"], n_frames / elapsed
