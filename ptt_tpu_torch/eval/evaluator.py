"""The per-frame host evaluator (the JAX package's ``eval/evaluator.py``, the
reference's tools/eval_utils/eval_tracking_utils.py).

Per tracklet: frame 0 is the given box; every later frame crops the search
region around the reference box (TEST.REF_BOX), fuses the template from the
frames TEST.SHAPE_AGGREGATION names around their predicted boxes, runs the
network and decodes the best proposal back to the world frame
(``get_box_by_offset``). The search crop is the native library's
``crop_canonical`` (``native/``), the template crops and the resamples the
numpy code of ``core/geometry.py`` with its reseeded RNG, as in the JAX host
loop; the forward and the argmax over the proposals run on the device, as
one replay of a captured CUDA graph on the GPU (``TrackStep``, the JAX
package's jitted ``track_step``; the forward itself under a point group, whose
gathers run from the host), and 5 floats come back a frame. Under a point
group every rank of the group tracks the same tracklets, which each tracklet
checks. With TEST.SAVE_PCD each frame's search cloud is written as a ``.pcd``
in the world frame.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from .. import native, resolve_device
from ..core import geometry as geo
from ..ops import mesh_ctx
from ..utils import cuda_graph, timer
from ..utils.common import AverageMeter
from .metrics import Evaluator, merged_main_metrics


def result_file_name(rank=None, world=None) -> str:
    """The per-frame result file of a run: ``track_result.txt``, or
    ``track_result.rank{i}.txt`` in a process group of more than one rank,
    where each rank tracks its shard of the test tracklets. Default: this
    process's rank and world size."""
    if rank is None or world is None:
        from ..utils.dist import get_dist_info

        rank, world = get_dist_info()
    return "track_result.txt" if world == 1 else f"track_result.rank{rank}.txt"


def anno_scene_frame(anno, default_scene, default_frame):
    """(scene, track_id, frame) from a dataset anno dict, with the fallbacks
    both evaluators use for result lines."""
    scene = anno.get("scene", anno.get("scene_num", default_scene))
    track = anno.get("track_id", 0)
    frame = anno.get("frame", anno.get("frame_num", default_frame))
    return scene, track, frame


def save_candidate_pcd(pcd_dir, points_canonical, ref_box, anno, default_scene, default_frame) -> None:
    """TEST.SAVE_PCD: a frame's canonical search cloud, rotated and moved back to
    the world frame by its crop's reference box, as
    ``<scene>_<track>_candidatePC_<frame>.pcd``."""
    from ..utils.file_io import save_pts_as_pcd

    world = points_canonical @ ref_box.rotation_matrix.T + ref_box.center
    scene, track, frame = anno_scene_frame(anno, default_scene, default_frame)
    save_pts_as_pcd(world, pcd_dir, name=f"{scene}_{track}_candidatePC_{frame}.pcd")


def result_line(scene, frame, tracklet: int, box) -> str:
    """One ``track_result.txt`` line: scene, frame, 1-based tracklet number and
    the box's 8 corners (24 numbers, x then y then z of each)."""
    flat = np.concatenate(box.corners().T, axis=0).tolist()
    return " ".join(map(str, [scene, frame, tracklet] + flat)) + "\n"


REF_BOX_MODES = ("PREVIOUS_RESULT", "PREVIOUS_GT", "CURRENT_GT")


def ref_box_mode(test_cfg: dict) -> str:
    """TEST.REF_BOX by substring, in the reference's order."""
    ref = str(test_cfg.get("REF_BOX", "previous_result")).upper()
    for mode in REF_BOX_MODES:
        if mode in ref:
            return mode
    raise ValueError("TEST.REF_BOX must be previous_result / previous_gt / current_gt")


def aggregation_mode(test_cfg: dict) -> str:
    """TEST.SHAPE_AGGREGATION by substring, in the reference's order; anything
    that names neither the first nor the previous frame is 'ALL'."""
    agg = str(test_cfg.get("SHAPE_AGGREGATION", "firstandprevious")).upper()
    for mode in ("FIRSTANDPREVIOUS", "FIRST", "PREVIOUS"):
        if mode in agg:
            return mode
    return "ALL"


@torch.no_grad()
def best_proposal(model, search_points, template_points):
    """One frame's inference: the forward on a (1, S, 3) search and a (1, P, 3)
    template, and the best proposal taken on the device -> the (5,) tensor
    [dx, dy, dz, dtheta_deg, score] on the model's device."""
    data = model({"search_points": search_points, "template_points": template_points})["pred_box_data"][0]
    return data.index_select(0, torch.argmax(data[:, 4]).reshape(1))[0]


class TrackStep:
    """``best_proposal`` of ``model`` as the host loop calls it, the counterpart
    of the JAX package's jitted ``track_step``: on the GPU a CUDA graph per
    (search, template) shape and ``cuda_graph.model_signature``, replayed on
    inputs copied into its static buffers (the first call of a shape runs
    eagerly, then captures); on the CPU and under a point group the forward
    itself."""

    def __init__(self, model):
        self.model = model
        self.graphs = cuda_graph.GraphCache(cuda_graph.GRAPH_CACHE_SIZE)

    @torch.no_grad()
    def __call__(self, search_points, template_points):
        if search_points.device.type == "cpu" or mesh_ctx.get_point_group() is not None:
            return best_proposal(self.model, search_points, template_points)
        key = (tuple(search_points.shape), tuple(template_points.shape), cuda_graph.model_signature(self.model))
        entry = self.graphs.get(key)
        if entry is None:
            inputs = (search_points.clone(), template_points.clone())
            graph = cuda_graph.StepGraph(lambda: best_proposal(self.model, *inputs), search_points.device)
            self.graphs.put(key, cuda_graph.GraphEntry(inputs, graph))
            return graph.first
        for dst, src in zip(entry.state, (search_points, template_points)):
            dst.copy_(src)
        entry.graph.replay()
        return entry.graph.output.clone()


class TrackingEvaluator:
    """The per-tracklet tracking loop. ``cfg`` holds DATA_CONFIG and TEST;
    ``model`` is the tracker, already on ``device``. ``output_dir``, when
    given, receives ``result_file_name()``; with TEST.SAVE_PCD the search clouds
    go to ``pcd_dir`` (default ``<output_dir>/pcd``)."""

    def __init__(self, cfg: dict, model, output_dir=None, device="cuda", pcd_dir=None):
        self.cfg = cfg
        self.data_cfg = cfg["DATA_CONFIG"]
        self.test_cfg = cfg["TEST"]
        self.ref_mode = ref_box_mode(self.test_cfg)
        self.aggregation = aggregation_mode(self.test_cfg)
        self.model = model
        self.device = resolve_device(device)
        self.track_step = TrackStep(model)
        self.evaluator = Evaluator(ref_coord=str(self.data_cfg.get("REF_COOR", "lidar")))
        self.frame_time = AverageMeter()
        self.batch_num = 0
        self._fp = None
        if output_dir is not None:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            self._fp = open(output_dir / result_file_name(), "w")
        self._pcd_dir = None
        if bool(self.test_cfg.get("SAVE_PCD", False)) and (pcd_dir is not None or output_dir is not None):
            self._pcd_dir = Path(pcd_dir) if pcd_dir is not None else Path(output_dir) / "pcd"
            self._pcd_dir.mkdir(parents=True, exist_ok=True)

    def _prepare_search(self, this_pc, this_box, results, gt_boxes, frame_id):
        ref_box = {"PREVIOUS_RESULT": results[-1], "PREVIOUS_GT": gt_boxes[frame_id - 1],
                   "CURRENT_GT": this_box}[self.ref_mode]
        # crop_center_pc with the gt box, as the reference evaluator calls it,
        # by the native library as the JAX host loop crops: the loose
        # world-frame pre-crop (2 * offset, 4 * scale), then the canonical crop
        # with the gt branch's 0.6 * length of slack. The slack can reach past
        # the pre-crop for long, low boxes, so the pre-crop bounds membership.
        offset = float(self.data_cfg.get("SEARCH_BB_OFFSET", 0.0))
        scale = float(self.data_cfg.get("SEARCH_BB_SCALE", 1.25))
        pre = geo.crop_pc(this_pc, ref_box, offset=2 * offset, scale=4 * scale)
        yaw = np.arctan2(ref_box.rotation_matrix[1, 0], ref_box.rotation_matrix[0, 0])
        pts, _ = native.crop_canonical(pre, np.array([*ref_box.center, yaw], np.float32), ref_box.wlh,
                                       offset + 0.6 * float(np.asarray(this_box.wlh)[1]), scale)
        return ref_box, geo.regularize_pc(pts, int(self.data_cfg["SEARCH_INPUT_SIZE"]), istrain=False)

    def _prepare_template(self, pcs, results, frame_id):
        if self.aggregation == "FIRSTANDPREVIOUS":
            sel_pcs, sel_boxes = [pcs[0], pcs[frame_id - 1]], [results[0], results[frame_id - 1]]
        elif self.aggregation == "FIRST":
            sel_pcs, sel_boxes = [pcs[0]], [results[0]]
        elif self.aggregation == "PREVIOUS":
            sel_pcs, sel_boxes = [pcs[frame_id - 1]], [results[frame_id - 1]]
        else:
            sel_pcs, sel_boxes = pcs[:frame_id], results
        template = geo.get_model(sel_pcs, sel_boxes, offset=float(self.data_cfg.get("MODEL_BB_OFFSET", 0.0)),
                                 scale=float(self.data_cfg.get("MODEL_BB_SCALE", 1.25)))
        return geo.regularize_pc(template, int(self.data_cfg["TEMPLATE_INPUT_SIZE"]), istrain=False)

    def _upload(self, pts):
        return torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32))[None].to(self.device)

    def test_tracklet(self, pcs, gt_boxes, annos=None):
        """Track one tracklet: update the metrics frame by frame and return the
        predicted boxes."""
        mesh_ctx.check_same_data([np.asarray(pc, np.float32) for pc in pcs], "tracklets")
        self.batch_num += 1
        results = []
        use_z = bool(self.data_cfg.get("USE_Z_AXIS", False))
        with self.evaluator:
            for i, (this_pc, this_box) in enumerate(zip(pcs, gt_boxes)):
                if i == 0:
                    results.append(this_box)  # the given box seeds the track
                else:
                    t0 = time.perf_counter()
                    with timer.env("pre process"):
                        ref_box, search = self._prepare_search(this_pc, this_box, results, gt_boxes, i)
                        template = self._prepare_template(pcs, results, i)
                    with timer.env("model inference"):
                        best = self.track_step(self._upload(search), self._upload(template)).cpu().numpy()
                    with timer.env("post process"):
                        results.append(geo.get_box_by_offset(ref_box, best[:4], use_z))
                    if self._pcd_dir is not None:
                        save_candidate_pcd(self._pcd_dir, search, ref_box,
                                           annos[i] if annos is not None and i < len(annos) else {},
                                           default_scene=self.batch_num, default_frame=i)
                    self.frame_time.update(time.perf_counter() - t0)
                self.evaluator.update_iou(this_box, results[-1])
                if self._fp is not None:
                    anno = annos[i] if annos is not None and i < len(annos) else {}
                    scene, _, frame = anno_scene_frame(anno, default_scene=-1, default_frame=i)
                    self._fp.write(result_line(scene, frame, self.batch_num, results[-1]))
        return results

    @property
    def fps(self):
        return 1.0 / self.frame_time.avg if self.frame_time.count else 0.0

    def close(self):
        self.track_step.graphs.clear()
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def summary(self) -> dict:
        return {
            "success": self.evaluator.Success_main.average,
            "precision": self.evaluator.Precision_main.average,
            "fps": self.fps,
            "frames": self.evaluator.Success_main.count,
        }


def eval_one_epoch(cfg, model, dataloader, epoch_id="?", logger=None, result_dir=None, device="cuda"):
    """Track every tracklet of ``dataloader`` (an iterable of batches, each a
    list of (pcs, boxes, annos) tracklets) with the host loop; writes
    ``<result_dir>/final_result/data/<result_file_name()>`` (and with
    TEST.SAVE_PCD ``<result_dir>/pcd/``) when ``result_dir`` is given. Returns
    (success, precision), merged over the ranks of a process group, each of
    which tracked its shard."""
    emit = logger.info if logger is not None else print
    emit(f"*************** EPOCH {epoch_id} EVALUATION *****************")
    timer.reset(counters=False)  # the table's sections; the process's counters run on
    final_dir = Path(result_dir) / "final_result" / "data" if result_dir else None
    ev = TrackingEvaluator(cfg, model, output_dir=final_dir, device=device,
                           pcd_dir=Path(result_dir) / "pcd" if result_dir else None)
    start = time.perf_counter()
    with timer.tracing():  # the frames' three sections, for print_stats
        for batch in dataloader:
            for pcs, boxes, annos in batch:
                ev.test_tracklet(pcs, boxes, annos)
                emit(f"tracklet {ev.batch_num}: batch Succ/Prec {ev.evaluator.Success_batch.average:.1f}/"
                     f"{ev.evaluator.Precision_batch.average:.1f}  ({ev.fps:.1f} fps)")
    summary = ev.summary()
    ev.close()
    elapsed = time.perf_counter() - start
    timer.print_stats(logger)
    succ, prec, frames = merged_main_metrics(ev.evaluator)
    emit(f"*************** Performance of EPOCH {epoch_id} *****************\n"
         f"mean Succ/Prec {succ:.1f}/{prec:.1f}  "
         f"({frames} frames; local {summary['frames']} in {elapsed:.1f}s, tracked at {summary['fps']:.1f} fps)")
    return succ, prec
