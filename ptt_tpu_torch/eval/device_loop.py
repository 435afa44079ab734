"""Device-resident tracking (the JAX package's ``eval/device_loop.py``): a batch of
tracklets is uploaded once, and the autoregressive per-frame loop (crop,
resample, PTT forward, best proposal, box decode) runs on the device. Only the
(B, T, 4) predicted boxes come back for scoring.

The JAX package compiles the loop into one ``lax.scan`` over a step body. Here
the frame step is one body too (``FrameLoop.step``) over static tensors: the
frame index ``t`` is a device tensor that the body advances, frames are taken
with ``index_select``, and the carries (the previous boxes, the (B, T) box and
score outputs) are written in place. On the GPU the body is captured once per
batch shape as a CUDA graph and replayed for every frame step
(``DeviceTrackingEvaluator``); on the CPU the same body runs in a Python loop
(``FrameLoop.__call__``, the eager loop). Every primitive is batched over a
leading tracklet axis. All modes of the JAX tracker run: ``TEST.REF_BOX``
``previous_result`` (deployment) and the ``previous_gt`` / ``current_gt``
diagnostics, which crop and decode around the ground truth while the template
follows the predicted trajectory; and ``TEST.SHAPE_AGGREGATION``
``firstandprevious``, ``first``, ``previous`` and ``all`` (the crops of every
frame f < t around its predicted box, masked on the fixed (B, T * N) union of
all frames, one resample over it).

The body draws nothing: a batch's uniforms, one (T - 1, B, n) tensor per
resample site, are drawn up front from a ``torch.Generator`` (``FrameLoop.draw``,
as the JAX tracker splits its T - 1 keys before the scan), and step t scales
row t - 1 by its count (``scale_picks``). The stream differs from the JAX
tracker's; ``masked_resample`` picks the same rows from the same picks as the
JAX package's ``masked_resample`` and ``masked_resample_long``, with one
prefix-sum path for every row length. The evaluator reseeds its generator at
every dispatch, as the JAX evaluator derives its keys from its seed at every
dispatch, so a batch's boxes depend only on the seed and the batch.

Under a point group (``ops/mesh_ctx.py``, POINT_SHARDING over the ranks of a
node) every rank of the group tracks the same batch and the split ops gather
each other's rows inside the forward. The frame step then runs eagerly, also
on the GPU, and the evaluator says so (``graph_mode``): gloo's gathers run on
the host and cannot be captured in a CUDA graph. The ranks draw the same
uniforms, from the same seed at every dispatch, never one derived from the
rank, and each dispatch checks that they hold the same clouds.

The evaluator's and the frame loop's host work are spans of ``utils/timer.py``
(recorded while tracing is on): ``evaluator.dispatch`` (request id: the
dispatch's sequence number) with its children ``evaluator.pack``,
``frame_loop.load`` (the draws, ``load``, ``start``) and ``frame_loop.steps``
(the enqueue of the batch's T - 1 frame steps, its ``n``); inside the pack,
``evaluator.subsample`` (a tracklet's draws and gathers of its frames above
``max_points``, ``n`` those frames); ``evaluator.wait`` while a batch's boxes
are not yet back; ``evaluator.score`` (``n``: the frames scored). Counters:
``frame_loop.frame_steps``, one a frame step run, eager or replayed, and
``evaluator.subsampled_frames``.
"""

from __future__ import annotations

import math
import time
from pathlib import Path
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .. import native, resolve_device
from ..core import geometry as geo
from ..ops import mesh_ctx
from ..utils import cuda_graph, timer
from .evaluator import (aggregation_mode, anno_scene_frame, ref_box_mode, result_file_name, result_line,
                        save_candidate_pcd)
from .metrics import Evaluator, merged_main_metrics

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
    if isinstance(offset, torch.Tensor):
        offset = offset.reshape(-1, 1)
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


def scale_picks(u, count):
    """Uniforms ``u`` (B, n_out) in [0, 1) -> picks uniform in [0, count) per
    row (count (B,))."""
    hi = count[:, None].clamp_min(1)
    return torch.minimum((u * hi).long(), hi - 1)


def uniform_picks(count, n_out: int, generator=None):
    """(B, n_out) draws from ``generator``, uniform in [0, count) per row
    (count (B,)); the picks ``masked_resample`` takes when it is given none."""
    u = torch.rand(count.shape[0], n_out, generator=generator, device=count.device)
    return scale_picks(u, count)


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


class FrameLoop:
    """The batched whole-tracklet tracker as one frame step over static tensors
    (the JAX tracker's ``step``). ``model`` maps {"search_points" (B, S, 3),
    "template_points" (B, P, 3)} to a dict with "pred_box_data" (B, np, 5).

    A batch's state (``allocate``) holds its inputs, the frame index ``t``
    (a (1,) device tensor), the previous boxes and the outputs: boxes (B, T, 4)
    with frame 0 = the given box, scores (B, T) best-proposal logits with frame
    0 = +inf. ``load`` copies a batch in, ``start`` sets the carries to frame 0,
    and each ``step`` tracks frame t and advances t, reading and writing only
    the state's tensors, so that one captured step serves every frame.

    Called, it is the eager loop: ``track(pcs, counts, init_boxes, wlhs,
    generator, gt_boxes) -> (boxes, scores)``; pcs (B, T, N, 3) padded clouds,
    float32 or int16 on the QUANT_SCALE grid; counts (B, T) valid points per
    frame; init_boxes (B, 4) frame-0 boxes [cx, cy, cz, yaw]; wlhs (B, 3) box
    sizes (every predicted box keeps its tracklet's frame-0 size); gt_boxes
    (B, T, 4), needed by the GT REF_BOX modes only.
    """

    def __init__(self, model, data_cfg: dict, test_cfg: dict):
        self.model = model
        self.ref_mode = ref_box_mode(test_cfg)
        self.aggregation = aggregation_mode(test_cfg)
        self.search_size = int(data_cfg["SEARCH_INPUT_SIZE"])
        self.template_size = int(data_cfg["TEMPLATE_INPUT_SIZE"])
        self.search_offset = float(data_cfg.get("SEARCH_BB_OFFSET", 0.0))
        self.search_scale = float(data_cfg.get("SEARCH_BB_SCALE", 1.25))
        self.model_offset = float(data_cfg.get("MODEL_BB_OFFSET", 0.0))
        self.model_scale = float(data_cfg.get("MODEL_BB_SCALE", 1.25))
        self.use_z = bool(data_cfg.get("USE_Z_AXIS", False))

    def allocate(self, B: int, T: int, N: int, dtype, has_gt: bool, device) -> SimpleNamespace:
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        return SimpleNamespace(
            pcs=zeros(B, T, N, 3, dtype=dtype), counts=zeros(B, T, dtype=torch.int32), init=zeros(B, 4),
            wlhs=zeros(B, 3), gt=zeros(B, T, 4) if has_gt else None,
            u_search=zeros(T - 1, B, self.search_size), u_template=zeros(T - 1, B, self.template_size),
            frame_ids=torch.arange(T, device=device), point_ids=torch.arange(N, device=device),
            valid=zeros(B, T, N, dtype=torch.bool), search_offsets=zeros(B), first_canon=zeros(B, N, 3),
            first_mask=zeros(B, N, dtype=torch.bool), t=zeros(1, dtype=torch.long), prev=zeros(B, 4),
            boxes=zeros(B, T, 4), scores=zeros(B, T),
        )

    def draw(self, generator, B: int, T: int, device):
        """The batch's uniforms, search then template: (T - 1, B, S), (T - 1, B, P)."""
        return (torch.rand((T - 1, B, self.search_size), generator=generator, device=device),
                torch.rand((T - 1, B, self.template_size), generator=generator, device=device))

    @staticmethod
    def load(s, pcs, counts, init_boxes, wlhs, u_search, u_template, gt_boxes=None) -> None:
        for dst, src in ((s.pcs, pcs), (s.counts, counts), (s.init, init_boxes), (s.wlhs, wlhs),
                         (s.u_search, u_search), (s.u_template, u_template), (s.gt, gt_boxes)):
            if dst is not None:
                dst.copy_(src, non_blocking=True)

    @staticmethod
    def _frames(pcs):
        return pcs.float() * QUANT_SCALE if pcs.dtype == torch.int16 else pcs

    def _frame(self, s, t):
        return self._frames(s.pcs.index_select(1, t)[:, 0])

    def _crop_model(self, pts, mask, boxes, wlhs):
        return crop_canonical(pts, mask, boxes, wlhs, self.model_offset, self.model_scale)

    def _resample(self, pts, mask, n_out, u):
        # looked up on the module at every call, so that a test's patch reaches it
        return masked_resample(pts, mask, n_out, picks=scale_picks(u, mask.sum(-1)))[0]

    @torch.no_grad()
    def start(self, s) -> None:
        """Frame 0: the valid-point masks, the search slack, the first frame's
        template crop, t = 1 and the carries."""
        B, T, _ = s.valid.shape
        s.valid.copy_(s.point_ids[None, None, :] < s.counts[:, :, None])
        # the search crop's slack of 0.6 * length (the reference evaluator's
        # crop_center_pc gt branch), per tracklet
        s.search_offsets.copy_(self.search_offset + 0.6 * s.wlhs[:, 1])
        canon, mask = self._crop_model(self._frames(s.pcs[:, 0]), s.valid[:, 0], s.init, s.wlhs)
        s.first_canon.copy_(canon)
        s.first_mask.copy_(mask)
        s.t.fill_(1)
        s.prev.copy_(s.init)
        s.boxes.copy_(s.init[:, None].expand(B, T, 4))
        s.scores.fill_(math.inf)

    @torch.no_grad()
    def step(self, s) -> None:
        """Track frame t of every tracklet, write its box and score at t, advance t."""
        t = s.t
        prev_t = t - 1
        if self.ref_mode == "PREVIOUS_GT":
            ref_boxes = s.gt.index_select(1, prev_t)[:, 0]
        elif self.ref_mode == "CURRENT_GT":
            ref_boxes = s.gt.index_select(1, t)[:, 0]
        else:
            ref_boxes = s.prev
        cur_pts = self._frame(s, t)
        search_canon, search_mask = crop_canonical(cur_pts, s.valid.index_select(1, t)[:, 0], ref_boxes, s.wlhs,
                                                   s.search_offsets, self.search_scale)
        search_mask &= precrop_mask(cur_pts, ref_boxes, s.wlhs, self.search_offset, self.search_scale)
        search = self._resample(search_canon, search_mask, self.search_size, s.u_search.index_select(0, prev_t)[0])

        # the template follows the predicted trajectory in every REF_BOX mode
        if self.aggregation == "FIRST":
            tmpl, tmpl_mask = s.first_canon, s.first_mask
        elif self.aggregation == "ALL":
            # every frame cropped around its predicted box so far (frame 0
            # around the given one), frames f >= t masked out, one resample
            # over the union
            B, T, N = s.valid.shape
            canon, mask = self._crop_model(self._frames(s.pcs).reshape(B * T, N, 3), s.valid.reshape(B * T, N),
                                           s.boxes.reshape(B * T, 4), s.wlhs[:, None].expand(B, T, 3).reshape(B * T, 3))
            mask = mask.reshape(B, T, N) & (s.frame_ids < t)[None, :, None]
            tmpl, tmpl_mask = canon.reshape(B, T * N, 3), mask.reshape(B, T * N)
        else:
            tmpl, tmpl_mask = self._crop_model(self._frame(s, prev_t), s.valid.index_select(1, prev_t)[:, 0], s.prev,
                                               s.wlhs)
            if self.aggregation == "FIRSTANDPREVIOUS":
                tmpl, tmpl_mask = torch.cat([s.first_canon, tmpl], 1), torch.cat([s.first_mask, tmpl_mask], 1)
        template = self._resample(tmpl, tmpl_mask, self.template_size, s.u_template.index_select(0, prev_t)[0])

        data = self.model({"search_points": search, "template_points": template})["pred_box_data"]
        best_idx = torch.argmax(data[:, :, 4], dim=1)  # first of equal maxima
        best = torch.gather(data, 1, best_idx[:, None, None].expand(-1, 1, data.shape[-1]))[:, 0]
        new_boxes = decode_box_offset(ref_boxes, best[:, :4], self.use_z)
        s.prev.copy_(new_boxes)
        s.boxes.index_copy_(1, t, new_boxes[:, None])
        s.scores.index_copy_(1, t, best[:, 4:5])
        t.add_(1)
        timer.count("frame_loop.frame_steps")

    @torch.no_grad()
    def __call__(self, pcs, counts, init_boxes, wlhs, generator=None, gt_boxes=None):
        if self.ref_mode != "PREVIOUS_RESULT" and gt_boxes is None:
            raise ValueError(f"REF_BOX={self.ref_mode} needs the gt_boxes (B, T, 4) array")
        B, T, N = pcs.shape[:3]
        with timer.span("frame_loop.load"):
            s = self.allocate(B, T, N, pcs.dtype, gt_boxes is not None, pcs.device)
            self.load(s, pcs, counts, init_boxes, wlhs, *self.draw(generator, B, T, pcs.device), gt_boxes)
            self.start(s)
        with timer.span("frame_loop.steps", n=T - 1):
            for _ in range(T - 1):
                self.step(s)
        return s.boxes, s.scores


def make_device_tracker(model, data_cfg: dict, test_cfg: dict) -> FrameLoop:
    """The batched whole-tracklet tracker, called as ``track(pcs, counts,
    init_boxes, wlhs, generator, gt_boxes) -> (boxes, scores)`` (``FrameLoop``)."""
    return FrameLoop(model, data_cfg, test_cfg)


def graph_mode(device) -> str:
    """How a frame step runs on ``device``: "on" (a replay of its captured
    CUDA graph), or "off" and why (the CPU, or a point group, whose gathers
    the step must make from the host)."""
    if torch.device(device).type == "cpu":
        return "off (CPU: the eager loop)"
    group = mesh_ctx.get_point_group()
    if group is not None:
        import torch.distributed as dist

        return f"off (point group of {group.size} ranks on {dist.get_backend(group.group)})"
    return "on"


def tracker_graph_key(pcs, has_gt: bool, model) -> tuple:
    """What a captured frame step is keyed by: what the JAX jit retraces on
    (B, T_pad, n_pad, the cloud's dtype, the ground truth present) and the
    model's ``cuda_graph.model_signature``."""
    B, T, N = pcs.shape[:3]
    return B, T, N, pcs.dtype, has_gt, cuda_graph.model_signature(model)


class Dispatched(NamedTuple):
    """A dispatched batch (``DeviceTrackingEvaluator.dispatch_batch``): its
    boxes (pinned host memory on the GPU, filled once ``done`` has
    happened), its tracklets, and the dispatch's sequence number, the request
    id of its spans."""

    boxes: torch.Tensor
    done: object  # a torch.cuda.Event, or None on the CPU
    tracklets: list
    request: int


class DeviceTrackingEvaluator:
    """Pads tracklets to (B, T, N) batches, runs the device tracker, and scores
    Success/Precision on the host: with the native library's batched float32
    scorer (``native.box_iou3d_batch``) in lidar coordinates, as the JAX
    evaluator scores, else (REF_COOR camera) with the numpy metrics.

    ``cfg`` holds the ``DATA_CONFIG`` and ``TEST`` sections (``config.ptt_config()``).
    ``model`` is the tracker, already on ``device``. Clouds go up as int16 on the
    QUANT_SCALE grid, or as float32 with ``quantize=False``. Frames with more
    than ``max_points`` points are subsampled once on the host; tracklet
    lengths are padded to a multiple of FRAME_BUCKET and the batch to
    ``batch_size`` (last tracklet repeated, not scored). The GT
    REF_BOX modes also upload the (B, T, 4) ground truth, padded frames with the
    last box. With ``output_dir``, every scored frame is a line of
    ``<output_dir>/final_result/data/<result_file_name()>``, as the host evaluator
    writes it, and with TEST.SAVE_PCD each frame's search cloud is a file of
    ``<output_dir>/pcd/``: the crop and resample of the host evaluator around
    the boxes this tracker used, since the device's own clouds stay there.

    On the GPU every frame step is a replay of the batch shape's captured step
    body (``graphs``: at most ``cuda_graph.GRAPH_CACHE_SIZE`` shapes, keyed by
    ``tracker_graph_key``); a capture that fails raises. On the CPU, and under a
    point group, the same body runs eagerly (``graph_mode``).
    """

    def __init__(self, cfg: dict, model, max_points: int = 16384, batch_size: int = 8,
                 seed: int = 1, device="cuda", output_dir=None, quantize: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantize = bool(quantize)
        self.max_points = int(max_points)
        self.batch_size = int(batch_size)
        self.seed = seed
        self.loop = FrameLoop(model, cfg["DATA_CONFIG"], cfg["TEST"])
        self.needs_gt = ref_box_mode(cfg["TEST"]) != "PREVIOUS_RESULT"
        # captured frame steps by batch shape (GPU)
        self.graphs = cuda_graph.GraphCache(cuda_graph.GRAPH_CACHE_SIZE)
        self.generator = torch.Generator(device=self.device)  # reseeded at every dispatch
        self.dispatches = 0
        self.evaluator = Evaluator(ref_coord=str(cfg["DATA_CONFIG"].get("REF_COOR", "lidar")))
        # the C++ scorer takes the lidar BEV footprint
        self._native_score = str(cfg["DATA_CONFIG"].get("REF_COOR", "lidar")).lower() == "lidar"
        self._fp = None
        self._tracklet_num = 0
        if output_dir is not None:
            final_dir = Path(output_dir) / "final_result" / "data"
            final_dir.mkdir(parents=True, exist_ok=True)
            self._fp = open(final_dir / result_file_name(), "w")
        self._pcd_dir = None
        if output_dir is not None and bool(cfg["TEST"].get("SAVE_PCD", False)):
            self._pcd_dir = Path(output_dir) / "pcd"
            self._pcd_dir.mkdir(parents=True, exist_ok=True)

    def close(self):
        self.graphs.clear()
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    @staticmethod
    def box_to_vec(box) -> np.ndarray:
        yaw = np.arctan2(box.rotation_matrix[1, 0], box.rotation_matrix[0, 0])
        return np.array([*box.center, yaw], np.float32)

    def _pad_tracklet(self, pcs, T_pad, n_pad):
        pcs = [np.asarray(pc, np.float32) for pc in pcs]
        over = [t for t, pc in enumerate(pcs) if pc.shape[0] > n_pad]
        if over:
            rng = np.random.default_rng(self.seed)
            with timer.span("evaluator.subsample", n=len(over)):
                for t in over:
                    pcs[t] = pcs[t][rng.choice(pcs[t].shape[0], n_pad, replace=False)]
            timer.count("evaluator.subsampled_frames", len(over))
        out = np.zeros((T_pad, n_pad, 3), np.int16 if self.quantize else np.float32)
        counts = np.zeros((T_pad,), np.int32)
        for t, pc in enumerate(pcs):
            out[t, : pc.shape[0]] = np.clip(np.round(pc / QUANT_SCALE), -32768, 32767) if self.quantize else pc
            counts[t] = pc.shape[0]
        return out, counts

    def dispatch_batch(self, tracklets):
        """Pack a batch of ``(pcs, boxes, annos)`` tracklets, upload it and enqueue
        the whole loop on the device. Returns a handle for ``finish_batch``; the
        host can score an earlier batch while the device runs this one.

        The generator is reseeded first, so the batch's draws depend on the seed
        alone. The draws are made as the work is enqueued: an earlier batch still
        running on the device drew all of its own before this call."""
        if len(tracklets) > self.batch_size:
            raise ValueError(f"dispatch_batch got {len(tracklets)} tracklets > batch_size={self.batch_size}")
        request = self.dispatches
        self.dispatches += 1
        with timer.span("evaluator.dispatch", request):
            self.generator.manual_seed(self.seed)
            with timer.span("evaluator.pack"):
                batch = self._pack(tracklets)
            mesh_ctx.check_same_data([v.numpy() for v in batch.values() if v is not None], "tracklets")
            boxes = self._track(batch)
            done = None
            if self.device.type == "cuda":
                # copied out in stream order, before the next batch can overwrite them,
                # into pinned memory, so that finish_batch waits for this copy alone and
                # not for the batches enqueued after it
                boxes = torch.empty(boxes.shape, dtype=boxes.dtype, pin_memory=True).copy_(boxes, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
        return Dispatched(boxes, done, tracklets, request)

    def _pack(self, tracklets) -> dict:
        """The batch as host tensors: pcs (B, T_pad, n_pad, 3) int16 (float32
        without ``quantize``), counts, init_boxes, wlhs and, for the GT REF_BOX
        modes, gt_boxes. For a GPU they
        are pinned, so that their copies to the device are asynchronous: PyTorch's
        host allocator hands a pinned block out again only once the copies that
        read it have run, so the next batch's packing never overwrites this
        one's before it is on the device."""
        T_max = max(len(pcs) for pcs, _, _ in tracklets)
        T_pad = max(2, -(-T_max // FRAME_BUCKET) * FRAME_BUCKET)
        n_real = len(tracklets)
        B = max(n_real, self.batch_size)
        # the point axis is padded to the batch's largest frame (multiples of 256)
        n_max = max(min(len(pc), self.max_points) for pcs, _, _ in tracklets for pc in pcs)
        n_pad = min(self.max_points, max(256, -(-n_max // 256) * 256))

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

        pcs_dtype = torch.int16 if self.quantize else torch.float32
        batch = {"pcs": zeros(B, T_pad, n_pad, 3, dtype=pcs_dtype), "counts": zeros(B, T_pad, dtype=torch.int32),
                 "init_boxes": zeros(B, 4), "wlhs": zeros(B, 3),
                 "gt_boxes": zeros(B, T_pad, 4) if self.needs_gt else None}
        pcs_arr, counts, init_boxes, wlhs = (batch[k].numpy() for k in ("pcs", "counts", "init_boxes", "wlhs"))
        gt = None if batch["gt_boxes"] is None else batch["gt_boxes"].numpy()
        for b in range(B):
            pcs, boxes, _ = tracklets[min(b, n_real - 1)]
            pcs_arr[b], counts[b] = self._pad_tracklet(pcs, T_pad, n_pad)
            init_boxes[b] = self.box_to_vec(boxes[0])
            wlhs[b] = boxes[0].wlh
            if gt is not None:
                gt[b, : len(boxes)] = np.stack([self.box_to_vec(g) for g in boxes])
                gt[b, len(boxes):] = gt[b, len(boxes) - 1]  # padded frames reuse the last box
        return batch

    def _track(self, batch):
        """The (B, T, 4) boxes of a packed batch on the device, enqueued: the
        captured frame step on the GPU, else the eager loop (``graph_mode``)."""
        if graph_mode(self.device) == "on":
            return self._track_graphed(batch)
        return self._track_eager(batch)

    def _track_eager(self, batch):
        """``FrameLoop`` called: a Python loop over the step body."""
        dev = {k: None if v is None else v.to(self.device, non_blocking=True) for k, v in batch.items()}
        boxes, _ = self.loop(dev["pcs"], dev["counts"], dev["init_boxes"], dev["wlhs"], self.generator,
                             dev["gt_boxes"])
        return boxes

    def _track_graphed(self, batch):
        """The batch shape's captured frame step, replayed T - 1 times. A shape
        met for the first time runs its first frame step eagerly (which builds
        the kernels) and is then captured, so that frame step 1 is the eager run
        and the T - 2 others are replays. Returns the state's boxes, which the
        next batch of this shape overwrites."""
        pcs = batch["pcs"]
        B, T, N = pcs.shape[:3]
        key = tracker_graph_key(pcs, batch["gt_boxes"] is not None, self.loop.model)
        entry = self.graphs.get(key)
        if entry is None:
            state = self.loop.allocate(B, T, N, pcs.dtype, batch["gt_boxes"] is not None, self.device)
            entry = self.graphs.put(key, cuda_graph.GraphEntry(state))
        s = entry.state
        with timer.span("frame_loop.load"):
            self.loop.load(s, batch["pcs"], batch["counts"], batch["init_boxes"], batch["wlhs"],
                           *self.loop.draw(self.generator, B, T, self.device), batch["gt_boxes"])
            self.loop.start(s)
        with timer.span("frame_loop.steps", n=T - 1):
            steps = T - 1
            if entry.graph is None:
                entry.graph = cuda_graph.StepGraph(lambda: self.loop.step(s), self.device)
                steps -= 1
            for _ in range(steps):
                entry.graph.replay()
        return s.boxes

    @staticmethod
    def boxes(handle: Dispatched) -> torch.Tensor:
        """Wait for a dispatched batch and return its (B, T, 4) boxes on the host."""
        if handle.done is not None and not handle.done.query():
            with timer.span("evaluator.wait", handle.request):
                handle.done.synchronize()
        return handle.boxes

    def finish_batch(self, handle: Dispatched):
        """Wait for a dispatched batch, score it, and return per-tracklet lists of
        predicted ``Box``es."""
        boxes = self.boxes(handle)
        with timer.span("evaluator.score", handle.request) as span:
            results = self._score(boxes.numpy(), handle.tracklets)
            if span is not None:
                span.n = sum(len(r) for r in results)
        return results

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
                if self._native_score:
                    self._score_native(boxes_out[b, : len(pcs)], gt_boxes)
                else:
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

    def _score_native(self, boxes, gt_boxes) -> None:
        """One tracklet's (T, 4) predicted boxes against its ground truth by
        the batched C++ scorer: [x, y, z, w, l, h, yaw] rows in float32, the
        first box's size for every prediction, as the JAX evaluator scores."""
        gt7 = np.stack([np.concatenate([self.box_to_vec(g)[:3], np.asarray(g.wlh, np.float32),
                                        self.box_to_vec(g)[3:]]) for g in gt_boxes])
        wlh = np.broadcast_to(np.asarray(gt_boxes[0].wlh, np.float32), (len(boxes), 3))
        pred7 = np.concatenate([boxes[:, :3], wlh, boxes[:, 3:4]], axis=1).astype(np.float32)
        ious, dists = native.box_iou3d_batch(gt7, pred7)
        for overlap, dist in zip(ious, dists):
            for acc in (self.evaluator.Success_main, self.evaluator.Success_batch):
                acc.add_overlap(float(overlap))
            for acc in (self.evaluator.Precision_main, self.evaluator.Precision_batch):
                acc.add_accuracy(float(dist))

    def summary(self) -> dict:
        return {
            "success": self.evaluator.Success_main.average,
            "precision": self.evaluator.Precision_main.average,
            "frames": self.evaluator.Success_main.count,
            "graph": graph_mode(self.device),
        }


def eval_one_epoch_device(cfg, model, dataloader, epoch_id="?", logger=None, max_points: int = 16384,
                          batch_size: int = 8, result_dir=None, device="cuda"):
    """The device tracker over every tracklet of ``dataloader`` (an iterable of
    batches, each a list of (pcs, boxes, annos) tracklets), in dispatch batches
    of ``batch_size``, two deep: batch k + 1 is enqueued on the device before
    the host waits for and scores batch k. Returns (success, precision, frames
    per second); in a process group, where each rank tracks its shard of the
    tracklets on its own device (its own captured graphs), Success and
    Precision merged over the ranks and this rank's frames per second. Under a
    point group every rank of the group tracks the same tracklets, and only its
    first rank's frames count in the merge."""
    emit = logger.info if logger is not None else print
    ev = DeviceTrackingEvaluator(cfg, model, max_points=max_points, batch_size=batch_size, device=device,
                                 output_dir=result_dir)
    emit(f"[device eval] graph: {graph_mode(ev.device)}")
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
    succ, prec, frames = merged_main_metrics(ev.evaluator)
    emit(f"[device eval] epoch {epoch_id}: Succ/Prec {succ:.1f}/{prec:.1f}  "
         f"({frames} frames; local {n_frames} in {elapsed:.1f}s = {n_frames / elapsed:.1f} fps)")
    return succ, prec, n_frames / elapsed
