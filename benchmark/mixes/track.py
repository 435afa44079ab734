"""Traffic kind ``track``: the program's device tracker over batches of whole
tracklets, as the test CLI runs it (``eval/device_loop.py``
``DeviceTrackingEvaluator``: pack and upload, the frame step replayed as a
CUDA graph, the boxes back, scored on the host), two batches always in
flight: batch k + 1 is dispatched before batch k is waited for and scored.

Set-up makes a pool of distinct batches from the seed and the weights, builds
the evaluator, and runs warm-up batches (the first captures the frame step's
graph). The window cycles the pool until ``seconds`` have passed, then
finishes the batch in flight. ``track_fps``: the frames of every batch
dispatched in the window over the time from its start to the end of the last
batch's scoring.

The check, after the window, follows the program step by step: for a sample
of (dispatched batch, frame t) drawn from the seed, the reference crops frame
t around the box the program returned for frame t - 1, with the uniforms the
program's seed gives, runs its forward and decodes its best proposal; each of
the batch's boxes at t is held against it. The program's Success and
Precision of every scored frame are held against the reference scorer's on
the same boxes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import trace as btrace
from ..counts.flops import frame_step_flops
from ..counts.sa import sa_counts
from ..gen.tracklets import make_tracklets
from ..reference import frame as ref_frame
from ..reference import model as ref_model
from ..reference import score as ref_score

WILD_M = 0.01  # a box whose error is above this (m or rad) is wild


def box_errors(prog: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """max(center distance in m, yaw difference in rad) of (n, 4) boxes."""
    d = np.linalg.norm(prog[:, :3].astype(np.float64) - ref[:, :3], axis=1)
    dyaw = np.abs(np.angle(np.exp(1j * (prog[:, 3].astype(np.float64) - ref[:, 3]))))
    return np.maximum(d, dyaw)


def compare_boxes(got: dict, ref: dict) -> dict:
    """The median and the 90th percentile of the errors of the boxes ``got``
    against ``ref``, both {(d, t): (B, 4)}, and the share of them that are
    wild: a near tie (in the vote FPS, in the best proposal) sends a few boxes
    far in sound runs too, so the wild share has a limit above nought."""
    errs = np.concatenate([box_errors(got[key], ref[key]) for key in ref])
    return {"box_err_median": float(np.median(errs)), "box_err_p90": float(np.quantile(errs, 0.9)),
            "box_wild_share": float(np.mean(errs > WILD_M))}


class Track:
    def __init__(self, ctx):
        self.ctx = ctx
        cfg, tr = ctx.config, ctx.traffic
        self.device = torch.device(ctx.device)
        self.B, self.T = int(tr["tracklets_per_batch"]), int(tr["frames"])
        tracklets = make_tracklets(self.B * int(tr["pool_batches"]), self.T, int(tr["object_points"]),
                                   int(tr["clutter_points"]), ctx.seed)
        self.pool = [tracklets[i * self.B:(i + 1) * self.B] for i in range(int(tr["pool_batches"]))]
        self.frames_per_batch = sum(len(t[0]) for t in self.pool[0])
        ctx.mark("tracklets")
        self.weights = ref_model.make_weights(ref_model.param_specs(cfg["MODEL"]), ctx.seed, self.device)
        ctx.mark("weights")
        self.done, self.host_ms = [], []
        self.frames = 0
        self.traced = None
        self.summary = None
        from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
        from ptt_tpu_torch.nn import build_network

        model = build_network(cfg["MODEL"], device=self.device)
        model.load_state_dict(self.weights, strict=True)
        model.eval()
        self.ev = DeviceTrackingEvaluator(cfg, model, max_points=int(tr["max_points"]), batch_size=self.B,
                                          seed=ctx.seed, device=self.device)
        ctx.mark("program")
        self._loop(count=int(tr["warmup_batches"]), start_k=0)
        self.sync()
        ctx.mark("warm-up")
        self.host_ms = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ window

    def _finish(self, handle, pool_idx, dispatch_s, counted):
        with btrace.span("wait"):
            boxes = self.ev.boxes(handle)
        t1 = time.perf_counter()
        with btrace.span("score"):
            self.ev.finish_batch(handle)
        t2 = time.perf_counter()
        self.done.append((pool_idx, boxes.numpy().copy(), counted))
        if counted:
            self.frames += self.frames_per_batch
            self.host_ms.append((dispatch_s + t2 - t1) * 1e3)

    def _loop(self, deadline=None, count=None, start_k=0, counted=False) -> int:
        """Dispatch pool batches from index ``start_k`` until ``deadline`` or
        ``count`` batches, two in flight, then finish the last. Returns the
        next index."""
        k, in_flight = start_k, None
        while (deadline is None or time.perf_counter() < deadline) and (count is None or k - start_k < count):
            t0 = time.perf_counter()
            with btrace.span("dispatch"):
                handle = self.ev.dispatch_batch(self.pool[k % len(self.pool)])
            dispatch_s = time.perf_counter() - t0
            if in_flight is not None:
                self._finish(*in_flight, counted)
            in_flight = (handle, k % len(self.pool), dispatch_s)
            k += 1
        if in_flight is not None:
            self._finish(*in_flight, counted)
        return k

    def window(self, seconds: float, trace: bool) -> dict:
        start = time.perf_counter()
        deadline = start + seconds
        k = len(self.done)
        if trace:
            k = self._loop(deadline=start + seconds / 2, start_k=k, counted=True)
            n = int(self.ctx.traffic["traced_batches"])
            self.traced = btrace.traced(lambda: self._loop(count=n, start_k=k, counted=True))
            self.steps_traced = n * (ref_frame.padded_frames(self.T) - 1)
            k = self.traced.result
        self._loop(deadline=deadline, start_k=k, counted=True)
        elapsed = time.perf_counter() - start
        return {"track_fps": self.frames / elapsed}

    def failures(self):
        """(frames whose box is not finite, frames) of the window's batches."""
        counted = [boxes for _, boxes, c in self.done if c]
        bad = sum(int((~np.isfinite(b)).any(-1).sum()) for b in counted)
        return bad, self.frames

    def release(self) -> None:
        """Keep the program's Success and Precision, free its state."""
        if self.ev is not None:
            self.summary = self.ev.summary()
            self.ev.close()
            self.ev = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------------- check

    def _inputs(self, pool_idx, cache):
        if pool_idx not in cache:
            packed = ref_frame.pack(self.pool[pool_idx], self._n_pad(), self.ctx.seed)
            cache[pool_idx] = ref_frame.FrameInputs(packed, self.ctx.config["DATA_CONFIG"], self.ctx.config["TEST"],
                                                    self.device)
        return cache[pool_idx]

    def _n_pad(self):
        n_max = max(min(len(pc), int(self.ctx.traffic["max_points"]))
                    for batch in self.pool for trk in batch for pc in trk[0])
        return min(int(self.ctx.traffic["max_points"]), max(256, -(-n_max // 256) * 256))

    @torch.no_grad()
    def follow(self, sample, tf32: bool = False) -> dict:
        """The reference's boxes at each sampled (done index, t), cropped from
        the program's boxes at t - 1: {(d, t): (B, 4)}; and the SA counts of
        each sampled frame step. With ``tf32`` every product in TF32 (the
        control: the reference in the program's place, a precision lower)."""
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(tf32)
        try:
            return self._follow(sample)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    def _follow(self, sample) -> dict:
        cfg, data = self.ctx.config, self.ctx.config["DATA_CONFIG"]
        S, Pn = int(data["SEARCH_INPUT_SIZE"]), int(data["TEMPLATE_INPUT_SIZE"])
        u_s, u_t = ref_frame.uniforms(self.ctx.seed, ref_frame.padded_frames(self.T), self.B, S, Pn, self.device)
        use_z = bool(data.get("USE_Z_AXIS", False))
        cache, out, sa = {}, {}, []
        block = int(self.ctx.traffic["check_block"])
        for i in range(0, len(sample), block):
            part = sample[i:i + block]
            searches, templates, prevs = [], [], []
            for d, t in part:
                pool_idx, boxes, _ = self.done[d]
                prev = torch.from_numpy(boxes[:, t - 1]).to(self.device)
                s, tm = self._inputs(pool_idx, cache).inputs(t, prev, u_s[t - 1], u_t[t - 1])
                searches.append(s)
                templates.append(tm)
                prevs.append(prev)
            calls = []
            pred = ref_model.forward(self.weights, cfg["MODEL"], torch.cat(searches), torch.cat(templates),
                                     calls=calls)
            boxes = ref_frame.best_box(pred["pred_box_data"], torch.cat(prevs), use_z).cpu().numpy()
            for j, key in enumerate(part):
                out[key] = boxes[j * self.B:(j + 1) * self.B]
                rows = slice(j * self.B, (j + 1) * self.B)
                sa.append([sa_counts(xyz[rows], ctr[rows], c_in, r, ns, widths)
                           for xyz, ctr, c_in, r, ns, widths in calls])
        self.sa_per_step = sa
        return out

    def score_reference(self, dtype=torch.float32):
        """Success and Precision of every scored batch's boxes (rounded to
        ``dtype``) by the reference scorer; equal boxes scored once."""
        ref_coord = str(self.ctx.config["DATA_CONFIG"].get("REF_COOR", "lidar"))
        seen, ious, errs = {}, [], []
        for pool_idx, boxes, _ in self.done:
            b = torch.from_numpy(boxes).to(dtype).float().numpy()
            key = (pool_idx, b.tobytes())
            if key not in seen:
                parts = [ref_score.frame_scores(trk[1], b[i, :len(trk[0])], ref_coord)
                         for i, trk in enumerate(self.pool[pool_idx])]
                seen[key] = (np.concatenate([p[0] for p in parts]), np.concatenate([p[1] for p in parts]))
            ious.append(seen[key][0])
            errs.append(seen[key][1])
        return ref_score.success_precision(np.concatenate(ious), np.concatenate(errs))

    def sample(self):
        """(done index, t) pairs of the window's batches, drawn from the seed."""
        counted = [d for d, item in enumerate(self.done) if item[2]]
        n = min(int(self.ctx.traffic["check_pairs"]), len(counted) * (self.T - 1))
        rng = np.random.default_rng(np.random.SeedSequence([int(self.ctx.seed), 11]))
        flat = rng.choice(len(counted) * (self.T - 1), size=n, replace=False)
        return [(counted[f // (self.T - 1)], int(f % (self.T - 1)) + 1) for f in sorted(flat)]

    def check(self) -> dict:
        """The numbers compared: the median, the 90th percentile and the wild
        share of the sampled boxes' errors, and the wider of the Success and Precision
        gaps in points."""
        ref = self.follow(self.sample())
        got = {(d, t): self.done[d][1][:, t] for d, t in ref}
        return dict(compare_boxes(got, ref), **self.compare_scores((self.summary["success"], self.summary["precision"])))

    def compare_scores(self, got) -> dict:
        """The wider of the Success and the Precision gaps, in points."""
        succ, prec = self.score_reference()
        return {"score_gap": max(abs(got[0] - succ), abs(got[1] - prec))}

    # ---------------------------------------------------------------- readings

    def layer_readings(self) -> dict:
        """What the per-layer metrics read; the FLOPs of a frame step are
        counted here, after the window, for a traced run only."""
        flops = None
        if self.traced is not None:
            data = self.ctx.config["DATA_CONFIG"]
            flops = frame_step_flops(self.ctx.config["MODEL"], self.B, int(data["SEARCH_INPUT_SIZE"]),
                                     int(data["TEMPLATE_INPUT_SIZE"]))
        return {"host_ms": self.host_ms, "traced": self.traced,
                "steps_traced": getattr(self, "steps_traced", 0), "flops_per_step": flops,
                "sa_counts_per_step": getattr(self, "sa_per_step", None)}


def setup(ctx):
    return Track(ctx)
