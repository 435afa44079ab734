"""The port's frame step as one body (``ptt_tpu_torch.eval.device_loop.FrameLoop``)
and the capture helper around it (``ptt_tpu_torch.utils.cuda_graph``), on the
CPU: the body under the eager loop against the JAX device loop, the
fixed-shape 'all' union against a growing union, tracklets of different
lengths, the graph key, the bounded cache, and the graphed loop with a stub in
place of the capture."""

import numpy as np
import pytest
import torch

from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.data.synthetic import SyntheticTrackingDataset
from ptt_tpu.eval import device_loop as jdl
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.data.synthetic import make_tracklets
from ptt_tpu_torch.eval import device_loop as tdl
from ptt_tpu_torch.utils import cuda_graph
from test_torch_port_tracker import (JaxConstOffsetModel, JaxPointModel, TorchConstOffsetModel, TorchPointModel,
                                     _jax_det_resample, _torch_det_resample, _yaw)

torch.set_num_threads(1)

MODES = [(ref, agg) for ref in ("previous_result", "previous_gt", "current_gt")
         for agg in ("firstandprevious", "first", "previous", "all")]


def _cfgs(ref, agg):
    jcfg = cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml")
    jcfg.TEST.REF_BOX, jcfg.TEST.SHAPE_AGGREGATION = ref, agg
    cfg = ptt_config()
    cfg["TEST"].update(REF_BOX=ref, SHAPE_AGGREGATION=agg)
    return jcfg, cfg


def _assert_tracks_close(jres, tres, lengths):
    for jt, tt, n in zip(jres, tres, lengths):
        assert len(jt) == len(tt) == n
        for jb, tb in zip(jt, tt):
            np.testing.assert_allclose(tb.center, jb.center, rtol=0, atol=1e-5)
            assert abs((_yaw(tb) - _yaw(jb) + np.pi) % (2 * np.pi) - np.pi) < 1e-5


@pytest.fixture(scope="module")
def tracklets():
    data_cfg = {"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 8}
    ds = SyntheticTrackingDataset(dict(data_cfg), training=False)
    return [ds.get_test_item(i) for i in range(ds.num_tracklets)], make_tracklets(data_cfg)


# ----------------------------------------------------------- the body, eagerly


@pytest.mark.parametrize("ref,agg", MODES)
def test_step_body_matches_jax(monkeypatch, tracklets, ref, agg):
    """The step body under the eager loop, with its up-front draws, tracks
    as the JAX device loop does in every REF_BOX x SHAPE_AGGREGATION mode, with
    the deterministic resample on both sides (the patched one must be reached:
    the body looks it up on the module); centers and yaws within 1e-5."""
    calls = []

    def det_resample(pts, mask, n_out, generator=None, picks=None):
        calls.append((pts.shape[1], n_out, None if picks is None else tuple(picks.shape)))
        return _torch_det_resample(pts, mask, n_out)

    monkeypatch.setattr(jdl, "masked_resample_auto", _jax_det_resample)
    monkeypatch.setattr(tdl, "masked_resample", det_resample)
    jtracklets, ttracklets = tracklets
    jcfg, cfg = _cfgs(ref, agg)
    jres = jdl.DeviceTrackingEvaluator(jcfg, JaxPointModel(), {}, max_points=512, batch_size=2).track_batch(jtracklets)
    ev = tdl.DeviceTrackingEvaluator(cfg, TorchPointModel(), max_points=512, batch_size=2, device="cpu")
    tres = ev.track_batch(ttracklets)
    _assert_tracks_close(jres, tres, [8, 8])
    steps = 32 - 1  # 8 frames pad to one 32-frame bucket
    S, P = cfg["DATA_CONFIG"]["SEARCH_INPUT_SIZE"], cfg["DATA_CONFIG"]["TEMPLATE_INPUT_SIZE"]
    assert len(calls) == 2 * steps
    assert calls[0::2] == [(calls[0][0], S, (2, S))] * steps  # the search, with the step's picks
    assert all(n_out == P and picks == (2, P) for _, n_out, picks in calls[1::2])
    if agg == "all":  # the template union is the fixed (B, T * N) one at every step
        assert {rows for rows, _, _ in calls[1::2]} == {32 * calls[0][0]}


@pytest.mark.parametrize("quantized", [True, False])
@pytest.mark.parametrize("ref", ["previous_result", "current_gt"])
def test_all_union_matches_growing_union(ref, quantized):
    """'all' masks frames f >= t out of the fixed (B, T * N) union; the loop the
    port ran before, whose union grows by a frame a step, written out here,
    picks the same rows from the same draws (masked_resample takes the
    pick-th valid row, and the frames before t lead both unions): bit-equal."""
    cfg = ptt_config()
    cfg["TEST"].update(REF_BOX=ref, SHAPE_AGGREGATION="all")
    data = cfg["DATA_CONFIG"]
    rng = np.random.default_rng(5)
    B, T, N = 2, 6, 192
    pcs = rng.normal(0, 1.5, (B, T, N, 3)).astype(np.float32)
    pcs[..., 0] += np.linspace(0, 1.0, T)[None, :, None]
    pcs = torch.from_numpy(np.round(pcs / tdl.QUANT_SCALE).astype(np.int16) if quantized else pcs)
    counts = torch.from_numpy(rng.integers(N // 2, N + 1, (B, T)).astype(np.int32))
    init = torch.tensor([[0.0, 0.0, 0.0, 0.1], [0.2, -0.1, 0.0, -0.3]])
    wlhs = torch.tensor([[1.8, 4.2, 1.6], [1.7, 4.0, 1.5]])
    gt = init[:, None, :] + torch.from_numpy(rng.normal(0, 0.05, (B, T, 4)).astype(np.float32))
    model = TorchPointModel()

    loop = tdl.FrameLoop(model, data, cfg["TEST"])
    got, got_scores = loop(pcs, counts, init, wlhs, torch.Generator().manual_seed(3), gt)

    u_search, u_tmpl = loop.draw(torch.Generator().manual_seed(3), B, T, "cpu")
    frames = pcs.float() * tdl.QUANT_SCALE if quantized else pcs
    valid = torch.arange(N)[None, None, :] < counts[:, :, None]
    offsets = float(data.get("SEARCH_BB_OFFSET", 0.0)) + 0.6 * wlhs[:, 1]
    boxes = [init]
    for t in range(1, T):
        ref_boxes = gt[:, t] if ref == "current_gt" else boxes[-1]
        canon, mask = tdl.crop_canonical(frames[:, t], valid[:, t], ref_boxes, wlhs, offsets, loop.search_scale)
        mask &= tdl.precrop_mask(frames[:, t], ref_boxes, wlhs, loop.search_offset, loop.search_scale)
        search, _ = tdl.masked_resample(canon, mask, loop.search_size,
                                        picks=tdl.scale_picks(u_search[t - 1], mask.sum(-1)))
        hist = torch.stack(boxes, 1)  # (B, t, 4): the union grows with t
        canon, mask = tdl.crop_canonical(frames[:, :t].reshape(B * t, N, 3), valid[:, :t].reshape(B * t, N),
                                         hist.reshape(B * t, 4), wlhs.repeat_interleave(t, 0), loop.model_offset,
                                         loop.model_scale)
        canon, mask = canon.reshape(B, t * N, 3), mask.reshape(B, t * N)
        template, _ = tdl.masked_resample(canon, mask, loop.template_size,
                                          picks=tdl.scale_picks(u_tmpl[t - 1], mask.sum(-1)))
        data_out = model({"search_points": search, "template_points": template})["pred_box_data"]
        best = data_out[torch.arange(B), data_out[:, :, 4].argmax(1)]
        boxes.append(tdl.decode_box_offset(ref_boxes, best[:, :4], loop.use_z))
    want = torch.stack(boxes, 1)
    assert torch.equal(got, want)
    assert torch.isinf(got_scores[:, 0]).all() and torch.isfinite(got_scores[:, 1:]).all()
    assert float((want[:, -1, :3] - init[:, :3]).abs().max()) > 0.05  # the boxes moved


@pytest.mark.parametrize("ref", ["previous_result", "previous_gt", "current_gt"])
def test_padded_tracklets_match_jax(ref):
    """A batch of tracklets of 5, 11 and 8 frames (the shorter ones' padded
    frames empty) and a fourth, padded slot: the scored frames of each
    tracklet track as the JAX tracker's, with the constant-offset model."""
    lengths = [5, 11, 8]
    ds = SyntheticTrackingDataset({"NUM_TRACKLETS": 3, "FRAMES_PER_TRACKLET": 11}, training=False)
    ours = make_tracklets({"NUM_TRACKLETS": 3, "FRAMES_PER_TRACKLET": 11})

    def cut(trks):
        return [(pcs[:n], boxes[:n], annos[:n]) for (pcs, boxes, annos), n in zip(trks, lengths)]

    jcfg, cfg = _cfgs(ref, "firstandprevious")
    jres = jdl.DeviceTrackingEvaluator(jcfg, JaxConstOffsetModel(), {}, max_points=1024, batch_size=4).track_batch(
        cut([ds.get_test_item(i) for i in range(3)]))
    ev = tdl.DeviceTrackingEvaluator(cfg, TorchConstOffsetModel(), max_points=1024, batch_size=4, device="cpu")
    _assert_tracks_close(jres, ev.track_batch(cut(ours)), lengths)
    assert ev.summary()["frames"] == sum(lengths)


# ------------------------------------------------------------ key, cache, loop


class _Switched(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.inner = torch.nn.Linear(3, 3)
        self.inner.use_kernels = True


def test_graph_key():
    """The key holds what the JAX jit retraces on, and the model's kernel
    switches, mode and parameter addresses."""
    model = _Switched().eval()
    pcs = torch.zeros(2, 32, 256, 3, dtype=torch.int16)
    key = tdl.tracker_graph_key(pcs, False, model)
    assert key == tdl.tracker_graph_key(torch.ones_like(pcs), False, model)  # values do not matter
    others = [tdl.tracker_graph_key(torch.zeros(3, 32, 256, 3, dtype=torch.int16), False, model),
              tdl.tracker_graph_key(torch.zeros(2, 64, 256, 3, dtype=torch.int16), False, model),
              tdl.tracker_graph_key(torch.zeros(2, 32, 512, 3, dtype=torch.int16), False, model),
              tdl.tracker_graph_key(pcs.float(), False, model),
              tdl.tracker_graph_key(pcs, True, model)]
    model.inner.use_kernels = False
    others.append(tdl.tracker_graph_key(pcs, False, model))
    model.inner.use_kernels = True
    model.train()
    others.append(tdl.tracker_graph_key(pcs, False, model))
    model.eval()
    with torch.no_grad():
        model.inner.weight.copy_(torch.ones(3, 3))  # in place: the graph reads the new weights
    assert tdl.tracker_graph_key(pcs, False, model) == key
    model.inner.weight.data = model.inner.weight.data.clone()  # moved: a new capture
    others.append(tdl.tracker_graph_key(pcs, False, model))
    assert len({key, *others}) == len(others) + 1


class _Entry:
    def __init__(self, name, log):
        self.name, self.log = name, log

    def release(self):
        self.log.append(self.name)


def test_graph_cache_evicts_least_recently_used():
    released = []
    cache = cuda_graph.GraphCache(2)
    cache.put("a", _Entry("a", released))
    cache.put("b", _Entry("b", released))
    assert cache.get("a").name == "a"  # a is now the most recently used
    cache.put("c", _Entry("c", released))
    assert released == ["b"] and len(cache) == 2 and cache.get("b") is None
    cache.put("d", _Entry("d", released))
    assert released == ["b", "a"] and len(cache) == 2 and cache.captures == 4
    cache.clear()
    assert released == ["b", "a", "c", "d"] and len(cache) == 0


class _StubGraph:
    """StepGraph without CUDA: the eager first run, then the body at each replay."""
    made = []

    def __init__(self, body, device):
        self.body, self.replays, self.released = body, 0, False
        self.first = body()
        _StubGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.body()

    def release(self):
        self.released = True


class _Graphed(tdl.DeviceTrackingEvaluator):
    def _track(self, batch):
        return self._track_graphed(batch)


@pytest.mark.parametrize("agg", ["firstandprevious", "all"])
def test_graphed_loop_with_stub_capture(monkeypatch, agg):
    """The graphed loop's control flow: a new batch shape runs frame step 1
    eagerly and replays T - 2 times, a cached one replays T - 1 times, and the
    boxes equal the eager loop's from the same seed; the cache keeps at most
    its size of shapes and releases the evicted one, and ``close`` releases the
    rest."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    cfg = ptt_config()
    cfg["TEST"]["SHAPE_AGGREGATION"] = agg
    short = make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 6})
    long = make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 40})
    eager = tdl.DeviceTrackingEvaluator(cfg, TorchPointModel(), max_points=512, batch_size=2, device="cpu")
    graphed = _Graphed(cfg, TorchPointModel(), max_points=512, batch_size=2, device="cpu")
    graphed.graphs.size = 1

    def boxes(ev, trks):
        return ev.finish_batch(ev.dispatch_batch(trks)), ev.boxes(ev.dispatch_batch(trks))

    for trks, T in ((short, 32), (short, 32), (long, 64), (short, 32)):
        (want_res, want), (got_res, got) = boxes(eager, trks), boxes(graphed, trks)
        assert torch.equal(got, want) and got.shape[1] == T
        for a, b in zip(want_res, got_res):
            assert all(np.array_equal(x.center, y.center) for x, y in zip(a, b))
    short_1, long_1, short_2 = _StubGraph.made
    # two batches of the short shape each call: 30 + 31, then 31 + 31 replays; evicted by the long shape
    assert short_1.replays == 30 + 31 + 31 + 31 and short_1.released
    assert long_1.replays == 62 + 63 and long_1.released
    assert short_2.replays == 30 + 31 and not short_2.released
    graphed.close()
    assert short_2.released and len(graphed.graphs) == 0 and graphed.graphs.captures == 3


def test_track_step_on_cpu_is_the_forward():
    """On the CPU the host evaluator's TrackStep runs the forward itself and
    captures nothing."""
    from ptt_tpu_torch.eval.evaluator import TrackStep, best_proposal

    step = TrackStep(TorchPointModel())
    rng = np.random.default_rng(2)
    s = torch.from_numpy(rng.normal(size=(1, 64, 3)).astype(np.float32))
    t = torch.from_numpy(rng.normal(size=(1, 32, 3)).astype(np.float32))
    got = step(s, t)
    assert got.shape == (5,) and torch.equal(got, best_proposal(TorchPointModel(), s, t))
    assert len(step.graphs) == 0
