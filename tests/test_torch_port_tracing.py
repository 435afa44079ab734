"""The port's spans and counters (``ptt_tpu_torch/utils/timer.py``) on the CPU:
nothing recorded and no ``record_function`` entered or clock read while
tracing is off; each span a ``ptt.`` annotation of a profiler's trace, on its
clock; parents, request ids, self time, the buffer's bound; the spans of the
device evaluator, the frame loop, the trainer's loop, the train step and a
graph's capture; the host evaluator's table; and the counters behind
``tools.kernel_launches`` and the CLIs' summaries."""

import collections
import json
import logging
import time

import numpy as np
import pytest
import torch

from ptt_tpu_torch import native
from ptt_tpu_torch.config import ptt_config, ptt_synth_config
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset, make_tracklets
from ptt_tpu_torch.eval import device_loop as tdl
from ptt_tpu_torch.eval.evaluator import eval_one_epoch
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.ops import _build
from ptt_tpu_torch.tools import build_counts, kernel_launches
from ptt_tpu_torch.tools.test_tracking import point_split_counts
from ptt_tpu_torch.train.optim import Optimizer
from ptt_tpu_torch.train.train_step import BatchUploader, make_multi_step, make_train_step
from ptt_tpu_torch.train.trainer import pipelined_steps
from ptt_tpu_torch.utils import cuda_graph, profiling, timer
from tests.test_torch_port_train import narrow_model_cfg, small_data_cfg

torch.set_num_threads(1)

T_PAD = 32  # the tracklets below pad to one frame bucket
EVALUATOR_SPANS = {"evaluator.dispatch", "evaluator.pack", "frame_loop.load", "frame_loop.steps", "evaluator.score"}
TRAINER_SPANS = {"trainer.steps", "trainer.fetch", "trainer.upload", "train_step.dispatch"}


class ConstOffsetModel(torch.nn.Module):
    """A fixed canonical-frame offset whatever the points."""

    def forward(self, batch):
        data = torch.zeros(batch["search_points"].shape[0], 64, 5)
        data[:, :, :4] = torch.tensor([0.12, -0.05, 0.02, 3.0])
        return {"pred_box_data": data}


@pytest.fixture(autouse=True)
def fresh_registry():
    timer.reset()
    yield
    timer.reset()


@pytest.fixture(scope="module")
def tracklets():
    return make_tracklets({"NUM_TRACKLETS": 2, "FRAMES_PER_TRACKLET": 6})


@pytest.fixture(scope="module")
def train_setup():
    model_cfg = narrow_model_cfg()
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg()), 4, drop_last=True, num_workers=0)
    batches = [batch for _, batch in zip(range(3), loader)]
    return model_cfg, batches


def run_evaluator(tracklets, batches: int = 2):
    """Batches dispatched two deep, as the test CLI and the benchmark run them."""
    ev = tdl.DeviceTrackingEvaluator(ptt_config(), ConstOffsetModel(), max_points=512, batch_size=2, device="cpu")
    in_flight = None
    for _ in range(batches):
        handle = ev.dispatch_batch(tracklets)
        if in_flight is not None:
            ev.finish_batch(in_flight)
        in_flight = handle
    ev.finish_batch(in_flight)
    return ev


def run_trainer(train_setup, k: int = 1):
    model_cfg, batches = train_setup
    torch.manual_seed(0)
    model = build_network(model_cfg, device="cpu", train=True)
    opt = Optimizer(model.parameters(), ptt_synth_config()["OPTIMIZATION"], len(batches))
    multi = make_multi_step(model_cfg, k, device="cpu") if k > 1 else None
    return pipelined_steps(make_train_step(model_cfg, device="cpu"), model, opt, batches, BatchUploader("cpu"),
                           multi_step=multi), opt


# -------------------------------------------------------------- tracing off


@pytest.mark.parametrize("path", ["span", "evaluator", "trainer"])
def test_tracing_off_records_nothing_and_enters_no_record_function(monkeypatch, tracklets, train_setup, path):
    """With no profiler and no ``tracing()`` block, a span is a flag check:
    no span recorded, ``record_function`` never entered, the clock never read
    by the registry; the counters still count."""
    entered, clocks = [], []
    real_annotation, real_time_ns = profiling.annotation, time.time_ns
    monkeypatch.setattr(profiling, "annotation", lambda name: entered.append(name) or real_annotation(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **kw: entered.append(a) or pytest.fail("record_function entered"))
    monkeypatch.setattr(time, "time_ns", lambda: clocks.append(1) or real_time_ns())
    assert not timer._forced and not torch.autograd._profiler_enabled()
    if path == "span":
        with timer.span("a", request=1) as span:
            assert span is None
        timer.count("x", 3)
        assert timer.counter("x") == 3
    elif path == "evaluator":
        run_evaluator(tracklets)
    else:
        run_trainer(train_setup)
    assert timer.spans() == [] and entered == [] and clocks == []


# ------------------------------------------------------------- on the trace


@pytest.mark.parametrize("path", ["evaluator", "trainer"])
def test_profiler_trace_holds_each_span_on_its_clock(tmp_path, tracklets, train_setup, path):
    """Inside a profiler session (``profiling.trace``) every span is also a
    ``ptt.<name>`` user annotation of the Chrome trace, and the span's Unix
    start is the annotation's ``ts`` + ``baseTimeNanoseconds`` / 1e3 within
    1 ms: the device trace's clock up to one constant."""
    with profiling.trace(tmp_path):
        if path == "evaluator":
            run_evaluator(tracklets)
        else:
            run_trainer(train_setup)
    trace = json.loads((tmp_path / "trace.json").read_text())
    base_us = trace["baseTimeNanoseconds"] / 1e3
    notes = collections.defaultdict(list)
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("ptt."):
            notes[e["name"][4:]].append(e["ts"] + base_us)
    spans = timer.spans()
    assert {s.name for s in spans} == (EVALUATOR_SPANS if path == "evaluator" else TRAINER_SPANS)
    for name in {s.name for s in spans}:
        starts = sorted(s.start_ns / 1e3 for s in spans if s.name == name)
        assert len(starts) == len(notes[name])
        assert max(abs(a - b) for a, b in zip(starts, sorted(notes[name]))) < 1e3, name


# -------------------------------------------------------------- the records


def test_parents_requests_and_self_time():
    """A span's parent is the span open around it, its request id is its
    parent's unless given, and its self time is its duration less its
    children's."""
    with timer.tracing():
        with timer.span("outer", request=7):
            with timer.span("inner", n=3):
                time.sleep(0.02)
            with timer.span("other", request=8) as span:
                span.n = 5
            time.sleep(0.01)
    inner, other, outer = timer.spans()
    assert (inner.name, other.name, outer.name) == ("inner", "other", "outer")
    assert inner.parent == other.parent == outer.id and outer.parent is None
    assert (inner.request, other.request, outer.request) == (7, 8, 7) and (inner.n, other.n) == (3, 5)
    assert inner.self_ns == inner.end_ns - inner.start_ns >= 20_000_000
    children = (inner.end_ns - inner.start_ns) + (other.end_ns - other.start_ns)
    assert outer.self_ns == outer.end_ns - outer.start_ns - children >= 10_000_000
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= other.start_ns < other.end_ns <= outer.end_ns


def test_buffer_keeps_the_newest_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(timer, "_spans", collections.deque(maxlen=3))
    with timer.tracing():
        for i in range(5):
            with timer.span(f"s{i}"):
                pass
    assert [s.name for s in timer.spans()] == ["s2", "s3", "s4"] and timer.dropped() == 2
    timer.reset()
    assert timer.spans() == [] and timer.dropped() == 0


# --------------------------------------------------------- the layers' spans


def test_device_evaluator_spans(tracklets):
    """Each dispatch is an ``evaluator.dispatch`` whose request id its
    children and its batch's ``evaluator.score`` share; ``frame_loop.steps``
    counts the batch's T - 1 frame steps and ``evaluator.score`` its frames;
    on the CPU nothing waits (``evaluator.wait`` only while a batch's event
    has not happened)."""
    with timer.tracing():
        run_evaluator(tracklets, batches=3)
    spans = timer.spans()
    by_id = {s.id: s for s in spans}
    dispatches = [s for s in spans if s.name == "evaluator.dispatch"]
    assert [s.request for s in dispatches] == [0, 1, 2]
    for d in dispatches:
        children = sorted((s.name, s.n) for s in spans if s.parent == d.id)
        assert children == [("evaluator.pack", None), ("frame_loop.load", None), ("frame_loop.steps", T_PAD - 1)]
        assert all(by_id[s.parent].request == s.request for s in spans if s.parent == d.id)
    scores = [s for s in spans if s.name == "evaluator.score"]
    assert [s.request for s in scores] == [0, 1, 2] and all(s.parent is None for s in scores)
    assert all(s.n == sum(len(t[0]) for t in tracklets) for s in scores)
    assert {s.name for s in spans} == EVALUATOR_SPANS


class _Event:
    def __init__(self, done):
        self.done, self.waited = done, False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True


@pytest.mark.parametrize("done", [False, True])
def test_wait_span_only_while_the_batch_is_out(done):
    handle = tdl.Dispatched(torch.zeros(1, 2, 4), _Event(done), [], 5)
    with timer.tracing():
        tdl.DeviceTrackingEvaluator.boxes(handle)
    assert handle.done.waited is not done
    assert [(s.name, s.request) for s in timer.spans()] == ([] if done else [("evaluator.wait", 5)])


@pytest.mark.parametrize("k", [1, 2])
def test_pipelined_steps_spans(train_setup, k):
    """``trainer.steps`` around the pass (``n`` its steps); a
    ``trainer.fetch`` a group and one past the last; a ``trainer.upload`` a
    group with the bytes it staged; a ``train_step.dispatch`` a dispatch with
    its K; each with the index of its first step as request id, the fetch,
    upload and dispatch of one group alike."""
    batches = train_setup[1]
    with timer.tracing():
        history, opt = run_trainer(train_setup, k)
    spans = timer.spans()
    steps = [s for s in spans if s.name == "trainer.steps"]
    assert len(steps) == 1 and steps[0].n == len(history) == len(batches) == opt.count
    inside = [s for s in spans if s.name != "trainer.steps"]
    assert all(s.parent == steps[0].id for s in inside)
    groups = [0, 2] if k == 2 else [0, 1, 2]  # three batches: one K = 2 dispatch and a tail step
    assert [s.request for s in spans if s.name == "trainer.fetch"] == groups + [len(batches)]
    uploads = [s for s in spans if s.name == "trainer.upload"]
    assert [s.request for s in uploads] == groups
    sizes = [min(k, len(batches) - g) for g in groups]
    one = sum(v.nbytes for v in batches[0].values())
    assert [s.n for s in uploads] == [n * one for n in sizes]
    dispatches = [(s.request, s.n) for s in spans if s.name == "train_step.dispatch"]
    assert dispatches == ([(0, 2), (2, 1)] if k == 2 else [(0, 1), (1, 1), (2, 1)])


class _BodyGraph:
    """A ``StepGraph`` without CUDA: its body runs at the capture and at each
    replay."""

    def __init__(self, body, device, context=None):
        self.body = body
        self.first = self.output = body()

    def replay(self):
        self.output = self.body()

    def release(self):
        pass


def test_train_step_replay_is_a_child_of_the_dispatch(monkeypatch, train_setup):
    """A graphed dispatch's replay (the graph's launch and the copy of its
    metrics) is the span ``train_step.replay`` inside its
    ``train_step.dispatch``, with its request id, so that the dispatch's self
    time leaves the launch out; the first dispatch captures and has none."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _BodyGraph)
    model_cfg, batches = train_setup
    torch.manual_seed(0)
    model = build_network(model_cfg, device="cpu", train=True)
    opt = Optimizer(model.parameters(), ptt_synth_config()["OPTIMIZATION"], len(batches))
    step = make_train_step(model_cfg, device="cpu")
    step.steps.graphed = True
    with timer.tracing():
        history = pipelined_steps(step, model, opt, batches, BatchUploader("cpu"))
    assert len(history) == len(batches) and all(torch.isfinite(m["loss"]) for m in history)
    spans = timer.spans()
    dispatches = [s for s in spans if s.name == "train_step.dispatch"]
    replays = [s for s in spans if s.name == "train_step.replay"]
    assert len(dispatches) == len(batches) and [r.parent for r in replays] == [d.id for d in dispatches[1:]]
    assert [r.request for r in replays] == [1, 2]
    for d, r in zip(dispatches[1:], replays):
        assert d.start_ns <= r.start_ns < r.end_ns <= d.end_ns
        assert d.self_ns == (d.end_ns - d.start_ns) - (r.end_ns - r.start_ns)


def test_graph_capture_span_and_counter(monkeypatch):
    """A ``StepGraph``'s eager run and capture is one ``graph.capture`` span
    and one ``graph.captures``; a replay advances the launch counters by what
    the capture counted."""
    def capture(self, body, device, context):
        self.first = self.output = body()
        self.launches = (2, 7, 0, 0, 8)
        self.graph = type("G", (), {"replay": lambda g: None})()

    monkeypatch.setattr(cuda_graph.StepGraph, "_capture", capture)
    with timer.tracing():
        g = cuda_graph.StepGraph(lambda: timer.count("body"), "cpu")
    assert [s.name for s in timer.spans()] == ["graph.capture"] and timer.counter("body") == 1
    for _ in range(3):
        g.replay()
    assert build_counts() == {"graph_captures": 1, "kernel_builds": 0}
    assert kernel_launches() == {"fps": 6, "sa": 21, "group_fwd": 0, "group_bwd": 0, "tf32x3": 24}
    assert cuda_graph.read_launches() == (6, 21, 0, 0, 24)


# ----------------------------------------------------------------- counters


def test_kernel_launches_and_split_counts_read_as_before():
    """``tools.kernel_launches``, ``cuda_graph.read_launches`` and the test
    CLI's ``point_split_counts`` keep their keys and values over the
    registry's counters; ``timer.reset`` zeroes them."""
    assert kernel_launches() == {"fps": 0, "sa": 0, "group_fwd": 0, "group_bwd": 0, "tf32x3": 0}
    assert point_split_counts() == {"gathers": 0, "gathered_bytes": 0, "sa_split": {}}
    for name, n in (("launches.fps", 2), ("launches.sa", 7), ("launches.group_fwd", 7), ("launches.group_bwd", 7),
                    ("launches.tf32x3", 8), ("launches.sa_split.1024", 2), ("launches.sa_split.2048", 1), ("mesh.gathers", 4),
                    ("mesh.gathered_bytes", 4096)):
        timer.count(name, n)
    assert kernel_launches() == {"fps": 2, "sa": 7, "group_fwd": 7, "group_bwd": 7, "tf32x3": 8}
    assert cuda_graph.read_launches() == (2, 7, 7, 7, 8)
    assert point_split_counts() == {"gathers": 4, "gathered_bytes": 4096, "sa_split": {1024: 2, 2048: 1}}
    assert timer.counters("launches.sa_split.") == {"launches.sa_split.1024": 2, "launches.sa_split.2048": 1}
    timer.reset()
    assert kernel_launches() == {"fps": 0, "sa": 0, "group_fwd": 0, "group_bwd": 0, "tf32x3": 0}


def test_native_build_counts_a_kernel_build(monkeypatch, tmp_path):
    """A ``g++`` build of the native host library counts one
    ``kernels.builds``; a library already there counts none."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    native.build()
    native.build()
    assert build_counts() == {"graph_captures": 0, "kernel_builds": 1}


# -------------------------------------------------------- the host evaluator


def test_host_evaluator_table(tracklets):
    """``eval_one_epoch`` traces its frames inside ``tracing()``: its
    ``print_stats`` table has the three sections of each tracked frame, in
    the reference's columns, self times summing to the total row; outside it
    nothing is recorded."""
    lines = []
    logger = logging.getLogger("test_torch_port_tracing")
    logger.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logger.addHandler(handler)
    try:
        eval_one_epoch(ptt_config(), ConstOffsetModel(), [tracklets], logger=logger, device="cpu")
    finally:
        logger.removeHandler(handler)
    start = lines.index(next(line for line in lines if line.startswith("Name")))
    header, rule, *rows, rule2, total = lines[start:start + 7]
    assert header.split() == ["Name", "Total(s)", "Calls", "Mean(ms)"] and set(rule) == set(rule2) == {"-"}
    frames = sum(len(t[0]) - 1 for t in tracklets)
    parsed = {}
    for row in rows:
        *name, tot, calls, mean = row.split()
        parsed[" ".join(name)] = (float(tot), int(calls), float(mean))
    assert set(parsed) == {"pre process", "model inference", "post process"}
    assert all(calls == frames for _, calls, _ in parsed.values())
    assert total.split()[0] == "total" and abs(float(total.split()[1]) - sum(t for t, _, _ in parsed.values())) < 5e-3
    n = len(timer.spans())
    with timer.span("after"):
        pass
    assert n == 3 * frames and len(timer.spans()) == n and np.isfinite(parsed["pre process"][2])
