"""The readers of the program's spans on synthetic traces: the pairing of the
program's outermost spans with the benchmark's (the clock offset, a window
taken again left out, a program without spans read as nothing), the
attribution of the device's idle time to the innermost span, and the five
per-layer metrics that read them."""

import json
from types import SimpleNamespace

import pytest

from benchmark import run, spans
from benchmark.trace import Event, Traced
from ptt_tpu_torch.utils.timer import Span

BASE_NS = 1_790_857_026_000_000_000  # the trace's base time: Unix nanoseconds at its 0
DELAY_NS = 20_000  # from a benchmark span's start to that of the program's span inside it
RETAKE_US = 500_000  # a window taken again: its spans this much earlier


def program(name, start, end, n=None, request=None, shift=0, self_us=None):
    """A program span at [start, end] (microseconds) of the trace's clock, as
    the program stamps it, DELAY_NS late; its self time its duration unless
    given."""
    def to_ns(t):
        return (t - shift) * 1000 + BASE_NS + DELAY_NS

    self_ns = (end - start if self_us is None else self_us) * 1000
    return Span(name, to_ns(start), to_ns(end), 0, None, request, n, self_ns)


def bench(name, start, end):
    return Event("bench." + name, "span", start, end - start)


def kernel(start, end):
    return Event("k", "kernel", start, end - start)


def track_trace(retake: bool = False):
    """Two batches of a 10 ms window: each dispatch packs, loads and enqueues
    31 frame steps; the scores; a wait. The device idles in [1150, 1250]
    (pack to 1200, then the dispatch itself), [1950, 2050] (score to 2000,
    then nothing) and [2050, 2150] (the wait)."""
    window = bench("window", 1000, 11000)
    events = [window, bench("dispatch", 1100, 1690), bench("dispatch", 3100, 3690), bench("score", 1690, 2010),
              kernel(1000, 1150), kernel(1250, 1950), kernel(2150, 11000)]
    prog = []
    for shift in ((0, RETAKE_US) if retake else (0,)):
        for k, t in enumerate((1100, 3100)):
            prog += [program("evaluator.pack", t + 30, t + 100, shift=shift),
                     program("frame_loop.load", t + 200, t + 250, shift=shift),
                     program("frame_loop.steps", t + 300, t + 455, 31, shift=shift),
                     program("evaluator.dispatch", t, t + 580, request=k, shift=shift)]
        prog += [program("evaluator.score", 1700, 2000, 48, 0, shift=shift),
                 program("evaluator.wait", 2050, 2150, request=1, shift=shift),
                 program("evaluator.score", 3700, 3800, 48, 1, shift=shift)]
    return {"traced": Traced(sorted(events, key=lambda e: e.start_us), window, 0, None)}, prog


def train_trace():
    """Four steps: a fetch, an upload and a dispatch each, the dispatch 60 us
    of which its graph's launch takes 40; the device idles in [1520, 1540]
    (the first upload), [2000, 2100] (a fetch) and [4980, 5000] (the pass
    until 4990, then the synchronize after it)."""
    window = bench("window", 1000, 5000)
    events = [window, bench("steps", 1000, 4995), kernel(1000, 1520), kernel(1540, 2000), kernel(2100, 4980)]
    prog = [program("trainer.steps", 1000, 4990, 4)]
    for i, t in enumerate((1400, 2000, 3000, 4000)):
        prog += [program("trainer.fetch", t, t + 100, request=i), program("trainer.upload", t + 100, t + 150, 4096, i),
                 program("train_step.dispatch", t + 200, t + 260, 1, i, self_us=20),
                 program("train_step.replay", t + 210, t + 250, request=i)]
    return {"traced": Traced(sorted(events, key=lambda e: e.start_us), window, 0, None)}, prog


def reader(name):
    return run.load_file(run.HERE / "metrics" / f"{name}.py", "benchmark.metrics." + name.replace(".", "_")).read


@pytest.fixture
def recorded(monkeypatch):
    """Stands in for the program's registry: ``recorded(spans)``."""
    def put(prog):
        monkeypatch.setattr(spans, "program_spans", lambda: prog)
    return put


@pytest.mark.parametrize("retake", [False, True])
def test_alignment_pairs_dispatches_and_drops_a_retaken_window(retake):
    layer, prog = track_trace(retake)
    t = layer["traced"]
    aligned = spans.align(t.events, t.window, prog)
    assert aligned.pairs == 2 and aligned.spread_us == pytest.approx(0.0, abs=1e-3)
    assert aligned.offset_us == pytest.approx((BASE_NS + DELAY_NS) / 1e3, abs=1e-3)
    assert len(aligned.spans) == len(prog) // (2 if retake else 1)
    dispatch = [s for s in aligned.spans if s.name == "evaluator.dispatch"]
    assert [(round(s.start_us, 3), round(s.end_us, 3)) for s in dispatch] == [(1100, 1680), (3100, 3680)]


def test_no_program_spans_reads_nothing(recorded):
    layer, _ = track_trace()
    recorded(None)
    assert reader("pack_ms_per_batch.track")(layer) is None and reader("host_idle_pct.track")(layer) is None
    layer, _ = track_trace()
    recorded([program("other", 1200, 1300)])
    assert reader("score_ms_per_batch.track")(layer) is None
    assert reader("host_ms_per_step.train")({"traced": None}) is None


def test_idle_by_innermost_span():
    layer, prog = track_trace()
    t = layer["traced"]
    placed = spans.align(t.events, t.window, prog).spans
    idle = spans.idle_by_span(t.events, t.window, placed)
    assert {k: round(v, 3) for k, v in idle.items()} == {"evaluator.pack": 50.0, "evaluator.dispatch": 50.0,
                                                         "evaluator.score": 50.0, "evaluator.wait": 100.0}


def test_track_readers(recorded):
    layer, prog = track_trace(retake=True)
    recorded(prog)
    assert reader("pack_ms_per_batch.track")(layer) == pytest.approx(0.070)
    assert reader("score_ms_per_batch.track")(layer) == pytest.approx(0.200)
    # 150 us of 10 ms idle in program spans other than the wait
    assert reader("host_idle_pct.track")(layer) == pytest.approx(1.5)


def test_train_readers(recorded):
    layer, prog = train_trace()
    recorded(prog)
    # the uploads and the dispatches' self time, the launches left out
    assert reader("host_ms_per_step.train")(layer) == pytest.approx((4 * 50 + 4 * 20) / 1e3 / 4)
    # the upload's 20 us and the pass's last 10 us; the fetch's 100 us left out: 30 of 4000 us
    assert reader("host_idle_pct.train")(layer) == pytest.approx(100.0 * 30 / 4000)


# ---------------------------------------------------------------- on the card

TABLE = {"evaluator.dispatch", "evaluator.pack", "frame_loop.load", "frame_loop.steps", "evaluator.wait",
         "evaluator.score", "graph.capture", "trainer.steps", "trainer.fetch", "trainer.upload",
         "train_step.dispatch", "train_step.replay"}


def _annotations(path) -> dict:
    """name -> [(start, end)] of the ``ptt.`` annotations of a Chrome trace,
    and the kernels' intervals under ``"kernels"``."""
    out = {"kernels": []}
    for e in json.load(open(path))["traceEvents"]:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("ptt."):
            out.setdefault(e["name"][4:], []).append((e["ts"], e["ts"] + e["dur"]))
        elif e.get("cat") == "kernel":
            out["kernels"].append((e["ts"], e["ts"] + e["dur"]))
    return out


@pytest.mark.chip
def test_program_trace_holds_every_span_on_the_card(cuda_device, tmp_path):
    """A ``profiling.trace`` of the graphed tracker (a batch of a shape met
    for the first time, so captured inside the trace, then one replayed) and
    of the graphed train step holds every span of the program as a ``ptt.``
    annotation; the batch's kernels run after its ``frame_loop.steps``
    starts, and its ``evaluator.wait`` ends with its last kernel."""
    import torch

    from benchmark.gen.tracklets import make_tracklets
    from benchmark.mixes import track, train
    from benchmark.tests._tiny import tiny
    from ptt_tpu_torch.utils import profiling

    seed = 2**31 + 1919

    def setup(mix, cell):
        spec = tiny(run.load_cell(cell))
        return mix.setup(SimpleNamespace(config=spec.config, traffic=spec.traffic, seed=seed, device=cuda_device,
                                         mark=lambda phase: None))

    state = setup(track, "ptt.track")
    longer = make_tracklets(state.B, 40, 600, 400, seed)  # 40 frames pad to 64: a new shape
    with profiling.trace(tmp_path / "track"):
        state.ev.finish_batch(state.ev.dispatch_batch(longer))
        handle = state.ev.dispatch_batch(state.pool[0])
        state.ev.finish_batch(handle)
    torch.cuda.synchronize()
    found = _annotations(tmp_path / "track" / "trace.json")
    steps, wait = found["frame_loop.steps"][-1], found["evaluator.wait"][-1]
    batch = [k for k in found["kernels"] if k[0] >= steps[0] and k[1] <= wait[1] + 50.0]
    assert batch and min(k[0] for k in batch) >= steps[0]
    assert 0.0 <= wait[1] - max(k[1] for k in batch) < 5e3
    state.release()

    state = setup(train, "ptt.train")
    with profiling.trace(tmp_path / "train"):
        state._run(state.pool[:3])
        torch.cuda.synchronize()
    found.update({k: v for k, v in _annotations(tmp_path / "train" / "trace.json").items() if k != "kernels"})
    assert TABLE <= set(found), TABLE - set(found)
    state.release()
