"""The program's own spans (``ptt_tpu_torch/utils/timer.py``) on the traced
window's clock, for the per-layer metrics that read them.

The program stamps its spans with the Unix clock; the trace's events are in
microseconds from a base time that ``trace.read_events`` does not keep. Each
of the program's outermost spans runs inside one of the benchmark's own
(``evaluator.dispatch`` inside ``bench.dispatch``, ``trainer.steps`` inside
``bench.steps``). The program records spans only while a profiler session is
active, and the trace holds only the last session (the window kept), so the
last spans of such a name are those of the trace's benchmark spans of its
pair, in order. The constant between the two clocks is the median (the lower
of two middle ones) of the differences of their starts; the time from the
benchmark's span's start to the program's (a few microseconds) is thus
counted in it. Only the spans that then fall inside the traced sub-window are
kept, so that the spans of a window taken again (``profiler_retakes``) drop
out.

Where the program has no spans (a program without ``timer.spans``), or too
few to pair with the benchmark's, the readings are None.
"""

from __future__ import annotations

import statistics
import sys
from typing import NamedTuple

from benchmark.trace import SPAN_PREFIX, idle_gaps

# the benchmark's span -> the program's span that each one encloses
PAIRS = {"dispatch": "evaluator.dispatch", "steps": "trainer.steps"}


class Placed(NamedTuple):
    """A program span on the trace's clock (microseconds)."""

    name: str
    start_us: float
    end_us: float
    n: int | None
    self_us: float  # the duration less its children's

    @property
    def dur_us(self) -> float:
        return self.end_us - self.start_us


class Aligned(NamedTuple):
    spans: list  # the Placed spans inside the traced sub-window, by start
    offset_us: float  # program clock minus trace clock
    spread_us: float  # the largest less the least start difference of the pairs
    pairs: int


def program_spans():
    """The spans the program recorded in this process, or None where it has
    no span registry."""
    try:
        from ptt_tpu_torch.utils import timer
    except ImportError:
        return None
    read = getattr(timer, "spans", None)
    return None if read is None else read()


def align(events, window, spans) -> Aligned | None:
    """``spans`` (the program's) on the trace's clock, those inside
    ``window``; None without a pair."""
    diffs = []  # in integer nanoseconds: a Unix time in microseconds is a float with a quarter-microsecond step
    for bench_name, prog_name in PAIRS.items():
        bench = [round(e.start_us * 1e3) for e in events if e.kind == "span" and e.name == SPAN_PREFIX + bench_name]
        prog = sorted(s.start_ns for s in spans if s.name == prog_name)
        if bench and len(prog) >= len(bench):
            diffs += [p - b for b, p in zip(bench, prog[-len(bench):])]
    if not diffs:
        return None
    offset = statistics.median_low(diffs)
    placed = [Placed(s.name, (s.start_ns - offset) / 1e3, (s.end_ns - offset) / 1e3, s.n, s.self_ns / 1e3)
              for s in spans]
    kept = sorted((p for p in placed if p.start_us >= window.start_us and p.end_us <= window.end_us),
                  key=lambda p: p.start_us)
    return Aligned(kept, offset / 1e3, (max(diffs) - min(diffs)) / 1e3, len(diffs))


def window_spans(layer) -> list | None:
    """The program's spans in the traced sub-window of ``layer["traced"]``,
    aligned at the first call and kept in ``layer`` for the other readers
    (the alignment said on standard error)."""
    traced = layer.get("traced")
    if traced is None:
        return None
    if "program_spans" not in layer:
        spans = program_spans()
        aligned = None if spans is None else align(traced.events, traced.window, spans)
        if aligned is not None:
            print(f"program spans: {aligned.pairs} pairs with the benchmark's, clock offset spread "
                  f"{aligned.spread_us:.1f} us, {len(aligned.spans)} spans in the traced window", file=sys.stderr)
        layer["program_spans"] = aligned
    aligned = layer["program_spans"]
    return None if aligned is None else aligned.spans


def mean_ms(layer, name: str) -> float | None:
    """The mean duration in ms of the window's spans ``name``."""
    durs = [s.dur_us for s in window_spans(layer) or () if s.name == name]
    return sum(durs) / len(durs) / 1e3 if durs else None


def idle_by_span(events, window, spans) -> dict:
    """Microseconds of the window in which the device ran nothing, by the
    innermost program span the host was in then (its name)."""
    out = {}
    for gs, ge in idle_gaps(events, window.start_us, window.end_us):
        over = [s for s in spans if s.start_us < ge and s.end_us > gs]
        cuts = sorted({gs, ge, *(t for s in over for t in (s.start_us, s.end_us) if gs < t < ge)})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            covering = [s for s in over if s.start_us <= mid < s.end_us]
            if covering:
                name = max(covering, key=lambda s: s.start_us).name
                out[name] = out.get(name, 0.0) + (b - a)
    return out


def host_idle_pct(layer, left_out) -> float | None:
    """Share of the traced window, in percent, in which the device ran
    nothing while the host was inside a program span, each idle moment put
    down to the innermost span, those named in ``left_out`` not counted."""
    spans = window_spans(layer)
    if not spans:
        return None
    t = layer["traced"]
    idle = idle_by_span(t.events, t.window, spans)
    return 100.0 * sum(us for name, us in idle.items() if name not in left_out) / t.window.dur_us
