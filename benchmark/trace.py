"""The benchmark's one profiler window: ``torch.profiler`` over a block, read
back from its Chrome trace, with the CUPTI setting a process that replays
CUDA graphs needs. A frozen copy of the port's ``utils/profiling.py`` event
reader and its ``TEARDOWN_CUPTI=0`` (Kineto tears CUPTI down after a trace by
default; late in a process whole windows then came back without the device's
activity), and of ``chip_smoke.py``'s ``traced_window``: a window that shows
no device activity is taken again and counted.

A run opens its window once, after every capture of the run, so that no graph
is released and another captured into a shared pool after CUPTI is set up
(that history has crashed ``cudaGraphLaunch`` inside a later trace). The
trace file goes to a temporary directory under ``TMPDIR`` and is deleted once
read.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import NamedTuple

CUPTI_SETTINGS = {"TEARDOWN_CUPTI": "0"}
RETAKES = 20
_DEVICE_CATS = {"kernel": "kernel", "gpu_memcpy": "memcpy", "gpu_memset": "memset"}
SPAN_PREFIX = "bench."


class Event(NamedTuple):
    """One event of a trace, in the trace's microseconds: a device activity
    (``kind`` kernel, memcpy or memset) or a host one (``kind`` host for an
    operator, span for the benchmark's own spans)."""
    name: str
    kind: str
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


def setup_env() -> None:
    """``CUPTI_SETTINGS`` in the environment before the first session: Kineto
    reads them once, at a process's first trace."""
    for key, value in CUPTI_SETTINGS.items():
        os.environ.setdefault(key, value)


def read_events(path) -> list:
    """The device and host events of a Chrome trace file, by start."""
    with open(path) as fh:
        raw = json.load(fh)["traceEvents"]
    out = []
    for e in raw:
        if "dur" not in e or e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            kind = _DEVICE_CATS[cat]
        elif cat == "user_annotation" and str(e.get("name", "")).startswith(SPAN_PREFIX):
            kind = "span"
        elif cat == "cpu_op":
            kind = "host"
        else:
            continue
        out.append(Event(str(e["name"]), kind, float(e["ts"]), float(e["dur"])))
    return sorted(out, key=lambda ev: ev.start_us)


def span(name: str):
    """A benchmark span in the trace (a ``record_function`` named bench.<name>)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


class Traced(NamedTuple):
    events: list  # every Event of the window
    window: Event  # the bench.window span: the traced sub-window
    retakes: int  # windows taken again because they showed no device activity
    result: object  # what the traced function returned


def traced(fn) -> Traced:
    """``fn()`` in a profiler window, inside a bench.window span, taken again
    (up to RETAKES times, half a second apart) while the window shows no
    device activity. Raises if none does."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    setup_env()
    for attempt in range(RETAKES):
        if attempt:
            time.sleep(0.5)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with span("window"):
                result = fn()
                torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            events = read_events(path)
        window = [e for e in events if e.kind == "span" and e.name == SPAN_PREFIX + "window"]
        if window and any(e.kind in ("kernel", "memcpy", "memset") for e in events):
            return Traced(events, window[0], attempt, result)
    raise RuntimeError(f"the profiler saw no device activity in {RETAKES} windows")


def device_busy_us(events, start_us: float, end_us: float) -> float:
    """Microseconds of [start, end] in which some device activity ran: the
    union of the device events' intervals, clipped to the window."""
    spans = sorted((max(e.start_us, start_us), min(e.end_us, end_us)) for e in events
                   if e.kind in ("kernel", "memcpy", "memset") and e.end_us > start_us and e.start_us < end_us)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def idle_gaps(events, start_us: float, end_us: float) -> list:
    """[(start, end)] of the window in which no device activity ran."""
    dev = sorted((e.start_us, e.end_us) for e in events
                 if e.kind in ("kernel", "memcpy", "memset") and e.end_us > start_us and e.start_us < end_us)
    gaps, cursor = [], start_us
    for s, e in dev:
        if s > cursor:
            gaps.append((cursor, min(s, end_us)))
        cursor = max(cursor, e)
    if cursor < end_us:
        gaps.append((cursor, end_us))
    return gaps


def host_doing(events, start_us: float, end_us: float) -> str:
    """What the host was doing in [start, end]: the benchmark span that
    covers most of it (the innermost of equals), with the host operator that
    overlaps it most."""
    def overlap(e):
        return max(0.0, min(e.end_us, end_us) - max(e.start_us, start_us))

    spans = [e for e in events if e.kind == "span" and e.name != SPAN_PREFIX + "window" and overlap(e) > 0]
    ops = [e for e in events if e.kind == "host" and overlap(e) > 0]
    where = (max(spans, key=lambda e: (overlap(e), -e.dur_us)).name[len(SPAN_PREFIX):] if spans
             else "outside spans")
    if ops:
        return f"{where}: {max(ops, key=overlap).name}"
    return where


def breakdown(events, window: Event, top: int = 10) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps by what the host was doing, in seconds as measured."""
    totals = {}
    for e in events:
        if e.kind in ("kernel", "memcpy", "memset") and window.start_us <= e.start_us < window.end_us:
            totals[e.name] = totals.get(e.name, 0.0) + e.dur_us
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle_gaps(events, window.start_us, window.end_us), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[name, us / 1e6] for name, us in device_ops],
            "idle_gaps": [[host_doing(events, s, e), (e - s) / 1e6] for s, e in gaps]}


def kernel_us(events, window: Event, names) -> float:
    """Summed device time in the window of the kernels whose name contains one
    of ``names``."""
    return sum(e.dur_us for e in events if e.kind == "kernel" and window.start_us <= e.start_us < window.end_us
               and any(n in e.name for n in names))
