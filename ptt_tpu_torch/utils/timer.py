"""The port's spans and counters: one registry for the process.

A span (``span(name, request, n)``, a context manager; ``env`` is the same)
records its name, its start and end in ``time.time_ns()``, its parent (the
span open around it on this thread), a request id (inherited from the parent
when not given: the spans of one tracker batch or one train dispatch share
it), an optional count ``n`` of the work it did, and its self time: its
duration less the part its children cover. ``print_stats`` prints the self
times by name, the reference's ptt/utils/timer_utils.py table.

A span records only while tracing is on: while a ``torch.profiler`` session
is active (``torch.autograd._profiler_enabled()``: ``utils/profiling.py``
``device_window`` and ``trace``, or any other), or inside a ``tracing()``
block. While a profiler is active a span is also a ``record_function`` named
``ptt.<name>``, so it shows on the trace's timeline beside the device's work.
When tracing is off, a span is one flag check: no ``record_function``, no
clock read, no record. Spans are stamped with the Unix clock, which is the
clock Kineto stamps a trace's host events with (``ts`` +
``baseTimeNanoseconds`` / 1e3 in its Chrome trace), so a recorded span lies
on the device trace's timeline up to one constant a process.

Recorded spans are kept in a buffer of the last ``SPAN_BUFFER`` (the oldest
dropped, the drops counted) until ``reset``. Counters (``count``) are plain
integers, always on and cumulative for the process: the kernels' launches,
graph captures, kernel builds, the point group's gathers.

Callers timing device work must wait for it inside the span; otherwise
asynchronous launches make every span look free (the port's spans time the
host's enqueue, and the device's activity is in the trace).
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from typing import NamedTuple

import torch

from .profiling import annotation

SPAN_BUFFER = 65536  # spans kept

_profiler_enabled = torch.autograd._profiler_enabled


class Span(NamedTuple):
    """A recorded span; times in Unix nanoseconds."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None  # the id of the span open around it, or None
    request: object  # the id of the batch or dispatch it served, or None
    n: int | None  # work done: replays, frames, steps, bytes
    self_ns: int  # the duration less its children's


_spans: collections.deque = collections.deque(maxlen=SPAN_BUFFER)
_totals: dict = {}  # name -> [self ns, calls], for print_stats
_counters: dict = {}
_dropped = 0
_forced = 0  # open tracing() blocks
_ids = itertools.count()
_local = threading.local()


class _Off:
    """What ``span`` returns while tracing is off: enters as None."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Open:
    """A span being recorded; ``n`` may be set inside the block."""

    __slots__ = ("name", "request", "n", "id", "parent", "start", "child_ns", "annotation")

    def __init__(self, name, request, n):
        self.name, self.request, self.n = name, request, n

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        parent = stack[-1] if stack else None
        self.parent = None if parent is None else parent.id
        if self.request is None and parent is not None:
            self.request = parent.request
        self.id = next(_ids)
        self.child_ns = 0
        stack.append(self)
        self.start = time.time_ns()  # before the annotation, whose first entry of a name is slow
        self.annotation = annotation("ptt." + self.name) if _profiler_enabled() else None
        if self.annotation is not None:
            self.annotation.__enter__()
        return self

    def __exit__(self, *exc):
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        end = time.time_ns()
        stack = _local.stack
        stack.pop()
        duration = end - self.start
        if stack:
            stack[-1].child_ns += duration
        _record(Span(self.name, self.start, end, self.id, self.parent, self.request, self.n,
                     duration - self.child_ns))
        return False


def _record(s: Span) -> None:
    global _dropped
    if len(_spans) == _spans.maxlen:
        _dropped += 1
    _spans.append(s)
    total = _totals.setdefault(s.name, [0, 0])
    total[0] += s.self_ns
    total[1] += 1


def span(name: str, request=None, n=None):
    """A span named ``name`` over a ``with`` block, recorded while tracing is
    on; ``as`` gives the open span (its ``n`` may be set in the block), or
    None while tracing is off."""
    if not _forced and not _profiler_enabled():
        return _OFF
    return _Open(name, request, n)


env = span  # the reference's name


@contextmanager
def tracing():
    """Spans record inside the block, with no profiler running."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


def spans() -> list:
    """The recorded spans, oldest first."""
    return list(_spans)


def dropped() -> int:
    """Spans dropped from the full buffer since the last ``reset``."""
    return _dropped


def count(name: str, n: int = 1) -> None:
    _counters[name] = _counters.get(name, 0) + n


def counter(name: str) -> int:
    return _counters.get(name, 0)


def counters(prefix: str = "") -> dict:
    """The counters whose name starts with ``prefix``."""
    return {k: v for k, v in _counters.items() if k.startswith(prefix)}


def reset(counters: bool = True) -> None:
    """Forget every span and total, and unless ``counters`` is False every
    counter."""
    global _dropped
    _spans.clear()
    _totals.clear()
    if counters:
        _counters.clear()
    _dropped = 0


def print_stats(logger=None):
    """Per-name table of the spans' self times: total seconds, calls, mean ms
    (reference :104-127)."""
    emit = logger.info if logger is not None else print
    if not _totals:
        emit(" no timers recorded ")
        return
    name_w = max(len(n) for n in _totals) + 2
    header = f"{'Name':<{name_w}}{'Total(s)':>10}{'Calls':>8}{'Mean(ms)':>11}"
    emit(header)
    emit("-" * len(header))
    for name in sorted(_totals, key=lambda k: _totals[k][0], reverse=True):
        ns, calls = _totals[name]
        emit(f"{name:<{name_w}}{ns / 1e9:>10.3f}{calls:>8}{ns / 1e6 / max(1, calls):>11.2f}")
    emit("-" * len(header))
    emit(f"{'total':<{name_w}}{sum(ns for ns, _ in _totals.values()) / 1e9:>10.3f}")
