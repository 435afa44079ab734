"""Named stack-aware timers (the JAX package's ``utils/timer.py``, a copy of
the reference's ptt/utils/timer_utils.py API): a module-global registry of named
accumulating timers, an ``env(name)`` context manager that pauses the enclosing
timer while a nested one runs (so totals do not double-count), a
``print_stats`` table and ``total_time``. Callers timing device work must wait
for it inside the env (read its result back, or ``torch.cuda.synchronize``);
otherwise asynchronous launches make every section look free.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

_total_times: dict = defaultdict(float)
_counts: dict = defaultdict(int)
_start_times: dict = {}
_timer_stack: list = []
_disabled_names: set = set()


def disable(name: str):
    _disabled_names.add(name)


def enable(name: str):
    _disabled_names.discard(name)


def reset():
    _total_times.clear()
    _counts.clear()
    _start_times.clear()
    _timer_stack.clear()


def start(name: str, use_stack: bool = True):
    if name in _disabled_names:
        return
    if use_stack:
        if _timer_stack:
            _pause(_timer_stack[-1])
        _timer_stack.append(name)
    _start_times[name] = time.perf_counter()


def stop(name: str = None, use_stack: bool = True):
    if use_stack:
        if not _timer_stack:
            return
        name = _timer_stack.pop()
        _settle(name)
        if _timer_stack:
            _resume(_timer_stack[-1])
    else:
        if name in _start_times:
            _settle(name)


def _pause(name: str):
    if name in _start_times:
        _total_times[name] += time.perf_counter() - _start_times.pop(name)


def _resume(name: str):
    _start_times[name] = time.perf_counter()


def _settle(name: str):
    if name in _start_times:
        _total_times[name] += time.perf_counter() - _start_times.pop(name)
        _counts[name] += 1


@contextmanager
def env(name: str, use_stack: bool = True):
    """Time a block under ``name`` (reference :135-152)."""
    start(name, use_stack=use_stack)
    try:
        yield
    finally:
        stop(name if not use_stack else None, use_stack=use_stack)


def total_time() -> float:
    """Sum of all accumulated section times (reference :130)."""
    return sum(_total_times.values())


def get_times() -> dict:
    return dict(_total_times)


def get_counts() -> dict:
    return dict(_counts)


def print_stats(logger=None):
    """Per-section table: total seconds, call count, mean ms (reference :104-127)."""
    emit = logger.info if logger is not None else print
    if not _total_times:
        emit(" no timers recorded ")
        return
    name_w = max(len(n) for n in _total_times) + 2
    header = f"{'Name':<{name_w}}{'Total(s)':>10}{'Calls':>8}{'Mean(ms)':>11}"
    emit(header)
    emit("-" * len(header))
    for name in sorted(_total_times, key=_total_times.get, reverse=True):
        tot = _total_times[name]
        cnt = max(1, _counts[name])
        emit(f"{name:<{name_w}}{tot:>10.3f}{_counts[name]:>8}{tot / cnt * 1e3:>11.2f}")
    emit("-" * len(header))
    emit(f"{'total':<{name_w}}{total_time():>10.3f}")
