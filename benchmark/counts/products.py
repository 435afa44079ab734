"""Bytes and operations of one float32 product that ``csrc/tf32x3.cu`` runs,
``(M, K) @ (K, N)`` with its epilogue, named by the program's shape counter
``launches.tf32x3.<M>x<K>x<N>`` (``ops/linear.py``). Bytes: the input, the
weight and the output once each, in float32; the epilogue's scale and shift
(2 N floats) are left out, so that a bound reads low, never high.
Operations: 2 M K N, the multiply-adds of the product.
"""

from __future__ import annotations

from .peaks import bound_s

PREFIX = "launches.tf32x3."


def product_counts(m: int, k: int, n: int):
    """(bytes, operations) of one M x K x N product."""
    return 4 * (m * k + k * n + m * n), 2 * m * k * n


def shape_of(counter: str):
    """(M, K, N) of a shape counter's name, or None for another counter."""
    if not counter.startswith(PREFIX):
        return None
    parts = counter[len(PREFIX):].split("x")
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        return None
    return tuple(int(p) for p in parts)


def bound_per_step_s(counters: dict, frame_steps: int) -> float | None:
    """The least time of one frame step's products: each shape's bound
    (``counts/peaks.py``) times its calls a frame step, the shape counters'
    calls over ``frame_steps``; None without a shape counter or a frame
    step."""
    shapes = [(shape_of(name), calls) for name, calls in counters.items()]
    shapes = [(s, calls) for s, calls in shapes if s is not None and calls > 0]
    if not shapes or not frame_steps:
        return None
    return sum(bound_s(*product_counts(*s)) * calls for s, calls in shapes) / frame_steps
