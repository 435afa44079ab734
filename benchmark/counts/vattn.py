"""Bytes of one call of the transformer blocks' vector attention that
``csrc/vattn.cu`` runs, its two kernels together, named by the program's
shape counter ``launches.vattn.<Q>x<k>x<d>`` (``ops/vattn.py``; Q = B * N
queries, k neighbours, d channels). The least bytes, each tensor read or
written once in float32 (the indices int32):

- ``vattn_in_kernel``: reads pos and writes fc_gamma's input A, Q k d each;
  reads q and the key projection, Q d each (the blocks attend over their own
  points); reads the indices, Q k;
- ``vattn_out_kernel``: reads fc_gamma's logits and pos, Q k d each; reads
  the value projection and writes the result, Q d each; reads the indices.

Operations, about 11 a (query, neighbour, channel) against 16 bytes, are
never the bound and are left out.
"""

from __future__ import annotations

from .peaks import bound_s

PREFIX = "launches.vattn."


def call_bytes(q: int, k: int, d: int) -> int:
    """Bytes of one call of both kernels at Q = ``q`` queries."""
    return 4 * (4 * q * k * d + 4 * q * d + 2 * q * k)


def shape_of(counter: str):
    """(Q, k, d) of a shape counter's name, or None for another counter."""
    if not counter.startswith(PREFIX):
        return None
    parts = counter[len(PREFIX):].split("x")
    if len(parts) != 3 or not all(p.isdigit() for p in parts):
        return None
    return tuple(int(p) for p in parts)


def bound_per_step_s(counters: dict, frame_steps: int) -> float | None:
    """The least time of one frame step's calls: each shape's bytes at the
    memory peak (``counts/peaks.py``) times its calls a frame step, the shape
    counters' calls over ``frame_steps``; None without a shape counter or a
    frame step."""
    shapes = [(shape_of(name), calls) for name, calls in counters.items()]
    shapes = [(s, calls) for s, calls in shapes if s is not None and calls > 0]
    if not shapes or not frame_steps:
        return None
    return sum(bound_s(call_bytes(*s), 0) * calls for s, calls in shapes) / frame_steps
