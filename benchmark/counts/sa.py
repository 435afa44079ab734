"""Bytes and operations of one eval-mode set-abstraction call (ball query,
grouping, the shared MLP with BatchNorm folded in, the max over the
neighbourhood), counted from its inputs: a copy of ``chip_smoke.py``'s
``sa_bound``. Bytes: the points and features read once, the centers, the
weights and biases, the output written once, in float32. Operations: 14 a
scanned point for the ball query, layer 0 over the points (and the centers'
offsets), the gather, offset and ReLU of every neighbour, each later layer's
multiply-adds and bias-ReLU, the max.

``widths`` are the MLP's output widths, ``c_in`` the features' width (0 at
stage 0); the weights hold (3 + c_in) x w0 + sum w_i x w_(i+1) floats."""

from __future__ import annotations

from .points import scanned_points


def sa_counts(xyz, centers, c_in: int, radius: float, nsample: int, widths):
    B, N, _ = xyz.shape
    M = centers.shape[1]
    dims = [3 + c_in] + list(widths)
    weights = sum(a * b for a, b in zip(dims[:-1], dims[1:]))
    nbytes = 4 * (B * N * (3 + c_in) + B * M * 3 + weights + sum(widths) + B * M * widths[-1])
    ops = 14 * scanned_points(xyz, centers, radius, nsample)
    h1 = widths[0]
    ops += 2 * B * N * (3 + c_in) * h1 + 2 * B * M * 3 * h1
    ops += 2 * B * M * nsample * h1
    for k, c in zip(widths[:-1], widths[1:]):
        ops += 2 * B * M * nsample * k * c + 2 * B * M * nsample * c
    ops += B * M * nsample * widths[-1]
    return nbytes, ops
