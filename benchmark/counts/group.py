"""Bytes and operations of one grouped first linear layer of a train-mode
set-abstraction stage (``group.cu``): copies of ``chip_smoke.py``'s
``group_fwd_bound`` and ``group_bwd_bound``, float32 throughout.

Forward: the points, centers, the per-point projection (B, N, H), the
centers' (B, M, H), the grouped output (B, nsample, M, H) and the neighbour
table read or written once; operations 14 a scanned point and one add per
output element. Backward: the output's gradient and the table read, the
points' gradient (B, N, H) written; one add per output element.
"""

from __future__ import annotations

from .points import scanned_points


def group_fwd_counts(xyz, centers, H: int, radius: float, nsample: int):
    B, N, _ = xyz.shape
    M = centers.shape[1]
    nbytes = 4 * (B * N * 3 + B * M * 3 + B * N * H + B * M * H + B * nsample * M * H + B * M * nsample)
    return nbytes, 14 * scanned_points(xyz, centers, radius, nsample) + B * nsample * M * H


def group_bwd_counts(B: int, N: int, M: int, nsample: int, H: int):
    return 4 * (B * nsample * M * H + B * M * nsample + B * N * H), B * nsample * M * H
