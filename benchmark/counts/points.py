"""Points a ball query must scan: for each center, the cloud's points up to
and including its ``nsample``-th hit (every point where it has fewer). A copy
of ``chip_smoke.py``'s ``scanned_points`` on the reference's distances."""

from __future__ import annotations

import torch

from ..reference.model import radius_sq, square_distance


def scanned_points(xyz, centers, radius: float, nsample: int) -> int:
    N = xyz.shape[1]
    hits = (square_distance(centers, xyz) < radius_sq(radius)).cumsum(-1)
    reached = hits >= nsample
    return int(torch.where(reached.any(-1), reached.float().argmax(-1) + 1,
                           torch.full_like(hits[..., 0], N)).sum())
