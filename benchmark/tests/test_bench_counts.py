"""Each count and peak of ``counts/`` held to a hand-worked value at one
small shape."""

import pytest
import torch

from benchmark.counts import peaks
from benchmark.counts.flops import frame_step_flops
from benchmark.counts.group import group_bwd_counts, group_fwd_counts
from benchmark.counts.points import scanned_points
from benchmark.counts.sa import sa_counts
from benchmark.run import load_cell


def _line():
    # 1 batch row, 4 points on the x axis at 0, 1, 2, 3; centers at 0 and 3
    xyz = torch.tensor([[[0.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [3.0, 0, 0]]])
    return xyz, xyz[:, [0, 3]]


def test_peaks():
    assert peaks.PEAK_BYTES_PER_S == 3.35e12
    assert peaks.PEAK_F32_FLOPS == pytest.approx(165e12)
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 330e12) == pytest.approx(2.0)


def test_scanned_points():
    xyz, ctr = _line()
    # radius 1.5: center 0 hits points 0, 1 (its 2nd hit is point 1: 2 scanned);
    # center 3 hits 2, 3 (its 2nd hit is point 3: 4 scanned)
    assert scanned_points(xyz, ctr, 1.5, 2) == 2 + 4
    # nsample 3 is never reached: every point is scanned for both
    assert scanned_points(xyz, ctr, 1.5, 3) == 4 + 4


def test_sa_counts():
    xyz, ctr = _line()
    nbytes, ops = sa_counts(xyz, ctr, 0, 1.5, 2, [4, 8])
    # bytes: points 4*3, centers 2*3, weights 3*4 + 4*8, biases 4 + 8, output 2*8
    assert nbytes == 4 * (12 + 6 + 12 + 32 + 12 + 16)
    # ops: 14 * 6 scanned; layer 0 over points 2*4*3*4 and centers 2*2*3*4;
    # gather-offset-relu 2*2*2*4; layer 1 2*2*2*4*8 + bias-relu 2*2*2*8; max 2*2*8
    assert ops == 14 * 6 + 96 + 48 + 32 + 256 + 64 + 32


def test_group_counts():
    xyz, ctr = _line()
    nbytes, ops = group_fwd_counts(xyz, ctr, 4, 1.5, 2)
    # points 12, centers 6, point projection 4*4, center projection 2*4,
    # output 2*2*4, table 2*2
    assert nbytes == 4 * (12 + 6 + 16 + 8 + 16 + 4)
    assert ops == 14 * 6 + 16
    assert group_bwd_counts(1, 4, 2, 2, 4) == (4 * (16 + 4 + 16), 16)


def test_frame_step_flops_p2b():
    """P2B's eval forward at B = 1 by hand: 2 x rows x (sum of in x out) for
    each layer stack, the similarity's bmm."""
    model = load_cell("p2b.train").config["MODEL"]

    def mlp(rows, widths):
        return 2 * rows * sum(a * b for a, b in zip(widths[:-1], widths[1:]))

    search = (mlp(512 * 32, [3, 64, 64, 128]) + mlp(256 * 32, [131, 128, 128, 256])
              + mlp(128 * 32, [259, 128, 128, 256]) + mlp(128, [256, 256]))
    template = (mlp(256 * 32, [3, 64, 64, 128]) + mlp(128 * 32, [131, 128, 128, 256])
                + mlp(64 * 32, [259, 128, 128, 256]) + mlp(64, [256, 256]))
    similarity = 2 * 64 * 128 * 256 + mlp(64 * 128, [260, 256, 256, 256]) + mlp(128, [256, 256, 256])
    heads = mlp(128, [256, 256, 256, 1]) + mlp(128, [259, 256, 256, 259])
    boxes = mlp(64 * 16, [260, 256, 256, 256]) + mlp(64, [256, 256, 256, 5])
    assert frame_step_flops(model, 1, 1024, 512) == search + template + similarity + heads + boxes
    assert frame_step_flops(model, 8, 1024, 512) == 8 * frame_step_flops(model, 1, 1024, 512)
