"""What the Hopper designs of ``csrc/sa.cu`` and ``csrc/group.cu`` rest on, as
far as a CPU can check it: the error-compensated TF32 split of the SA tail
(its plain emulation in ``ops/sa.py`` on the trained asset's weights at the 7
SA calls of a frame step), the shapes the wrappers pass on to the kernels'
single paths, and the backward's documented summation order
(``ops/group.py:group_backward_ordered``). The kernels themselves are held
against these on the card by ``chip_smoke.py``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.convert import state_dict_from_npz
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.ops import group, point_ops, sa

torch.set_num_threads(1)

ASSET = Path(__file__).parent / "assets" / "ptt_synth_trained.npz"
SA_CALLS = ["search_1024_512", "search_512_256", "search_256_128", "template_512_256",
            "template_256_128", "template_128_64", "vote_aggregation_128_64"]


@pytest.fixture(scope="module")
def sa_calls():
    """The arguments of the 7 fused SA calls of one forward at full ptt.yaml
    width, B = 2, on the trained weights."""
    model = build_network(ptt_config()["MODEL"], device="cpu")
    model.load_state_dict(state_dict_from_npz(ASSET), strict=True)
    rng = np.random.default_rng(3)
    extent = np.array([2.2, 1.0, 0.8], dtype=np.float32)
    batch = {"search_points": torch.from_numpy(rng.uniform(-1, 1, (2, 1024, 3)).astype(np.float32) * extent),
             "template_points": torch.from_numpy(rng.uniform(-1, 1, (2, 512, 3)).astype(np.float32) * extent)}
    calls = []
    orig = sa.fused_sa_inference

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return orig(*args, **kwargs)

    sa.fused_sa_inference = record
    try:
        with torch.no_grad():
            model(batch)
    finally:
        sa.fused_sa_inference = orig
    assert len(calls) == len(SA_CALLS)
    return calls


@pytest.mark.parametrize("k", range(len(SA_CALLS)), ids=SA_CALLS)
def test_split_product_holds_float32_on_trained_tail(sa_calls, k):
    """Three TF32 passes stay within 1e-5 (relative to the largest entry) of the
    float32 product at every tail layer; one pass is at least 10 times worse,
    which is why the kernel pays for three."""
    (xyz, new_xyz, feats, radius, ns, weights, biases), kwargs = sa_calls[k]
    h, _, _ = point_ops.query_and_group(radius, ns, xyz, new_xyz, feats, use_xyz=kwargs.get("use_xyz", True),
                                        normalize_xyz=kwargs.get("normalize_xyz", True))
    a = torch.relu(torch.matmul(h, weights[0]) + biases[0]).reshape(-1, weights[0].shape[1])
    assert len(weights) > 1
    for w, b in zip(weights[1:], biases[1:]):
        exact = torch.matmul(a.double(), w.double())
        f32 = torch.matmul(a, w)
        scale = float(exact.abs().max())
        split = sa.matmul_3xtf32(a, w)
        err3 = float((split - exact).abs().max()) / scale
        err1 = float((sa.matmul_tf32(a, w) - exact).abs().max()) / scale
        assert float((split - f32).abs().max()) / scale < 1e-5
        assert err3 < 1e-5
        assert err1 >= 10 * err3
        a = torch.relu(f32 + b)


@pytest.mark.parametrize("k", range(len(SA_CALLS)), ids=SA_CALLS)
def test_split_stage_meets_the_card_gate(sa_calls, k):
    """The whole stage with the kernel's tail arithmetic against the plain
    version at chip_smoke.py's gate, rtol = atol = 1e-4; a single TF32 pass
    is further off."""
    args, kwargs = sa_calls[k]
    ref = sa.fused_sa_plain(*args, **kwargs)
    got = sa.fused_sa_split(*args, **kwargs)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    one = sa.fused_sa_split(*args, **kwargs, matmul=sa.matmul_tf32)
    assert float((one - ref).abs().max()) > float((got - ref).abs().max())


def test_split_tf32_parts_fit_tf32_and_sum_back(rng):
    x = torch.from_numpy((rng.standard_normal(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32))
    hi, lo = sa.split_tf32(x)
    for part in (hi, lo):  # 10 explicit mantissa bits: the low 13 are zero
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    assert bool(((hi - x).abs() <= x.abs() * 2.0 ** -11).all())  # hi is x rounded to nearest
    assert bool(((hi + lo - x).abs() <= x.abs() * 2.0 ** -21).all())


def test_kernel_shapes_of_a_frame_step_are_accepted(sa_calls):
    for (xyz, _, _, _, ns, weights, _), _ in sa_calls:
        sa.check_kernel_shapes(xyz.shape[1], ns, [w.shape[1] for w in weights])


@pytest.mark.parametrize("n, ns, widths", [
    (1024, 24, [64, 64, 128]),   # a center's rows are no whole warps
    (1024, 32, [64, 20, 128]),   # a width that is no multiple of 8
    (1022, 32, [64, 64, 128]),   # batch rows of the cloud off the 16-byte boundary
    (2048, 32, [64, 64, 128]),   # the cloud outgrows a 64-row block's activation buffer
    (1024, 32, [64]),            # no tail layer
    (256, 16, [8, 8, 8, 8, 8, 8]),  # more tail layers than the kernel takes
], ids=["nsample", "width", "n_mod_4", "cloud", "no_tail", "long_tail"])
def test_kernel_shapes_outside_the_design_are_refused(n, ns, widths):
    """The kernel has one path; the wrapper refuses what that path does not take."""
    with pytest.raises(ValueError):
        sa.check_kernel_shapes(n, ns, widths)


# ------------------------------------------------------- the backward's order


def _scatter_case(rng, case, B, N, M, ns, H):
    if case == "heavy":  # a cloud resampled from 32 distinct points: most rows share a few first hits
        base = rng.standard_normal((B, 32, 3)).astype(np.float32)
        xyz = np.take_along_axis(base, rng.integers(0, 32, (B, N, 1)).repeat(3, axis=2), axis=1)
    else:
        xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    xyz = torch.from_numpy(xyz)
    idx = point_ops.ball_query(0.8, ns, xyz, xyz[:, :M].contiguous())
    dd = torch.from_numpy(rng.standard_normal((B, ns, M, H)).astype(np.float32))
    return dd, idx


@pytest.mark.parametrize("case", ["random", "heavy"])
@pytest.mark.parametrize("H", [64, 128, 256])
def test_ordered_backward_is_repeatable_and_close_to_plain(rng, H, case):
    B, N, M, ns = 2, 256, 128, 32
    dd, idx = _scatter_case(rng, case, B, N, M, ns, H)
    if case == "heavy":
        assert int(torch.bincount(idx[0].reshape(-1).long()).max()) > 4 * 32  # segments of many chunks
    got = group.group_backward_ordered(dd, idx, N)
    assert torch.equal(got, group.group_backward_ordered(dd, idx, N))
    exact = group.group_backward_plain(dd.double(), idx, N)
    assert float((got.double() - exact).abs().max() / exact.abs().max()) < 1e-6
    plain = group.group_backward_plain(dd, idx, N)
    assert float((got - plain).abs().max() / plain.abs().max()) < 5e-6  # two float32 orders


def _ordered_by_hand(dd, idx, n):
    """The documented order, one addition at a time."""
    B, ns, M, H = dd.shape
    sub = 1  # rows per warp-wide load of H / 4 16-byte columns
    while sub * 2 * (H // 4) <= 32:
        sub *= 2
    dz = torch.zeros(B, n, H)
    for b in range(B):
        flat = idx[b].reshape(-1).tolist()  # e = m * ns + s
        for j in range(n):
            es = [e for e, p in enumerate(flat) if p == j]  # ascending e
            sums_of_chunks = []
            for c0 in range(0, max(len(es), 1), 32):
                sums = [torch.zeros(H) for _ in range(sub)]
                for t, e in enumerate(es[c0:c0 + 32]):
                    sums[t % sub] = sums[t % sub] + dd[b, e % ns, e // ns]
                while len(sums) > 1:
                    half = len(sums) // 2
                    sums = [sums[u] + sums[u + half] for u in range(half)]
                sums_of_chunks.append(sums[0])
            per = -(-len(sums_of_chunks) // 8)
            total = None
            for r in range(8):  # 8 contiguous ranges of chunks, each from zero
                part = torch.zeros(H)
                for s in sums_of_chunks[r * per:(r + 1) * per]:
                    part = part + s
                total = part if total is None else total + part
            dz[b, j] = total
    return dz


@pytest.mark.parametrize("H", [64, 128, 192])
def test_ordered_backward_equals_the_order_written_out(rng, H):
    B, N, M, ns = 1, 56, 48, 8
    dd, idx = _scatter_case(rng, "random", B, N, M, ns, H)
    idx[:, :40] = 3  # one segment of ten chunks: ranges of two
    idx[:, 40:44, :4] = 5  # and one of a single chunk and a few rows
    assert torch.equal(group.group_backward_ordered(dd, idx, N), _ordered_by_hand(dd, idx, N))


@pytest.mark.parametrize("H", [20, 32, 66])
def test_backward_widths_outside_the_design_are_refused(H):
    with pytest.raises(ValueError):
        group.check_kernel_width(H)
    with pytest.raises(ValueError):
        group.documented_order(H)


def test_documented_order_of_the_train_step_widths():
    assert [group.documented_order(h) for h in (64, 128, 256)] == [(32, 8, 2), (32, 8, 1), (32, 8, 1)]
