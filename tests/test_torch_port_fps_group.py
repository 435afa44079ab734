"""What the Hopper designs of ``csrc/fps.cu`` and the forward of ``csrc/group.cu``
rest on, as far as a CPU can check it: the FPS round written out in plain
PyTorch (``ops/fps.py:furthest_point_sample_packed``: a thread's points in
registers, the maximum over the running minima's bits, the lowest index among
the equals) against the plain version and the JAX package; the bit-order claim
itself; the forward's tile-by-tile emulation (``ops/group.py:group_forward_tiled``)
against the plain version bit for bit; the shapes the wrappers pass on to the
kernels' single paths; and the latency bound ``chip_smoke.py`` computes for FPS.
The kernels themselves are held against these on the card by ``chip_smoke.py``."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.ops import point_ops as jops
from ptt_tpu.ops.pallas_fps import furthest_point_sample_pallas
from ptt_tpu.ops.pallas_group import grouped_first_linear as jgroup
from ptt_tpu_torch import variants
from ptt_tpu_torch.ops import fps, group, point_ops

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the GPU run's script: its bound functions need no card)

torch.set_num_threads(1)

# (B, N, npoint) of the FPS calls of a frame step at B = 8 and a train step at B = 48
FPS_CALLS = [(16, 1024, 512), (8, 128, 64), (96, 1024, 512), (48, 128, 64)]
# (N, M, nsample, H) of the 7 grouped_first_linear calls of a train step
GROUP_CALLS = [(1024, 512, 32, 64), (512, 256, 32, 128), (256, 128, 32, 128), (512, 256, 32, 64),
               (256, 128, 32, 128), (128, 64, 32, 128), (128, 64, 16, 256)]


# ------------------------------------------------------------------ (a) the round


def _cloud(rng, kind, B, N):
    if kind == "identical":
        return np.repeat(rng.standard_normal((B, 1, 3)).astype(np.float32), N, axis=1)
    if kind == "duplicated":  # resampled from 8 distinct points: exact ties in every round
        base = rng.standard_normal((B, 8, 3)).astype(np.float32)
        return np.take_along_axis(base, rng.integers(0, 8, (B, N, 1)).repeat(3, axis=2), axis=1)
    return rng.standard_normal((B, N, 3)).astype(np.float32)


# N inside each form's range; "ragged" is no multiple of 32 or of the block
FORM_SIZES = {(1, 4): {"random": 128, "ragged": 100}, (8, 4): {"random": 512, "ragged": 333},
              (16, 4): {"random": 1280, "ragged": 1100}, (16, 16): {"random": 8192, "ragged": 2049}}


@pytest.mark.parametrize("kind", ["random", "duplicated", "identical", "ragged"])
@pytest.mark.parametrize("warps,pts", [(w, p) for _, w, p in fps.KERNEL_FORMS])
def test_packed_round_equals_plain_and_jax(rng, warps, pts, kind):
    N = FORM_SIZES[(warps, pts)]["ragged" if kind == "ragged" else "random"]
    assert fps.kernel_form(N) == (warps, pts)
    xyz = _cloud(rng, "random" if kind == "ragged" else kind, 2, N)
    m = N if N <= 128 else 24  # the small form also runs to npoint == N
    got = fps.furthest_point_sample_packed(torch.from_numpy(xyz), m, warps, pts)
    assert got.dtype == torch.int32
    assert torch.equal(got, point_ops.furthest_point_sample(torch.from_numpy(xyz), m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jops.furthest_point_sample(jnp.asarray(xyz), m)))
    if N <= 512:  # the Pallas kernel itself, interpreted, where that is quick
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(furthest_point_sample_pallas(jnp.asarray(xyz), m, interpret=True)))


def test_packed_round_refuses_a_cloud_beyond_the_form(rng):
    with pytest.raises(ValueError):
        fps.furthest_point_sample_packed(torch.zeros(1, 129, 3), 4, 1, 4)


# ------------------------------------------------------------- (b) the bit order


@pytest.mark.parametrize("case", ["random", "edges"])
def test_nonnegative_floats_order_as_their_bits(rng, case):
    """For float32 a, b in [+0, 1e10], denormals included: a < b iff bits(a) <
    bits(b), and a == b iff the bits are equal, which is what lets one integer
    maximum stand for the float maximum."""
    if case == "random":
        vals = np.exp(rng.uniform(np.log(1e-45), np.log(1e10), 4000)).astype(np.float32)
    else:
        tiny = np.float32(1.4e-45)  # the smallest denormal
        vals = np.array([0.0, tiny, 2 * tiny, 1.1754942e-38, 1.17549435e-38, 1e-30, 1.0, np.nextafter(np.float32(1), 2),
                         3.0, 1e10, np.nextafter(np.float32(1e10), 0)], dtype=np.float32)
    vals = np.minimum(vals, np.float32(1e10))
    v = torch.from_numpy(vals)
    bits = v.view(torch.int32).long()
    assert int(bits.min()) >= 0
    assert torch.equal(v[:, None] < v[None, :], bits[:, None] < bits[None, :])
    assert torch.equal(v[:, None] == v[None, :], bits[:, None] == bits[None, :])


# ------------------------------------------------------------ (c) the forward


@pytest.mark.parametrize("N,M,ns,H", [(160, 50, 16, 64), (128, 64, 32, 128), (96, 21, 16, 256), (64, 8, 4, 12)])
def test_tiled_forward_is_bit_equal_to_plain(rng, N, M, ns, H):
    B = 2
    xyz = torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32))
    new_xyz = xyz[:, :M].clone()
    new_xyz[:, 0] += 50.0  # an empty ball: point 0 in every slot
    z = torch.from_numpy(rng.standard_normal((B, N, H)).astype(np.float32))
    off = torch.from_numpy(rng.standard_normal((B, M, H)).astype(np.float32))
    group.check_forward_shapes(N, ns, H)
    d, idx = group.group_forward_plain(xyz, new_xyz, z, off, 0.5, ns)
    assert torch.equal(group.group_forward_tiled(z, off, idx), d)  # M = 50 and 21: a ragged last tile
    assert torch.equal(group.group_forward_tiled(z, off, idx, tile=16, threads=64, in_flight=8), d)


@pytest.mark.parametrize("C,H,ns", [(8, 64, 16), (0, 32, 32)])
def test_grouped_first_linear_still_matches_pallas(rng, C, H, ns):
    """The function around the forward, at shapes the kernel takes, against the
    JAX package's kernel in interpret mode: 5e-4 of the largest entry, the band
    of tests/test_torch_port_group.py."""
    B, N, M, radius = 2, 192, 64, 0.4
    group.check_forward_shapes(N, ns, H)
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    new_xyz = xyz[:, :M].copy()
    feats = rng.standard_normal((B, N, C)).astype(np.float32) if C else None
    w1 = (rng.standard_normal((C + 3, H)) * 0.2).astype(np.float32)
    ref = np.asarray(jgroup(jnp.asarray(xyz), jnp.asarray(new_xyz), None if feats is None else jnp.asarray(feats),
                            jnp.asarray(w1), radius, ns, interpret=True))
    got = group.grouped_first_linear(torch.from_numpy(xyz), torch.from_numpy(new_xyz),
                                     None if feats is None else torch.from_numpy(feats), torch.from_numpy(w1),
                                     radius, ns).numpy()
    assert got.shape == ref.shape == (B, ns, M, H)
    assert float(np.abs(got - ref).max()) <= 5e-4 * float(np.abs(ref).max())


# ------------------------------------------------- (d) the shapes the kernels take


@pytest.mark.parametrize("B,N,npoint", FPS_CALLS)
def test_fps_call_shapes_are_accepted(B, N, npoint):
    fps.check_kernel_shapes(N, npoint)
    warps, pts = fps.kernel_form(N)
    assert 32 * warps * pts >= N


@pytest.mark.parametrize("N,npoint", [(1000, 1000), (100, 7), (1, 1), (129, 129), (2048, 2048)])
def test_fps_ragged_and_full_shapes_are_accepted(N, npoint):
    fps.check_kernel_shapes(N, npoint)


@pytest.mark.parametrize("N,npoint", [(8193, 16), (16384, 512), (128, 129), (128, 0), (0, 0)],
                         ids=["beyond_the_largest_form", "far_beyond", "npoint_over_n", "no_point", "no_cloud"])
def test_fps_shapes_outside_the_design_are_refused(N, npoint):
    with pytest.raises(ValueError):
        fps.check_kernel_shapes(N, npoint)


def test_fps_forms_cover_their_ranges_in_order():
    limits = [limit for limit, _, _ in fps.KERNEL_FORMS]
    assert limits == sorted(limits) and limits[-1] == fps.MAX_POINTS >= 2048
    for limit, warps, pts in fps.KERNEL_FORMS:
        assert 32 * warps * pts == limit  # a form is full at its limit: no point without a register
        assert warps & (warps - 1) == 0  # the slot a lane reads is lane & (warps - 1)
        assert fps.kernel_form(limit) == (warps, pts)


@pytest.mark.parametrize("N,M,ns,H", GROUP_CALLS)
def test_group_forward_shapes_of_a_train_step_are_accepted(N, M, ns, H):
    group.check_forward_shapes(N, ns, H)
    group.check_kernel_width(H)
    assert group.forward_shared_bytes(N, ns) < 48 * 1024  # no opt-in to large shared memory at these sizes


@pytest.mark.parametrize("N,ns,H", [(1024, 32, 66), (1024, 32, 2), (1024, 6, 64), (1024, 2, 64), (20000, 32, 64)],
                         ids=["width_off_16_bytes", "width_under_16_bytes", "nsample_off_4", "nsample_under_4",
                              "cloud_beyond_shared_memory"])
def test_group_forward_shapes_outside_the_design_are_refused(N, ns, H):
    with pytest.raises(ValueError):
        group.check_forward_shapes(N, ns, H)


# ------------------------------------------------------ (e) the bound stays a bound


@pytest.mark.parametrize("n", [100, 128, 512, 1024, 2048])
def test_round_bound_is_no_larger_with_redux(n):
    with_redux, _ = chip_smoke.fps_round_cycles(n, redux=True)
    without, _ = chip_smoke.fps_round_cycles(n, redux=False)
    assert 0 < with_redux <= without
    assert chip_smoke.fps_round_cycles(n) == chip_smoke.fps_round_cycles(n, redux=True)


# device ms of the redesigned kernel on an NVIDIA H100 80GB HBM3 at 700 W, the least
# PERF.md records for each call shape (calls queued behind a busy stream)
RECORDED_MS = {(16, 1024, 512): 0.1037, (8, 128, 64): 0.0079, (96, 1024, 512): 0.1040, (48, 128, 64): 0.0079}


@pytest.mark.parametrize("B,N,npoint", FPS_CALLS)
def test_chain_bound_is_positive_and_under_the_recorded_time(B, N, npoint):
    bound = chip_smoke.fps_chain_bound_ms(torch.zeros(B, N, 3), npoint)
    assert 0 < bound < RECORDED_MS[(B, N, npoint)]
    # a higher clock shortens the bound, a second wave of blocks doubles it
    assert chip_smoke.fps_chain_bound_ms(torch.zeros(B, N, 3), npoint, clock=2.1e9) < bound
    assert chip_smoke.fps_chain_bound_ms(torch.zeros(chip_smoke.SMS + 1, N, 3), npoint) == pytest.approx(
        2 * chip_smoke.fps_chain_bound_ms(torch.zeros(1, N, 3), npoint))


# ------------------------------------------------- the patches behind PERF.md's splits


@pytest.mark.parametrize("source,name", [("group.cu", n) for n in variants.GROUP_VARIANTS]
                         + [("fps.cu", n) for n in variants.FPS_VARIANTS])
def test_variant_patches_fit_the_sources(source, name):
    """Every variant ``ptt_tpu_torch/variants.py`` times is a patch of the current
    source: a patch that no longer applies raises instead of timing the kernel
    unchanged."""
    edits = variants.GROUP_VARIANTS[name][0] if source == "group.cu" else variants.FPS_VARIANTS[name][0]
    text = (variants.CSRC / source).read_text()
    assert variants.apply(text, edits, name) != text
    with pytest.raises(RuntimeError):
        variants.apply(text.replace(edits[0][0], ""), edits, name)
