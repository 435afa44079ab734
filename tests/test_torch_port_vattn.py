"""The transformer blocks' eval-mode vector attention (``ops/vattn.py``,
``csrc/vattn.cu``) and its route in ``nn/transformer.py``.

On the CPU: the plain versions against the blocks' arithmetic, for one head
(d 512, scale 512) and four (head_dim 128), k = 16, at a query count that is
not a multiple of the kernels' block (2 queries of 128 columns): A bit for
bit, res and attn within 1e-6; the route as a pure function of what a call
observes, and where it counts ``vattn.plain``; the wrapper's argument check;
the blocks' plain path unchanged; and the fused route's wiring, the plain
versions standing in for the kernels, against it.

On the card (marked ``chip``; they skip without one, deciding inside the
test): both kernels against the plain versions at the cells' shapes, attn
included; a block's fused forward against its plain one; and a frame loop's
counts, replays included, for ``ptt.json`` and ``ptt_waymo.json``. Run them
on the card with ``python3 -m pytest --noconftest tests/test_torch_port_vattn.py
-m chip`` (``tests/conftest.py`` imports JAX, which the card's machine lacks).
This file imports no JAX.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from ptt_tpu_torch.nn import transformer
from ptt_tpu_torch.nn.transformer import MulTransformerBlock, TransformerBlock, _attend
from ptt_tpu_torch.ops import mesh_ctx, vattn
from ptt_tpu_torch.ops.point_ops import group_points
from ptt_tpu_torch.utils import timer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
D, K = 512, 16
HEADS = [(1, 512), (4, 128)]  # (heads, head_dim): TransformerBlock's scale is d_model, a multi-head layer's head_dim
RTOL = 1e-6  # the softmax and the sums in another order than PyTorch's reductions


@pytest.fixture(autouse=True)
def fresh_registry():
    timer.reset()
    yield
    timer.reset()


def _operands(B, N, n_ref=None, seed=0, device="cpu"):
    """q (B, N, D), kproj and vproj (B, n_ref, D), idx (B, N, K) int32 and pos
    (B, N, K, D), from numpy's generator; logits (B, N, K, D) at a softmax's
    scale."""
    n_ref = N if n_ref is None else n_ref
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)  # noqa: E731
    q, kp, vp = t(rng.standard_normal((B, N, D))), t(rng.standard_normal((B, n_ref, D))), \
        t(rng.standard_normal((B, n_ref, D)))
    idx = torch.from_numpy(rng.integers(0, n_ref, (B, N, K)).astype(np.int32)).to(device)
    pos = t(rng.standard_normal((B, N, K, D)))
    logits = t(8.0 * rng.standard_normal((B, N, K, D)))
    return q, kp, vp, idx, pos, logits


def _rel(got, want) -> float:
    return float((got.double() - want.double()).norm() / want.double().norm())


def _split(t, heads):
    """(B, N, K, H * hd) -> (B, H, N, K, hd), as MulHeadTransformerLayer."""
    B, N, Kn, d = t.shape
    return t.reshape(B, N, Kn, heads, d // heads).permute(0, 3, 1, 2, 4)


def _blocks_in(q, kp, idx, pos, heads):
    """The blocks' fc_gamma input, in (B, N, K, D) order."""
    k = group_points(kp, idx)
    if heads == 1:
        return q[:, :, None] - k + pos
    B, N, _ = q.shape
    qh = q.reshape(B, N, heads, D // heads).transpose(1, 2)
    a = qh[:, :, :, None] - _split(k, heads) + _split(pos, heads)  # (B, H, N, K, hd)
    return a.permute(0, 2, 3, 1, 4).reshape(B, N, K, D)


def _blocks_out(logits, vp, idx, pos, heads, scale):
    """The blocks' (res (B, N, D), attn (B, N, K, D)) of ``_attend``."""
    v = group_points(vp, idx)
    if heads == 1:
        attn, res = _attend(logits, v + pos, scale)
        return res, attn
    B, N = idx.shape[:2]
    attn, res = _attend(_split(logits, heads), _split(v, heads) + _split(pos, heads), scale)
    return res.transpose(1, 2).reshape(B, N, D), attn.permute(0, 2, 3, 1, 4).reshape(B, N, K, D)


# ------------------------------------------------------------------ the plain versions


@pytest.mark.parametrize("heads,hd", HEADS)
def test_plain_versions_hold_the_blocks_arithmetic(heads, hd):
    q, kp, vp, idx, pos, logits = _operands(3, 13)  # 39 queries: not a multiple of the kernels' 2 a block
    assert torch.equal(vattn.vattn_in_plain(q, kp, idx, pos), _blocks_in(q, kp, idx, pos, heads))
    res, attn = vattn.vattn_out_plain(logits, vp, idx, pos, hd, want_attn=True)
    want_res, want_attn = _blocks_out(logits, vp, idx, pos, heads, hd)
    assert _rel(res, want_res) <= RTOL and _rel(attn, want_attn) <= RTOL
    assert (res - want_res).abs().max() <= RTOL * want_res.abs().max()
    assert (attn - want_attn).abs().max() <= RTOL * want_attn.abs().max()
    assert vattn.vattn_out_plain(logits, vp, idx, pos, hd)[1] is None


def test_plain_versions_take_another_reference_cloud():
    """kproj and vproj of N_ref points, the queries a subset: the gathers read the batch row's own points."""
    q, kp, vp, idx, pos, logits = _operands(2, 5, n_ref=9, seed=1)
    a = vattn.vattn_in_plain(q, kp, idx, pos)
    b, n, j = 1, 3, 7
    want = (q[b, n] - kp[b, idx[b, n, j].long()]) + pos[b, n, j]
    assert torch.equal(a[b, n, j], want)
    res, _ = vattn.vattn_out_plain(logits, vp, idx, pos, D)
    w = torch.softmax(logits[b, n] / math.sqrt(D), dim=0)
    assert torch.allclose(res[b, n], (w * (vp[b, idx[b, n].long()] + pos[b, n])).sum(0), rtol=1e-5, atol=1e-6)


def test_wrapper_on_the_cpu_is_the_plain_version_and_counts_nothing():
    q, kp, vp, idx, pos, logits = _operands(2, 7)
    assert torch.equal(vattn.vattn_in(q, kp, idx, pos), vattn.vattn_in_plain(q, kp, idx, pos))
    got = vattn.vattn_out(logits, vp, idx, pos, 128, want_attn=True)
    want = vattn.vattn_out_plain(logits, vp, idx, pos, 128, want_attn=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    gamma = torch.nn.Linear(D, D)
    with torch.no_grad():
        res = vattn.vector_attention(q, kp, vp, idx, pos, gamma, D)
        want = vattn.vattn_out_plain(gamma(vattn.vattn_in_plain(q, kp, idx, pos)), vp, idx, pos, D)[0]
    assert torch.equal(res, want)
    assert timer.counters("launches.") == {} and timer.counter("vattn.plain") == 0


@pytest.mark.parametrize("bad", ["idx int64", "idx shape", "pos strided", "q float64", "pos shape", "k 17",
                                 "d 6", "proj 2-d"])
def test_check_refuses(bad):
    q, kp, vp, idx, pos, _ = _operands(2, 5)
    if bad == "idx int64":
        idx = idx.long()
    elif bad == "idx shape":
        idx = idx[..., None]
    elif bad == "pos strided":
        pos = pos.transpose(1, 2).contiguous().transpose(1, 2)
    elif bad == "q float64":
        q = q.double()
    elif bad == "pos shape":
        pos = pos[:, :, :8]
    elif bad == "k 17":
        idx = idx[:, :, :1].expand(2, 5, 17).contiguous()
        pos = torch.zeros(2, 5, 17, D)
    elif bad == "d 6":
        q, kp, pos = q[..., :6].contiguous(), kp[..., :6].contiguous(), pos[..., :6].contiguous()
    elif bad == "proj 2-d":
        kp = kp[0]
    with pytest.raises(ValueError):
        vattn._check("vattn_in", idx, kp, q=q, pos=pos)


def test_check_takes_the_cells_shapes():
    q, kp, vp, idx, pos, logits = _operands(2, 5)
    assert vattn._check("vattn_in", idx, kp, q=q, pos=pos) == (2, 5, 5, K, D)
    assert vattn._check("vattn_out", idx, vp, logits=logits, pos=pos) == (2, 5, 5, K, D)


# ------------------------------------------------------------------ the route


ROUTE = dict(device="cuda", dtype=torch.float32, contiguous=True, k=K, d=D, grad_enabled=False, training=False,
             use_kernels=True, point_group=None)
GROUP = mesh_ctx.PointGroup(group=None, ranks=(0, 1), index=0)


class _Operand:
    """What the route reads of a tensor, for a CUDA call on a machine without
    a card."""

    def __init__(self, shape, device, dtype, contiguous):
        self.shape, self.device, self.dtype, self._contiguous = shape, torch.device(device), dtype, contiguous

    def is_contiguous(self):
        return self._contiguous


def _takes(device, dtype, contiguous, k, d, grad_enabled, training, use_kernels, point_group) -> bool:
    """``vattn.takes_kernel`` on a block and the operands of a call (B = 2,
    N = 5) with these properties, under this autograd mode and point group;
    ``dtype`` a pair gives q the first type and the other floats the second."""
    q_dtype, dtype = dtype if isinstance(dtype, tuple) else (dtype, dtype)
    block = torch.nn.Module()
    block.train(training)
    block.use_kernels = use_kernels
    q = _Operand((2, 5, d), device, q_dtype, contiguous)
    kp, vp = (_Operand((2, 5, d), device, dtype, contiguous) for _ in range(2))
    idx = _Operand((2, 5, k), device, torch.int32, True)
    pos = _Operand((2, 5, k, d), device, dtype, True)
    with torch.set_grad_enabled(grad_enabled), mesh_ctx.use_point_group(point_group):
        return vattn.takes_kernel(block, q, kp, vp, idx, pos)


def test_route_takes_the_cells_calls():
    """Also under a point group, where only the kNN search splits and the
    block runs whole on every rank."""
    assert _takes(**ROUTE)
    assert _takes(**dict(ROUTE, device=torch.device("cuda", 0), k=1, d=4))
    assert _takes(**dict(ROUTE, point_group=GROUP))
    assert timer.counter("vattn.plain") == 0


@pytest.mark.parametrize("change,counted", [
    (dict(grad_enabled=True), True), (dict(contiguous=False), True), (dict(k=0), True),
    (dict(k=17), True), (dict(d=510), True), (dict(use_kernels=False), True),
    (dict(training=True), False), (dict(device="cpu"), False), (dict(dtype=torch.bfloat16), False),
    (dict(dtype=(torch.float32, torch.bfloat16)), False)], ids=lambda v: str(v))
def test_route_refuses(change, counted):
    """A refused CUDA float32 eval-mode call counts ``vattn.plain``; training,
    another device or another type counts nothing."""
    assert not _takes(**dict(ROUTE, **change))
    assert timer.counter("vattn.plain") == int(counted)


def _blocks():
    torch.manual_seed(0)
    return [TransformerBlock(32, D, K), MulTransformerBlock(32, D, K, 4, 2)]


def _block_inputs(B=2, N=24, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((B, N, 3)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal((B, N, 32)).astype(np.float32)))


def _old_block(self, xyz, features):
    """TransformerBlock.forward before the route."""
    _, q, k, v, pos_enc = self.qkv(xyz, features)
    attn, res = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
    return self.fc2(res) + features, attn


def _old_layer(self, xyz, features):
    """MulHeadTransformerLayer.forward before the route."""
    _, q, k, v, pos_enc = self.qkv(xyz, features)
    B, N, _ = q.shape
    qh = q.reshape(B, N, self.heads, self.head_dim).transpose(1, 2)
    kh, vh, ph = (_split(t, self.heads) for t in (k, v, pos_enc))
    attn, res = _attend(self.fc_gamma(qh[:, :, :, None] - kh + ph), vh + ph, self.head_dim)
    res = self.norm1(self.proj(res.transpose(1, 2).reshape(B, N, self.d_model)))
    return self.norm2(self.fc2(res)) + features, attn


@pytest.mark.parametrize("train", [False, True])
def test_blocks_on_the_cpu_unchanged(monkeypatch, train):
    """On the CPU both blocks give the outputs of their code before the route,
    bit for bit, in eval mode without autograd and in train mode with it, and
    count nothing of the route."""
    xyz, feats = _block_inputs()
    for block in _blocks():
        block.train(train)
        with torch.set_grad_enabled(train):
            new = block(xyz, feats)
            with monkeypatch.context() as m:
                m.setattr(transformer.MulHeadTransformerLayer, "forward", _old_layer)
                old = block(xyz, feats) if isinstance(block, MulTransformerBlock) else _old_block(block, xyz, feats)
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
    assert timer.counter("vattn.plain") == 0 and timer.counter("launches.vattn") == 0


def test_fused_wiring_on_the_cpu(monkeypatch):
    """The fused route's wiring (the heads' fc_gamma on A's rows, the scale,
    res in (B, N, H * head_dim) order), the plain versions standing in for the
    kernels: within 1e-6 of the plain path, attn None, one call a layer."""
    xyz, feats = _block_inputs(seed=1)
    with torch.no_grad():
        for block in _blocks():
            block.eval()
            plain = block(xyz, feats)
            with monkeypatch.context() as m:
                m.setattr(vattn, "takes_kernel", lambda *a, **kw: True)
                calls = []
                real = vattn.vector_attention

                def counted(q, *args, **kwargs):
                    calls.append(tuple(q.shape))
                    return real(q, *args, **kwargs)

                m.setattr(vattn, "vector_attention", counted)
                fused = block(xyz, feats)
            assert fused[1] is None and plain[1] is not None
            assert calls == [(2, 24, D)] * (1 if isinstance(block, TransformerBlock) else 2)
            assert _rel(fused[0], plain[0]) <= RTOL


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# the cells' calls at B = 8: (queries a batch row, heads, head_dim)
CARD_SHAPES = [(128, 1, 512), (64, 1, 512), (256, 4, 128), (128, 4, 128)]


@pytest.mark.chip
@pytest.mark.parametrize("n,heads,hd", CARD_SHAPES, ids=[f"Q{8 * s[0]}-H{s[1]}" for s in CARD_SHAPES])
def test_kernels_hold_the_plain_versions(cuda_device, n, heads, hd):
    q, kp, vp, idx, pos, logits = _operands(8, n, seed=3, device=cuda_device)
    a = vattn.vattn_in(q, kp, idx, pos)
    res, attn = vattn.vattn_out(logits, vp, idx, pos, hd, want_attn=True)
    res_only, none = vattn.vattn_out(logits, vp, idx, pos, hd)
    torch.cuda.synchronize()
    assert torch.equal(a, vattn.vattn_in_plain(q, kp, idx, pos))
    assert torch.equal(a, _blocks_in(q, kp, idx, pos, heads))
    want_res, want_attn = _blocks_out(logits, vp, idx, pos, heads, hd)
    assert _rel(res, want_res) <= RTOL and _rel(attn, want_attn) <= RTOL
    assert (res - want_res).abs().max() <= RTOL * want_res.abs().max()
    assert (attn - want_attn).abs().max() <= RTOL * want_attn.abs().max()
    assert none is None and torch.equal(res_only, res)


@pytest.mark.chip
def test_kernels_take_k_up_to_16_and_refuse_more(cuda_device):
    rng = np.random.default_rng(5)
    for k in (1, 5, 16):
        q, kp, vp = (torch.randn(2, 9, 64, device=cuda_device) for _ in range(3))
        idx = torch.from_numpy(rng.integers(0, 9, (2, 9, k)).astype(np.int32)).to(cuda_device)
        pos, logits = torch.randn(2, 9, k, 64, device=cuda_device), torch.randn(2, 9, k, 64, device=cuda_device)
        assert torch.equal(vattn.vattn_in(q, kp, idx, pos), vattn.vattn_in_plain(q, kp, idx, pos))
        res, _ = vattn.vattn_out(logits, vp, idx, pos, 64)
        assert _rel(res, vattn.vattn_out_plain(logits, vp, idx, pos, 64)[0]) <= RTOL, k
    with pytest.raises(ValueError):
        vattn.vattn_in(q, kp, torch.zeros(2, 9, 17, dtype=torch.int32, device=cuda_device),
                       torch.zeros(2, 9, 17, 64, device=cuda_device))


@pytest.mark.chip
@pytest.mark.parametrize("which", [0, 1], ids=["TransformerBlock", "MulTransformerBlock"])
def test_block_fused_against_plain(cuda_device, which):
    """One block's forward at a cell's size (B = 8, 128 points, 512 inputs):
    the fused route against the block's plain path (its ``use_kernels`` off,
    the Linear layers' left on), within 1e-5 of the features' largest entry
    (the ``track`` limits' box median); a multi-head layer's fc_gamma.0 on
    the product kernel."""
    torch.manual_seed(0)
    block = (TransformerBlock(512, D, K) if which == 0 else MulTransformerBlock(512, D, K, 4, 2)).to(cuda_device)
    block.eval()
    xyz, feats = torch.randn(8, 128, 3, device=cuda_device), torch.randn(8, 128, 512, device=cuda_device)
    with torch.no_grad():
        fused = block(xyz, feats)
        counts = timer.counters("launches.")
        for m in block.modules():
            if hasattr(m, "use_kernels") and not isinstance(m, torch.nn.Linear):
                m.use_kernels = False
        plain = block(xyz, feats)
    torch.cuda.synchronize()
    layers = 1 if which == 0 else 2
    assert fused[1] is None and plain[1] is not None
    assert counts["launches.vattn"] == layers and counts["launches.vattn.1024x16x512"] == layers
    if which == 0:  # fc_delta.2, fc_gamma.0 and fc_gamma.2 at 16384 x 512 x 512
        assert counts["launches.tf32x3.16384x512x512"] == 3
    else:  # fc_gamma.0 and .2 of each layer on the heads' rows
        assert counts["launches.tf32x3.65536x128x128"] == 2 * layers
    assert timer.counter("vattn.plain") == layers  # the plain run's, refused for use_kernels
    err = float((fused[0] - plain[0]).abs().max() / plain[0].abs().max())
    assert err <= 1e-5, err


def _frame_loop(cfg, device, n_frames=4):
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.tools.bench_setup import bench_tracklets

    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device=device)
    tracklets = bench_tracklets(cfg["DATA_CONFIG"], 8, n_frames)
    return DeviceTrackingEvaluator(cfg, model, max_points=2048, batch_size=8, device=device), tracklets


@pytest.mark.chip
@pytest.mark.parametrize("config,per_step", [
    ("ptt", {}), ("ptt_waymo", {"launches.tf32x3.131072x128x128": 4, "launches.tf32x3.65536x128x128": 4})])
def test_frame_loop_counts(cuda_device, config, per_step):
    """A frame step's fused calls equal its kNN searches, eager and replayed,
    none refused; in ``ptt_waymo`` fc_gamma.0 and .2 of each of the four
    layers are on the product kernel."""
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    ev, tracklets = _frame_loop(cfg, cuda_device)
    try:
        for _ in range(2):  # the first batch captures, the second only replays
            timer.reset()
            ev.boxes(ev.dispatch_batch(tracklets))
            steps = timer.counter("frame_loop.frame_steps")
            assert steps > 0 and timer.counter("launches.knn") > 0
            assert timer.counter("launches.vattn") == timer.counter("launches.knn")
            assert timer.counter("vattn.plain") == 0
            for name, calls in per_step.items():
                assert timer.counter(name) == calls * steps, name
    finally:
        ev.close()
