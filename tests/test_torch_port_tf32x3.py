"""The eval-mode float32 product kernel (``ops/linear.py``, ``csrc/tf32x3.cu``)
and its route in ``nn/layers.py``.

On the CPU: the plain version, which emulates the kernel's three-pass TF32
split in float32, against float64 at the tracker's eight large products a
frame step (M scaled down); the route as a pure function of shape, dtype,
device and grad mode, at every Linear call of a ``benchmark/configs/ptt.json``
frame step at B = 8; the layers' forward on the CPU equal to the code they
replaced, and their state-dict keys unchanged.

On the card (marked ``chip``; they skip without one, deciding inside the
test): the kernel's error against float64 at the eight shapes within twice
cuBLAS float32's on the same inputs, a captured frame loop bit-equal to the
eager one, and the launches a frame step and a train step count. Run them
on the card with ``python3 -m pytest --noconftest
tests/test_torch_port_tf32x3.py -m chip`` (``tests/conftest.py`` imports JAX,
which the card's machine lacks). This file imports no JAX.
"""

import itertools
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

from ptt_tpu_torch.nn import build_network, layers, set_use_kernels
from ptt_tpu_torch.nn.transformer import TransformerBlock
from ptt_tpu_torch.ops import linear
from ptt_tpu_torch.ops.sa import matmul_tf32
from ptt_tpu_torch.utils import cuda_graph, timer

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PTT = json.loads((ROOT / "benchmark" / "configs" / "ptt.json").read_text())
B = 8  # the tracker's batch in the benchmark and the test CLI
# the eight products of a frame step at B = 8 (module, M, K, N, epilogue)
FRAME_STEP = [(f"{head}.transformer_block.{layer}", m, 512, 512, epi)
              for head, m in (("centroid_voting_head", 16384), ("box_voting_head", 8192))
              for layer, epi in (("fc_delta.2", "bias"), ("fc_gamma.0", "bias+relu"), ("fc_gamma.2", "bias"))] + \
             [(f"similarity_module.mlp.linears.{i}", 65536, 256, 256, "bn+relu") for i in (1, 2)]
SPLIT_RTOL = 1e-6  # the split's error is ~1e-7 of the product's norm, one-pass TF32's ~3e-4
TF32_FLOOR = 5e-5  # one-pass TF32 reads above it on the same inputs: the check can tell the two apart


def _operands(m, k, n, epilogue, seed=0, device="cpu"):
    """x (m, k), a Linear's (n, k) weight and the epilogue's bias or BatchNorm
    vectors, from numpy's generator, moved to ``device``."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)).to(device)  # noqa: E731
    x = t(np.maximum(rng.standard_normal((m, k)), 0.0))  # post-ReLU activations, as these layers see
    w = t(rng.standard_normal((n, k)) / np.sqrt(k))
    bias = bn = None
    if epilogue.startswith("bias"):
        bias = t(0.1 * rng.standard_normal(n))
    elif epilogue.startswith("bn"):
        bn = (t(rng.uniform(0.5, 1.5, n)), t(0.1 * rng.standard_normal(n)), t(0.1 * rng.standard_normal(n)),
              t(rng.uniform(0.5, 1.5, n)), 1e-5)
    return x, w, bias, bn, epilogue.endswith("relu")


def _float64(x, w, bias, bn, relu):
    y = x.double() @ w.double().t()
    if bias is not None:
        y = y + bias.double()
    if bn is not None:
        gamma, beta, mean, var, eps = bn
        y = (y - mean.double()) / torch.sqrt(var.double() + eps) * gamma.double() + beta.double()
    return torch.relu(y) if relu else y


def _rel(got, ref) -> float:
    return float((got.double() - ref).norm() / ref.norm())


# ------------------------------------------------------------------ the plain version


@pytest.mark.parametrize("name,m,k,n,epilogue", FRAME_STEP, ids=[f"{c[0]}" for c in FRAME_STEP])
def test_plain_version_holds_float64_at_the_frame_step_shapes(name, m, k, n, epilogue):
    x, w, bias, bn, relu = _operands(m // 64, k, n, epilogue)
    ref = _float64(x, w, bias, bn, relu)
    err = _rel(linear.linear_tf32x3_plain(x, w, bias, bn, relu), ref)
    # the same layer with one TF32 pass: what the split saves
    scale, shift = linear.affine(n, bias, bn)
    one_pass = matmul_tf32(x, w.t()) * scale + shift
    assert err < SPLIT_RTOL, (name, err)
    assert _rel(torch.relu(one_pass) if relu else one_pass, ref) > TF32_FLOOR


def test_wrapper_on_the_cpu_is_the_plain_version():
    x, w, bias, bn, relu = _operands(300, 64, 256, "bn+relu", seed=1)
    assert torch.equal(linear.linear_tf32x3(x, w, bias, bn, relu), linear.linear_tf32x3_plain(x, w, bias, bn, relu))
    x3 = x.reshape(3, 100, 64)
    got = linear.linear_tf32x3(x3, w, bias, bn, relu)
    assert got.shape == (3, 100, 256) and torch.equal(got.reshape(300, 256), linear.linear_tf32x3_plain(x, w, bias, bn, relu))


def test_affine_is_the_bias_or_eval_batchnorm():
    x, w, _, bn, _ = _operands(64, 32, 128, "bn", seed=2)
    bias = _operands(1, 32, 128, "bias", seed=2)[2]
    scale, shift = linear.affine(128, bn=bn)
    bn_mod = nn.BatchNorm1d(128, eps=bn[4]).eval()
    with torch.no_grad():
        for p, v in zip((bn_mod.weight, bn_mod.bias, bn_mod.running_mean, bn_mod.running_var), bn[:4]):
            p.copy_(v)
        y = x @ w.t()
        torch.testing.assert_close(y * scale + shift, bn_mod(y), rtol=1e-6, atol=1e-6)
    scale, shift = linear.affine(128, bias=bias)
    assert torch.equal(scale, torch.ones(128)) and torch.equal(shift, bias)
    assert torch.equal(linear.affine(128)[1], torch.zeros(128))


@pytest.mark.parametrize("m,k,n", [(0, 32, 128), (16, 3, 512), (16, 48, 128), (16, 32, 64), (16, 32, 200)])
def test_check_kernel_shapes_refuses(m, k, n):
    with pytest.raises(ValueError):
        linear.check_kernel_shapes(m, k, n)


def test_check_kernel_shapes_takes_the_frame_step():
    for _, m, k, n, _ in FRAME_STEP:
        linear.check_kernel_shapes(m, k, n)


# ------------------------------------------------------------------ the route


def _frame_step_calls():
    """(module, M, K, N) of every Linear call of a ``ptt.json`` forward on a
    frame step's batch, from one B = 1 forward on the CPU, M times B."""
    torch.manual_seed(0)
    model = build_network(PTT["MODEL"], device="cpu")
    rng = np.random.default_rng(0)
    batch = {"search_points": torch.from_numpy(rng.standard_normal((1, 1024, 3)).astype(np.float32)),
             "template_points": torch.from_numpy(rng.standard_normal((1, 512, 3)).astype(np.float32))}
    calls = []
    hooks = [mod.register_forward_hook(
        lambda mod, args, out, name=name: calls.append((name, B * (args[0].numel() // mod.in_features),
                                                        mod.in_features, mod.out_features)))
        for name, mod in model.named_modules() if isinstance(mod, nn.Linear)]
    with torch.no_grad():
        model(batch)
    for h in hooks:
        h.remove()
    return calls


@pytest.fixture(scope="module")
def frame_step_calls():
    return _frame_step_calls()


def test_route_takes_the_eight_frame_step_products(frame_step_calls):
    engaged = [(name, m, k, n) for name, m, k, n in frame_step_calls
               if linear.takes_kernel(m, k, n, torch.float32, "cuda", False)]
    assert sorted(engaged) == sorted((name, m, k, n) for name, m, k, n, _ in FRAME_STEP)
    # and nothing else of the step: the other calls are under the crossover or off the tiles
    assert len(frame_step_calls) == 33
    assert ("centroid_voting_head.transformer_block.fc_delta.0", 16384, 3, 512) in frame_step_calls


def test_route_leaves_grad_bf16_cpu_and_narrow_calls(frame_step_calls):
    for name, m, k, n in frame_step_calls:
        assert not linear.takes_kernel(m, k, n, torch.float32, "cuda", True), name
        assert not linear.takes_kernel(m, k, n, torch.bfloat16, "cuda", False), name
        assert not linear.takes_kernel(m, k, n, torch.float32, "cpu", False), name
    assert not linear.takes_kernel(16384, 3, 512, torch.float32, "cuda", False)  # fc_delta.0
    for n in (128, 256, 512, 1024):
        assert not linear.takes_kernel(linear.min_rows(n) - 1, 512, n, torch.float32, "cuda", False)
        assert linear.takes_kernel(linear.min_rows(n), 512, n, torch.float32, torch.device("cuda", 0), False)
    assert (linear.min_rows(512), linear.min_rows(256)) == (2048, 4096)
    assert not linear.takes_kernel(65536, 256, 259, torch.float32, "cuda", False)
    assert not linear.takes_kernel(65536, 259, 256, torch.float32, "cuda", False)


def test_cpu_calls_count_nothing():
    timer.reset()
    with torch.no_grad():
        layers.mlp2(32, 128, 128).eval()(torch.randn(4096, 32))
    assert timer.counter("linear.plain") == 0 and timer.counter("launches.tf32x3") == 0


# ------------------------------------------------------------------ the layers as before


def _old_linear(self, x):
    dtype = torch.promote_types(x.dtype, self.weight.dtype)
    bias = None if self.bias is None else self.bias.to(dtype)
    return F.linear(x.to(dtype), self.weight.to(dtype), bias)


def _old_shared_mlp(self, x, first_linear_apply=None):
    for i, lin in enumerate(self.linears):
        x = first_linear_apply(lin.weight.t()) if i == 0 and first_linear_apply is not None else lin(x)
        if self.bn:
            x = self.bns[i](x)
        x = torch.relu(x)
    return x


@pytest.mark.parametrize("train", [False, True])
def test_tracker_forward_unchanged(monkeypatch, train):
    """The ``ptt.json`` tracker's forward on the CPU equals the one of the
    layers' code before the route (``F.linear``, ``nn.Sequential``, BatchNorm
    and ReLU one after another), bit for bit, in eval mode without autograd
    and in train mode with it."""
    torch.manual_seed(0)
    model = build_network(PTT["MODEL"], device="cpu", train=train)
    rng = np.random.default_rng(1)
    batch = {"search_points": torch.from_numpy(rng.standard_normal((2, 1024, 3)).astype(np.float32)),
             "template_points": torch.from_numpy(rng.standard_normal((2, 512, 3)).astype(np.float32))}
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def run():
        model.load_state_dict(state)
        with torch.set_grad_enabled(train):
            return model(dict(batch))

    new = run()
    monkeypatch.setattr(layers.Linear, "forward", _old_linear)
    monkeypatch.setattr(layers.MLP2, "forward", nn.Sequential.forward)
    monkeypatch.setattr(layers.SharedMLP, "forward", _old_shared_mlp)
    old = run()
    keys = [k for k, v in old.items() if torch.is_tensor(v) and v.is_floating_point()]
    assert keys and all(torch.equal(new[k], old[k]) for k in keys)


def test_state_dict_keys_unchanged():
    assert list(layers.mlp2(3, 16, 16).state_dict()) == ["0.weight", "0.bias", "2.weight", "2.bias"]
    assert [type(m) for m in layers.mlp2(3, 16, 16)] == [layers.Linear, nn.ReLU, layers.Linear]
    mlp = layers.SharedMLP([8, 16, 16])
    assert list(mlp.state_dict()) == [f"linears.{i}.weight" for i in range(2)] + [
        f"bns.{i}.{p}" for i in range(2) for p in ("weight", "bias", "running_mean", "running_var",
                                                   "num_batches_tracked")]
    block = TransformerBlock(16, 32, 4)
    want = [f"{lin}.{p}" for lin in ("fc1",) for p in ("weight", "bias")] + \
           [f"w_{c}s.weight" for c in "qkv"] + \
           [f"{mlp}.{i}.{p}" for mlp in ("fc_delta", "fc_gamma") for i in (0, 2) for p in ("weight", "bias")] + \
           ["fc2.weight", "fc2.bias"]
    assert sorted(block.state_dict()) == sorted(want)


def test_set_use_kernels_reaches_the_linear_layers():
    model = build_network(PTT["MODEL"], device="cpu")
    lins = [m for m in model.modules() if isinstance(m, layers.Linear)]
    assert lins and all(m.use_kernels for m in lins)
    before = cuda_graph.model_signature(model)
    set_use_kernels(model, False)
    assert not any(m.use_kernels for m in lins) and cuda_graph.model_signature(model) != before
    set_use_kernels(model, True)
    assert cuda_graph.model_signature(model) == before


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.chip
@pytest.mark.parametrize("name,m,k,n,epilogue", FRAME_STEP, ids=[f"{c[0]}" for c in FRAME_STEP])
def test_kernel_within_twice_cublas_error(cuda_device, name, m, k, n, epilogue):
    x, w, bias, bn, relu = _operands(m, k, n, epilogue, seed=3, device=cuda_device)
    ref = _float64(x, w, bias, bn, relu)
    timer.reset()
    got = linear.linear_tf32x3(x, w, bias, bn, relu)
    torch.cuda.synchronize()
    assert timer.counter("launches.tf32x3") == 1
    y = F.linear(x, w, bias)
    if bn is not None:
        y = F.batch_norm(y, bn[2], bn[3], bn[0], bn[1], False, 0.0, bn[4])
    cublas = torch.relu(y) if relu else y
    assert _rel(got, ref) <= 2 * _rel(cublas, ref), (name, _rel(got, ref), _rel(cublas, ref))


@pytest.fixture
def tracker(cuda_device):
    from ptt_tpu_torch.eval.device_loop import DeviceTrackingEvaluator
    from ptt_tpu_torch.tools.bench_setup import build_bench_setup

    cfg, model, tracklets, max_points = build_bench_setup(n_tracklets=B, n_frames=6, device=cuda_device)
    evs = []

    def make():
        evs.append(DeviceTrackingEvaluator(cfg, model, max_points=max_points, batch_size=B, device=cuda_device))
        return evs[-1]

    yield make, tracklets
    for ev in evs:
        ev.close()


@pytest.mark.chip
def test_captured_frame_loop_bit_equal_to_eager(tracker):
    make, tracklets = tracker
    graphed, eager = make(), make()
    eager._track = eager._track_eager
    timer.reset()
    got = graphed.boxes(graphed.dispatch_batch(tracklets))
    assert timer.counter("graph.captures") >= 1
    want = eager.boxes(eager.dispatch_batch(tracklets))
    assert torch.equal(got, want)


@pytest.mark.chip
def test_frame_step_launches_eight_and_a_train_step_none(tracker, cuda_device):
    """A frame step adds 8 to ``launches.tf32x3`` (its two FPS calls add 2 to
    ``launches.fps``), replays included; a train step adds none."""
    from ptt_tpu_torch.config import ptt_synth_config
    from ptt_tpu_torch.data.loader import DataLoader
    from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step

    make, tracklets = tracker
    ev = make()
    for _ in range(2):  # the first batch captures, the second only replays
        timer.reset()
        ev.boxes(ev.dispatch_batch(tracklets))
        steps = timer.counter("launches.fps") // 2
        assert steps > 0 and timer.counter("launches.tf32x3") == 8 * steps
    cfg = ptt_synth_config()
    model = build_network(cfg["MODEL"], device=cuda_device, train=True)
    loader = DataLoader(SyntheticTrackingDataset(cfg["DATA_CONFIG"]), 4, shuffle=True, drop_last=True, num_workers=0)
    batches = list(itertools.islice(loader, 2))
    opt = Optimizer(model.parameters(), cfg["OPTIMIZATION"], iters_per_epoch=len(loader))
    step = make_train_step(cfg["MODEL"], cuda_device)
    timer.reset()
    for batch in batches:  # the eager first dispatch, then a replay
        step(model, opt, batch)
    torch.cuda.synchronize()
    assert timer.counter("launches.group_fwd") == 14 and timer.counter("launches.tf32x3") == 0
