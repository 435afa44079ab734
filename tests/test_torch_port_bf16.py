"""OPTIMIZATION.MIXED_PRECISION on the CPU: the port's bf16 train step against
the JAX package's ``make_train_step(mixed_precision=True)``.

The JAX step casts the parameters and the batch's floats to bf16 inside the
differentiated function and lets flax's promotion decide every layer's type;
the port does the same with ``torch.func.functional_call`` on bf16 copies and
layers that promote as flax does (``nn/layers.py``), not autocast. Checked:

- a SharedMLP stack in train mode, on bf16 parameters, with a bf16 input (the
  plain path's flow: bf16 throughout, BatchNorm statistics in float32) and
  with a float32 input (the kernel path's flow: grouped_first_linear returns
  float32, so the rest of the stage computes in float32 with bf16 weights):
  the output's type equal to flax's and the values within 2e-2 of the largest
  entry (a few bf16 roundings), the running statistics float32 and within
  1e-2 of flax's, relative to each array's largest entry;
- the group wrapper on bf16 inputs: float32 output equal to the call on the
  inputs cast up, gradients back in bf16, and within 5e-4 of the JAX
  package's kernel (interpreted) on the same bf16 inputs;
- one whole step from the same weights and batch at narrow widths: the output
  types of the forward equal to JAX's; the loss nearer JAX's bf16 loss than
  its float32 loss; the gradients of the heads' output layers nearer JAX's
  bf16 gradients than the float32 gradients of the same state are, by a
  factor: the norm of (port bf16 - JAX bf16) at most 0.6 of the norm of (JAX
  bf16 - JAX float32), where a float32 step would sit near 1. That shows the
  bf16 path is taken. Deeper layers are not compared: their gradients pass
  max-pools whose bf16 near-ties the two frameworks round differently (one
  bf16 ulp apart in a few values of a stage), and there the two bf16 steps
  part as far as bf16 and float32 do. The master parameters, the optimizer
  state and the running statistics stay float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.nn import layers as jlayers
from ptt_tpu.ops.pallas_group import grouped_first_linear as jgroup
from ptt_tpu.train.train_state import TrainState
from ptt_tpu.train.train_state import make_train_step as jmake_train_step
from ptt_tpu_torch.config import ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_variables
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.nn import build_network, layers
from ptt_tpu_torch.ops import group
from ptt_tpu_torch.train.optim import Optimizer
from ptt_tpu_torch.train.train_step import cast_floats, make_train_step, to_device
from tests.test_torch_port_train import narrow_model_cfg, small_data_cfg

torch.set_num_threads(1)

MLP_TOL, STATS_TOL = 2e-2, 1e-2
GROUP_TOL = 5e-4
HEAD_RATIO = 0.6
HEAD_PARAMS = ("centroid_voting_head.cls_fc.linears.2.weight", "centroid_voting_head.reg_fc.linears.2.bias",
               "box_voting_head.fc.linears.2.weight", "box_voting_head.fc.linears.2.bias")


def _bf16(tree):
    return jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating) else x,
                                  tree)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not torch.is_tensor(x) else x.detach().float().numpy()


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("input_dtype", ["bfloat16", "float32"], ids=["plain_flow", "kernel_flow"])
def test_shared_mlp_follows_flax_promotion(rng, input_dtype):
    channels = [7, 16, 16, 32]
    x = rng.standard_normal((4, 24, 8, 7)).astype(np.float32)
    jm = jlayers.SharedMLP(channels)
    v = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a, train=False))(jnp.asarray(x))
    v = jax.tree_util.tree_map(lambda a: a + 0.05 * jnp.asarray(rng.standard_normal(a.shape), a.dtype), v)
    jx = jnp.asarray(x, jnp.dtype(input_dtype))
    jout, mut = jax.jit(lambda p, s, a: jm.apply({"params": _bf16(p), "batch_stats": s}, a, train=True,
                                                 mutable=["batch_stats"]))(v["params"], v["batch_stats"], jx)

    tm = layers.SharedMLP(channels)
    with torch.no_grad():
        for i in range(len(channels) - 1):
            tm.linears[i].weight.copy_(torch.tensor(np.asarray(v["params"][f"Dense_{i}"]["kernel"]).T))
            bn, p, s = tm.bns[i], v["params"][f"BatchNorm_{i}"], v["batch_stats"][f"BatchNorm_{i}"]
            for t, a in ((bn.weight, p["scale"]), (bn.bias, p["bias"]), (bn.running_mean, s["mean"]),
                         (bn.running_var, s["var"])):
                t.copy_(torch.tensor(np.asarray(a)))
    tm.train()
    for bn in tm.bns:
        bn.momentum = 0.1  # flax momentum 0.9
    params = {n: p.to(torch.bfloat16) for n, p in tm.named_parameters()}
    out = torch.func.functional_call(tm, params, (torch.from_numpy(x).to(getattr(torch, input_dtype)),))
    assert str(out.dtype).split(".")[1] == str(jout.dtype)
    assert _rel(out, jout) <= MLP_TOL
    for i, bn in enumerate(tm.bns):
        stats = mut["batch_stats"][f"BatchNorm_{i}"]
        assert bn.running_mean.dtype == bn.running_var.dtype == torch.float32
        assert _rel(bn.running_mean, stats["mean"]) <= STATS_TOL and _rel(bn.running_var, stats["var"]) <= STATS_TOL


def test_group_wrapper_takes_bf16(rng):
    B, N, M, C, H, ns, r = 2, 96, 32, 5, 64, 16, 0.6
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    arrays = {"xyz": xyz, "new_xyz": xyz[:, :M].copy(), "features": rng.standard_normal((B, N, C)).astype(np.float32),
              "w1": (rng.standard_normal((C + 3, H)) * 0.2).astype(np.float32)}
    ts = {k: torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for k, a in arrays.items()}
    out = group.grouped_first_linear(ts["xyz"], ts["new_xyz"], ts["features"], ts["w1"], r, ns)
    assert out.dtype == torch.float32
    up = group.grouped_first_linear(*(ts[k].detach().float() for k in ("xyz", "new_xyz", "features", "w1")), r, ns)
    assert torch.equal(out, up)
    out.sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in ts.values())
    ref = jgroup(*(jnp.asarray(a, jnp.bfloat16) for a in arrays.values()), r, ns, interpret=True)
    assert ref.dtype == jnp.float32 and _rel(out, ref) <= GROUP_TOL


def _p2b(cfg):
    cfg["NAME"] = "P2B"
    cfg["BACKBONE_3D"]["SA_CONFIG"]["SAMPLE_METHOD"] = ["sequence"] * 3
    for head in ("CENTROID_HEAD", "BOX_HEAD"):
        cfg[head]["TRANSFORMER_BLOCK"]["ENABLE"] = False
    return cfg


def _grab_grads():
    """An optax transformation that keeps the gradients in its state and
    updates nothing."""
    def update(g, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, g), {"g": g}

    return optax.GradientTransformation(lambda p: {"g": jax.tree_util.tree_map(jnp.zeros_like, p)}, update)


@pytest.mark.parametrize("model", ["ptt", "p2b"])
def test_bf16_train_step_against_jax(model):
    model_cfg = narrow_model_cfg() if model == "ptt" else _p2b(narrow_model_cfg())
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg()), 4, shuffle=True, drop_last=True, num_workers=1)
    batch = next(iter(loader))
    jm = jbuild(model_cfg)
    sample = {k: jnp.asarray(batch[k]) for k in ("search_points", "template_points")}
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b, train=False))(sample))

    def jax_step(mixed):
        tx = _grab_grads()
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"], opt_state=tx.init(variables["params"]), tx=tx,
                           apply_fn=jm.apply)
        state, met = jax.jit(jmake_train_step(model_cfg, mixed_precision=mixed))(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        grads = state_dict_from_variables({"params": jax.device_get(state.opt_state["g"]),
                                           "batch_stats": jax.device_get(state.batch_stats)})
        return float(met["loss"]), grads

    j16_loss, j16 = jax_step(True)
    j32_loss, j32 = jax_step(False)

    tm = build_network(model_cfg, device="cpu", train=True)
    tm.load_state_dict(state_dict_from_variables(variables), strict=True)
    opt = Optimizer(tm.parameters(), ptt_synth_config()["OPTIMIZATION"], iters_per_epoch=1)
    met = make_train_step(model_cfg, device="cpu", mixed_precision=True)(tm, opt, batch)
    loss = float(met["loss"])
    assert np.isfinite(loss) and abs(loss - j16_loss) < abs(loss - j32_loss)
    for name in HEAD_PARAMS:
        g = tm.get_parameter(name).grad
        assert g.dtype == torch.float32
        to_bf16 = float(np.linalg.norm(_np(g) - _np(j16[name])))
        bf16_to_f32 = float(np.linalg.norm(_np(j16[name]) - _np(j32[name])))
        assert to_bf16 <= HEAD_RATIO * bf16_to_f32, (name, to_bf16, bf16_to_f32)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(b.dtype in (torch.float32, torch.int64) for b in tm.buffers())
    assert all(m.dtype == torch.float32 for m in opt.mu + opt.nu)

    # the forward's output types are JAX's: bf16 up to the similarity module, float32 from it on
    with torch.no_grad():
        params = {n: p.to(torch.bfloat16) for n, p in tm.named_parameters()}
        out = torch.func.functional_call(tm, params, (cast_floats(to_device(batch, "cpu"), torch.bfloat16),))
    jout, _ = jm.apply({"params": _bf16(variables["params"]), "batch_stats": variables["batch_stats"]},
                       _bf16({k: jnp.asarray(v) for k, v in batch.items()}), train=True, mutable=["batch_stats"])
    assert {k: str(v.dtype).split(".")[1] for k, v in out.items()} == {k: str(v.dtype) for k, v in jout.items()}
