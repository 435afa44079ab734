"""The train step as one body over static tensors (``train/train_step.py``
``TrainStep``, ``make_multi_step``, ``stack_batches``), the optimizer's table
of per-step hyperparameters (``train/optim.py`` ``hyper_rows`` / ``update``),
the train-graph key (``utils/cuda_graph.py`` ``train_graph_key``) and the
Trainer's K-step dispatches with a stub capture, on the CPU at the narrowed
width, B = 4. The K-step body is held bit for bit against K single steps, and
against the JAX package's ``make_sharded_multi_step`` run in float64 with the
bands of ``test_torch_port_train.py``'s lockstep. The graph itself is held
against the eager step on the card (``chip_smoke.py`` phase 21)."""

import itertools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.train.optim import build_optimizer_and_schedule
from ptt_tpu.train.train_state import TrainState, make_data_mesh, make_sharded_multi_step, stack_shard_batches
from ptt_tpu_torch.config import ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_variables
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.nn import build_network, set_use_kernels
from ptt_tpu_torch.train import train_step
from ptt_tpu_torch.train.optim import HYPER, OPTIMIZERS, Optimizer
from ptt_tpu_torch.train.train_step import graph_mode, make_multi_step, make_train_step, stack_batches
from ptt_tpu_torch.train.trainer import Trainer
from ptt_tpu_torch.utils import cuda_graph
from tests.test_torch_port_data import _Scalars
from tests.test_torch_port_optim import EPOCHS, ITERS, _cfg
from tests.test_torch_port_train import narrow_model_cfg, small_data_cfg

torch.set_num_threads(1)

LOG = logging.getLogger("test_torch_port_train_graph")
TABLE_RTOL = 1e-6  # the table-form update against the scalar form it replaced, over 20 updates


def _batches(n: int, seed: int = 7) -> list:
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg(seed)), 4, shuffle=True, drop_last=True,
                        num_workers=0)
    return list(itertools.islice(loader, n))


def _fresh(optim_cfg, iters_per_epoch: int = 3):
    torch.manual_seed(0)
    model = build_network(narrow_model_cfg(), device="cpu", train=True)
    return model, Optimizer(model.parameters(), optim_cfg, iters_per_epoch=iters_per_epoch)


# ------------------------------------------------------------------ the K-step body


def test_multi_step_equals_single_steps_bit_for_bit():
    """``make_multi_step`` at K = 3 on the stacked batches: each step's metrics,
    the parameters, the BatchNorm statistics, Adam's moments and the count
    equal those of 3 calls of the single step, bit for bit."""
    model_cfg = narrow_model_cfg()
    optim_cfg = ptt_synth_config()["OPTIMIZATION"]
    batches = _batches(3)
    (single, single_opt), (multi, multi_opt) = _fresh(optim_cfg), _fresh(optim_cfg)
    step = make_train_step(model_cfg, device="cpu")
    want = [step(single, single_opt, b, 0.8) for b in batches]
    k_step = make_multi_step(model_cfg, 3, device="cpu")
    got = k_step(multi, multi_opt, stack_batches(batches), 0.8)
    assert got.shape == (3, len(k_step.names)) and k_step.names == tuple(want[0])
    for j, metrics in enumerate(k_step.metrics(got)):
        for name, value in metrics.items():
            assert torch.equal(value, want[j][name]), (j, name)
    assert len({float(m["loss"]) for m in want}) == 3
    assert single_opt.count == multi_opt.count == 3
    for key, value in single.state_dict().items():
        assert torch.equal(value, multi.state_dict()[key]), key
    for a, b in zip(single_opt.mu + single_opt.nu, multi_opt.mu + multi_opt.nu):
        assert torch.equal(a, b)
    assert not k_step.graphed and len(k_step.graphs) == 0


def _rel(a, b) -> float:
    return abs(a - b) / abs(b)


def test_multi_step_lockstep_with_jax_multi_step():
    """K = 3 in one dispatch against the JAX ``make_sharded_multi_step`` on a
    one-device mesh, run in float64 from the same float32 weights and batches
    (``test_torch_port_train.py``'s lockstep, whose bands this takes): step-0
    loss rel 2e-5, steps 1-2 rel 5e-3, step-0 grad_norm rel 1e-4, every step's
    loss terms within the loss's band of their step."""
    model_cfg = narrow_model_cfg()
    optim_cfg = ptt_synth_config()["OPTIMIZATION"]
    batches = _batches(3)

    jm = jbuild(model_cfg)
    tx, _ = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=3, total_epochs=1)
    sample = {k: jnp.asarray(batches[0][k]) for k in ("search_points", "template_points")}
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b, train=False))(sample))
    tm = build_network(model_cfg, device="cpu", train=True)
    tm.load_state_dict(state_dict_from_variables(variables), strict=True)
    opt = Optimizer(tm.parameters(), optim_cfg, iters_per_epoch=3)
    k_step = make_multi_step(model_cfg, 3, device="cpu")
    tmet = k_step.metrics(k_step(tm, opt, stack_batches(batches)))

    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), tree)  # noqa: E731
        params = f64(variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=f64(variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
        mesh = make_data_mesh(jax.devices()[:1])
        multi = make_sharded_multi_step(model_cfg, mesh, k=3)
        state, jmet = multi(state, stack_shard_batches([{k: np.asarray(v, np.float64) for k, v in b.items()}
                                                        for b in batches], mesh))
        jmet = jax.device_get(jmet)
    assert int(state.step) == opt.count == 3
    for i, metrics in enumerate(tmet):
        band = 2e-5 if i == 0 else 5e-3
        assert np.isfinite(float(metrics["loss"]))
        assert _rel(float(metrics["loss"]), float(jmet["loss"][i])) <= band, (i, metrics["loss"], jmet["loss"][i])
        for name in ("centroids_cls_loss", "boxes_cls_loss"):
            assert _rel(float(metrics[name]), float(jmet[name][i])) <= band, (i, name)
    assert float(tmet[0]["grad_norm"]) == pytest.approx(float(jmet["grad_norm"][0]), rel=1e-4)


# ------------------------------------------------------------------ the optimizer's table


@pytest.mark.parametrize("scheduler", ["step", None])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_hyper_table_holds_the_schedules(name, scheduler):
    """Row j of ``hyper_rows(k)`` is update count + j's lr, b1 (adam_onecycle's
    OneCycle b1, else the fixed one), 1 - b1 and the two bias corrections, each
    the float32 of the Python float the scalar-form update used."""
    opt = Optimizer([torch.zeros(3, requires_grad=True)], _cfg(name, scheduler, 0.01), ITERS, EPOCHS)
    opt.count = 3
    table = opt.hyper_rows(ITERS * EPOCHS)
    assert table.dtype == torch.float32 and table.shape == (ITERS * EPOCHS, len(HYPER)) and not table.is_pinned()
    for j, count in enumerate(range(3, 3 + ITERS * EPOCHS)):
        b1 = opt.b1 if opt.mom_schedule is None else opt.mom_schedule(count)
        want = [opt.lr_schedule(count), b1, 1.0 - b1, 1.0 - b1 ** (count + 1), 1.0 - opt.b2 ** (count + 1)]
        assert table[j].tolist() == [float(np.float32(v)) for v in want], (j, count)
    if name == "adam_onecycle" and scheduler is None:
        assert len(set(table[:, 1].tolist())) > 1  # b1 moves


def _scalar_form_step(opt) -> torch.Tensor:
    """The update as ``Optimizer.step`` made it before the table: the moving
    hyperparameters as Python floats, the moment and parameter updates fused
    with their scale (``alpha``)."""
    with torch.no_grad():
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
        norm = torch.stack([(g * g).sum() for g in grads]).sum().sqrt()
        if opt.clip is not None:
            clipped = norm >= opt.clip
            grads = [torch.where(clipped, (g / norm) * opt.clip, g) for g in grads]
        l2 = opt.wd > 0 and opt.name in ("adam", "sgd")
        if l2:
            grads = torch._foreach_add(grads, opt.params, alpha=opt.wd)
        if opt.name == "sgd":
            torch._foreach_mul_(opt.mu, opt.momentum)
            torch._foreach_add_(opt.mu, grads)
            update = opt.mu
        else:
            b1 = opt.b1 if opt.mom_schedule is None else opt.mom_schedule(opt.count)
            b2 = opt.b2
            torch._foreach_mul_(opt.mu, b1)
            torch._foreach_add_(opt.mu, grads, alpha=1.0 - b1)
            torch._foreach_mul_(opt.nu, b2)
            torch._foreach_addcmul_(opt.nu, grads, grads, value=1.0 - b2)
            denom = torch._foreach_div(opt.nu, 1.0 - b2 ** (opt.count + 1))
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, opt.eps)
            update = torch._foreach_div(opt.mu, 1.0 - b1 ** (opt.count + 1))
            torch._foreach_div_(update, denom)
            if opt.wd > 0 and not l2:
                torch._foreach_add_(update, opt.params, alpha=opt.wd)
        torch._foreach_add_(opt.params, update, alpha=-opt.lr_schedule(opt.count))
        opt.count += 1
        return norm


@pytest.mark.parametrize("scheduler", ["step", None])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_table_form_update_matches_the_scalar_form(rng, name, scheduler):
    """20 updates with clip and weight decay on, every third gradient clipped:
    the table-form step within 1e-6 of each array's largest entry of the
    scalar form it replaced (parameters and moments; the worst measured on
    the CPU, 2.4e-7, is adam_onecycle's under OneCycle: the scalar form fuses
    a scale into its addition, one rounding fewer), the norms equal."""
    cfg = _cfg(name, scheduler, 0.02)
    init = [rng.standard_normal((6, 5)).astype(np.float32), rng.standard_normal(7).astype(np.float32)]
    table_params = [torch.tensor(a, requires_grad=True) for a in init]
    scalar_params = [torch.tensor(a, requires_grad=True) for a in init]
    table, scalar = Optimizer(table_params, cfg, ITERS, EPOCHS), Optimizer(scalar_params, cfg, ITERS, EPOCHS)
    worst = 0.0
    for step in range(ITERS * EPOCHS):
        scale = 30.0 if step % 3 == 0 else 0.5
        for a, b in zip(table_params, scalar_params):
            a.grad = torch.from_numpy((rng.standard_normal(a.shape) * scale).astype(np.float32))
            b.grad = a.grad.clone()
        assert torch.equal(table.step(), _scalar_form_step(scalar))
        for a, b in zip(table.params + table.mu + table.nu, scalar.params + scalar.mu + scalar.nu):
            worst = max(worst, float((a.detach() - b.detach()).abs().max() / b.detach().abs().max()))
    assert table.count == scalar.count == ITERS * EPOCHS
    assert worst <= TABLE_RTOL, worst


# ------------------------------------------------------------------ the graph's key and mode


def test_train_graph_key():
    """The same key for the same step, after a weight load in place and after
    the optimizer's state is loaded in place; a new key for another K, batch
    shape, mixed precision, BatchNorm momentum, eval mode, kernel switch,
    moved parameters and another optimizer's moments."""
    model, opt = _fresh(ptt_synth_config()["OPTIMIZATION"])
    stacked = {k: torch.from_numpy(v) for k, v in stack_batches(_batches(2)).items()}

    def key(k=2, batch=stacked, mixed=False, momentum=0.9, optimizer=opt):
        return cuda_graph.train_graph_key(k, batch, mixed, momentum, model, optimizer)

    first = key()
    others = [key(k=1), key(batch={k: v[:, :2] for k, v in stacked.items()}), key(mixed=True), key(momentum=0.8)]
    model.eval()
    others.append(key())
    model.train()
    set_use_kernels(model, False)
    others.append(key())
    set_use_kernels(model, True)
    with torch.no_grad():
        next(model.parameters()).mul_(2.0)  # in place: the graph reads the new weights
    opt.load_state_dict(opt.state_dict())  # in place: the moments keep their addresses
    assert key() == first
    others.append(key(optimizer=Optimizer(model.parameters(), ptt_synth_config()["OPTIMIZATION"], 3)))
    p = next(model.parameters())
    p.data = p.data.clone()  # moved: a new capture
    others.append(key())
    assert len({first, *others}) == len(others) + 1


def test_graph_mode_off_on_the_cpu_and_under_a_process_group(monkeypatch):
    """The step is graphed on a GPU of one process; on the CPU, or in a
    process group of more than one rank (gloo's collectives run from the
    host), it runs eagerly and says why."""
    assert graph_mode("cpu") == "off (CPU: the eager step)"
    assert graph_mode("cuda") == "on"
    monkeypatch.setattr(train_step, "get_dist_info", lambda: (1, 2))
    monkeypatch.setattr(torch.distributed, "get_backend", lambda group=None: "gloo")
    assert graph_mode("cuda") == "off (process group of 2 ranks on gloo)"
    assert graph_mode("cpu") == "off (CPU: the eager step)"


# ------------------------------------------------------------------ the Trainer, graphed with a stub capture


class _StubGraph:
    """StepGraph without CUDA: the eager first run, then an output that every
    replay rewrites in place, as a captured graph's output tensors are."""
    made = []

    def __init__(self, body, device):
        self.body, self.replays = body, 0
        self.first = body()
        self.output = torch.full_like(self.first, float("nan"))
        _StubGraph.made.append(self)

    def replay(self):
        self.replays += 1
        self.output.copy_(self.body())

    def release(self):
        pass


def test_trainer_k_step_dispatches_with_a_stub_capture(monkeypatch, tmp_path):
    """STEPS_PER_DISPATCH = 2 over 5 batches an epoch, two epochs, the graphed
    path with a stub capture whose replay rewrites its output: 2 dispatches of
    K = 2 and a tail through the K = 1 step each epoch (the JAX
    ``_run_epoch_multi``); every step's logged loss its own and equal to the
    eager Trainer's, the weights equal, ``accumulated_iter`` and the
    optimizer's count 10; one capture of each graph, replayed 3 and 1 times."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    data_cfg = dict(small_data_cfg(), NUM_TRACKLETS=1, FRAMES_PER_TRACKLET=5)  # 20 items, 5 steps an epoch
    optim_cfg = dict(ptt_synth_config()["OPTIMIZATION"], NUM_EPOCHS=2, STEPS_PER_DISPATCH=2)
    model_cfg = narrow_model_cfg()

    def run(graphed):
        torch.manual_seed(0)
        loader = DataLoader(SyntheticTrackingDataset(data_cfg), 4, shuffle=True, drop_last=True, num_workers=0)
        scalars = _Scalars()
        trainer = Trainer(build_network(model_cfg, device="cpu"), model_cfg, optim_cfg, loader,
                          tmp_path / str(graphed), LOG, device="cpu", tb_writer=scalars)
        trainer.train_step.steps.graphed = trainer.multi_step.graphed = graphed
        trainer.train()
        return trainer, [(value, step) for tag, value, step in scalars.rows if tag == "train/loss"]

    eager, want = run(False)
    assert not _StubGraph.made
    graphed, got = run(True)
    assert got == want and [step for _, step in got] == list(range(1, 11))
    assert len({value for value, _ in got}) == 10  # each step's own loss, not a dispatch's last repeated
    assert graphed.accumulated_iter == graphed.optimizer.count == eager.optimizer.count == 10
    for key, value in eager.model.state_dict().items():
        assert torch.equal(value, graphed.model.state_dict()[key]), key
    k2 = [g for g in _StubGraph.made if g.first.shape[0] == 2]
    k1 = [g for g in _StubGraph.made if g.first.shape[0] == 1]
    assert len(k2) == len(k1) == 1 and k2[0].replays == 3 and k1[0].replays == 1
    assert graphed.multi_step.graphs.captures == graphed.train_step.steps.graphs.captures == 1
