"""The train step as one body over static tensors (``train/train_step.py``
``TrainStep``, ``make_multi_step``, ``stack_batches``), the optimizer's table
of per-step hyperparameters (``train/optim.py`` ``hyper_rows`` / ``update``),
the train-graph key (``utils/cuda_graph.py`` ``train_graph_key``), the
Trainer's K-step dispatches with a stub capture whose graphs share one
``CaptureContext`` as the real ones do, and the BatchNorm momentum read from a
device tensor, on the CPU at the narrowed width, B = 4. The K-step body is
held bit for bit against K single steps, and against the JAX package's
``make_sharded_multi_step`` run in float64 with the bands of
``test_torch_port_train.py``'s lockstep; the momentum's update against the
Python-float form it replaced and against the JAX step ``with_bn_momentum``.
The graph itself is held against the eager step on the card
(``chip_smoke.py`` phase 21)."""

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
from ptt_tpu.train.train_state import make_train_step as jmake_train_step
from ptt_tpu_torch.config import ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_variables
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.nn import build_network, layers, set_use_kernels
from ptt_tpu_torch.train import bn_momentum, train_step
from ptt_tpu_torch.train.optim import HYPER, OPTIMIZERS, Optimizer
from ptt_tpu_torch.train.train_step import graph_mode, make_multi_step, make_train_step, stack_batches
from ptt_tpu_torch.train.trainer import Trainer
from ptt_tpu_torch.utils import cuda_graph
from tests.test_torch_port_data import _Scalars
from tests.test_torch_port_optim import EPOCHS, ITERS, _cfg
from tests.test_torch_port_train import narrow_model_cfg, small_data_cfg
from tests.test_torch_port_train import _rel as _array_rel

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
    shape, mixed precision, eval mode, kernel switch, moved parameters and
    another optimizer's moments."""
    model, opt = _fresh(ptt_synth_config()["OPTIMIZATION"])
    stacked = {k: torch.from_numpy(v) for k, v in stack_batches(_batches(2)).items()}

    def key(k=2, batch=stacked, mixed=False, optimizer=opt):
        return cuda_graph.train_graph_key(k, batch, mixed, model, optimizer)

    first = key()
    others = [key(k=1), key(batch={k: v[:, :2] for k, v in stacked.items()}), key(mixed=True)]
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
    """StepGraph without CUDA, in a ``CaptureContext`` as the real one is:
    the context's first graph runs its body eagerly and keeps the result as
    ``first``; a later graph runs no eager body, and its first dispatch is a
    replay. A replay rewrites ``output`` in place, as a captured graph's
    output tensors are, and the graphs of one context share one output
    buffer, their pool: a graph's output read after another graph's replay is
    that graph's numbers."""
    made = []

    def __init__(self, body, device, context=None):
        context = cuda_graph.CaptureContext(device) if context is None else context
        self.body, self.replays, self.context = body, 0, context
        self.eager = context.live == 0
        if self.eager:
            context.pool = object()  # a new pool
            context.buffer = torch.full((256,), float("nan"))
        self.pool, self.output = context.pool, None
        context.live += 1
        if self.eager:
            self.first = body()
            self._bind(self.first).fill_(float("nan"))  # the capture computes nothing
        else:
            self.replay()
            self.first = self.output
        _StubGraph.made.append(self)

    def _bind(self, out):
        if self.output is None:
            self.output = self.context.buffer[:out.numel()].view(out.shape)
        return self.output

    def replay(self):
        self.replays += 1
        out = self.body()
        self._bind(out).copy_(out)

    def release(self):
        self.context.live -= 1


def _trainer_runs(monkeypatch, tmp_path, epochs: int, **optim):
    """The Trainer on 5 batches an epoch for ``epochs`` epochs, eager and
    graphed with the stub capture, from one seed on the same batches: each
    Trainer and its logged (loss, step) rows."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    data_cfg = dict(small_data_cfg(), NUM_TRACKLETS=1, FRAMES_PER_TRACKLET=5)  # 20 items, 5 steps an epoch
    optim_cfg = dict(ptt_synth_config()["OPTIMIZATION"], NUM_EPOCHS=epochs, **optim)
    model_cfg = narrow_model_cfg()

    def run(graphed):
        torch.manual_seed(0)
        loader = DataLoader(SyntheticTrackingDataset(data_cfg), 4, shuffle=True, drop_last=True, num_workers=0)
        scalars = _Scalars()
        trainer = Trainer(build_network(model_cfg, device="cpu"), model_cfg, optim_cfg, loader,
                          tmp_path / str(graphed), LOG, device="cpu", tb_writer=scalars)
        for steps in (trainer.train_step.steps, trainer.multi_step):
            if steps is not None:
                steps.graphed = graphed
        trainer.train()
        return trainer, [(value, step) for tag, value, step in scalars.rows if tag == "train/loss"]

    eager, want = run(False)
    assert not _StubGraph.made
    graphed, got = run(True)
    return eager, want, graphed, got


def _same_state(a, b) -> bool:
    """Parameters, BatchNorm statistics and Adam's moments torch.equal."""
    return all(torch.equal(v, b.model.state_dict()[k]) for k, v in a.model.state_dict().items()) and \
        all(torch.equal(x, y) for x, y in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu))


def test_trainer_k_step_dispatches_with_a_stub_capture(monkeypatch, tmp_path):
    """STEPS_PER_DISPATCH = 2 over 5 batches an epoch, two epochs, the graphed
    path with a stub capture whose replay rewrites its output in a buffer the
    two graphs share: 2 dispatches of K = 2 and a tail through the K = 1 step
    each epoch (the JAX ``_run_epoch_multi``); every step's logged loss its
    own and equal to the eager Trainer's, the weights and moments equal,
    ``accumulated_iter`` and the optimizer's count 10; one capture of each
    graph, the K = 2 graph's first dispatch its eager run and 3 replays, the
    tail graph's 2 dispatches 2 replays (its first is its capture and a
    replay)."""
    eager, want, graphed, got = _trainer_runs(monkeypatch, tmp_path, 2, STEPS_PER_DISPATCH=2)
    assert got == want and [step for _, step in got] == list(range(1, 11))
    assert len({value for value, _ in got}) == 10  # each step's own loss, not a dispatch's last repeated
    assert graphed.accumulated_iter == graphed.optimizer.count == eager.optimizer.count == 10
    assert _same_state(eager, graphed)
    k2 = [g for g in _StubGraph.made if g.first.shape[0] == 2]
    k1 = [g for g in _StubGraph.made if g.first.shape[0] == 1]
    assert len(k2) == len(k1) == 1 and k2[0].replays == 3 and k1[0].replays == 2
    assert graphed.multi_step.graphs.captures == graphed.train_step.steps.graphs.captures == 1


def test_trainer_train_steps_share_one_capture_context(monkeypatch, tmp_path):
    """At STEPS_PER_DISPATCH = 2 the Trainer's two ``TrainStep``s take one
    ``CaptureContext``, and their graphs one pool handle; each ``TrainStep``
    made alone has a context of its own."""
    _, _, graphed, _ = _trainer_runs(monkeypatch, tmp_path, 1, STEPS_PER_DISPATCH=2)
    context = graphed.graph_context
    assert graphed.train_step.steps.context is graphed.multi_step.context is context
    pools = {id(e.graph.pool) for steps in (graphed.train_step.steps, graphed.multi_step) for e in steps.graphs.values()}
    assert len(pools) == 1 and len(_StubGraph.made) == 2 and context.live == 2
    a, b = make_train_step(narrow_model_cfg(), device="cpu"), make_multi_step(narrow_model_cfg(), 2, device="cpu")
    assert a.steps.context is not b.context


def test_only_a_contexts_first_graph_runs_eagerly(monkeypatch):
    """In one context the first graph runs its body eagerly before its
    capture; a second graph (another K) and a third (another batch shape)
    run none: each first dispatch is the capture and a replay. Each
    dispatch's metrics equal those of the eager step on the same state, bit
    for bit. Once every graph of the context is released, the next graph is
    a first graph again."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    model_cfg, optim_cfg = narrow_model_cfg(), ptt_synth_config()["OPTIMIZATION"]
    batches = _batches(4)
    (model, opt), (ref, ref_opt) = _fresh(optim_cfg), _fresh(optim_cfg)
    context = cuda_graph.CaptureContext(torch.device("cpu"))
    one = make_train_step(model_cfg, device="cpu", context=context)
    two = make_multi_step(model_cfg, 2, device="cpu", context=context)
    eager_one, eager_two = make_train_step(model_cfg, device="cpu"), make_multi_step(model_cfg, 2, device="cpu")
    for steps in (one.steps, two):
        steps.graphed = True
    calls = []
    for name, step, ref_step, arg in (("K = 2", two, eager_two, stack_batches(batches[:2])),
                                      ("K = 1", one, eager_one, batches[2]),
                                      ("K = 1, B = 2", one, eager_one, {k: v[:2] for k, v in batches[3].items()})):
        got, want = step(model, opt, arg), ref_step(ref, ref_opt, arg)
        calls.append(name)
        if isinstance(got, dict):
            assert all(torch.equal(got[k], want[k]) for k in want), name
        else:
            assert torch.equal(got, want), name
    assert [g.eager for g in _StubGraph.made] == [True, False, False]
    assert [g.replays for g in _StubGraph.made] == [0, 1, 1]
    assert context.live == 3 and len({id(g.pool) for g in _StubGraph.made}) == 1
    one.steps.close()
    two.close()
    assert context.live == 0
    one(model, opt, batches[0])
    assert _StubGraph.made[-1].eager and _StubGraph.made[-1].pool is not _StubGraph.made[0].pool


def test_a_graphs_output_read_after_another_replay_is_wrong(monkeypatch):
    """The stub's pool rule holds (the two graphs' outputs share memory, so
    reading the K = 2 graph's output after the K = 1 graph's replay gives the
    K = 1 graph's numbers), and ``TrainStep`` returns a copy of each
    dispatch's metrics taken before any other replay."""
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    model_cfg = narrow_model_cfg()
    model, opt = _fresh(ptt_synth_config()["OPTIMIZATION"])
    batches = _batches(4)
    context = cuda_graph.CaptureContext(torch.device("cpu"))
    one = make_train_step(model_cfg, device="cpu", context=context)
    two = make_multi_step(model_cfg, 2, device="cpu", context=context)
    one.steps.graphed = two.graphed = True
    two(model, opt, stack_batches(batches[:2]))  # the eager first graph
    kept = two(model, opt, stack_batches(batches[2:]))  # a replay
    k2 = _StubGraph.made[0]
    before = k2.output.clone()
    assert torch.equal(kept, before)
    one(model, opt, batches[0])  # the K = 1 graph's capture and replay
    assert not torch.equal(k2.output[0], before[0]) and torch.equal(k2.output[0], _StubGraph.made[1].output[0])
    assert torch.equal(kept, before)


def test_bn_schedule_makes_one_capture_per_train_step(monkeypatch, tmp_path):
    """A BatchNorm schedule with DECAY_STEP 1 over 3 epochs (the momentum
    moves every epoch) at STEPS_PER_DISPATCH = 2: one capture per
    ``TrainStep``, every logged loss, the parameters, the running statistics
    and Adam's moments bit-equal to the eager Trainer's."""
    sched = {"BN_INIT": 0.5, "BN_DECAY": 0.5, "DECAY_STEP": 1, "BN_CLIP": 0.01}
    eager, want, graphed, got = _trainer_runs(monkeypatch, tmp_path, 3, STEPS_PER_DISPATCH=2, BN_SCHEDULER=sched)
    assert len({graphed._bn_momentum(e) for e in range(3)}) == 3
    assert got == want and len(got) == 15
    assert _same_state(eager, graphed)
    assert graphed.multi_step.graphs.captures == graphed.train_step.steps.graphs.captures == 1
    assert len(_StubGraph.made) == 2


def test_train_graph_key_holds_no_bn_momentum(monkeypatch):
    """``train_graph_key`` takes no momentum, and one ``TrainStep`` dispatched
    under three momenta keeps one graph, whose static BatchNorm factors hold
    each dispatch's: the running statistics after each bit-equal to the
    eager step's."""
    import inspect

    assert not any("momentum" in name for name in inspect.signature(cuda_graph.train_graph_key).parameters)
    monkeypatch.setattr(cuda_graph, "StepGraph", _StubGraph)
    _StubGraph.made = []
    model_cfg, optim_cfg = narrow_model_cfg(), ptt_synth_config()["OPTIMIZATION"]
    (model, opt), (ref, ref_opt) = _fresh(optim_cfg), _fresh(optim_cfg)
    step, eager = make_train_step(model_cfg, device="cpu"), make_train_step(model_cfg, device="cpu")
    step.steps.graphed = True
    for batch, momentum in zip(_batches(3), (0.5, 0.75, None)):
        step(model, opt, batch, momentum)
        eager(ref, ref_opt, batch, momentum)
        factors = step.steps.graphs.values()[0].state[2]
        assert torch.equal(factors, bn_momentum.flax_bn_factors(0.9 if momentum is None else momentum))
        assert all(torch.equal(v, ref.state_dict()[k]) for k, v in model.state_dict().items())
    assert step.steps.graphs.captures == 1 and len(_StubGraph.made) == 1


def test_device_bn_factors_reproduce_the_schedule():
    """The (keep, 1 - keep) pair the train step puts on the device for each
    epoch of a schedule: the float32 of the Python floats the update used
    before (flax m = 1 - torch m, torch momentum 1 - m, keep 1 - that), so
    1 - keep is ``bn_momentum_for_epoch`` to float32's rounding."""
    kw = {"bn_init": 0.5, "bn_decay": 0.5, "decay_step": 1, "bn_clip": 0.01}
    for epoch in range(12):
        torch_m = bn_momentum.bn_momentum_for_epoch(epoch, **kw)
        factors = bn_momentum.flax_bn_factors(1.0 - torch_m)
        keep = 1.0 - (1.0 - (1.0 - torch_m))
        assert factors.dtype == torch.float32 and factors.shape == (2,)
        assert factors.tolist() == [float(np.float32(keep)), float(np.float32(1.0 - keep))]
        assert abs(float(factors[1]) - torch_m) <= 2 ** -24 * torch_m * 2 and abs(float(factors[0]) - (1 - torch_m)) <= 2 ** -24


@pytest.mark.parametrize("flax_m", [0.9, 0.875, 0.99, 0.75, 0.5 + 1 / 3])
def test_bn_factor_update_bit_equal_to_the_python_float_form(rng, flax_m):
    """``nn/layers.py`` BatchNorm's update from the (2,) factors tensor (the
    device form) gives the running statistics of the Python-float form it
    replaced (keep = 1 - momentum as a float, times a float32 tensor), bit
    for bit, and so does the form without factors (from ``momentum``)."""
    bn = layers.BatchNorm(24, eps=layers.BN_EPS).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(24).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(np.abs(rng.standard_normal(24)).astype(np.float32) + 0.5))
    x = torch.from_numpy((rng.standard_normal((3, 17, 24)) * 2 + 1).astype(np.float32))
    old_mean, old_var = bn.running_mean.clone(), bn.running_var.clone()
    var, mean = torch.var_mean(x.reshape(-1, 24), dim=0, unbiased=False)
    keep = 1.0 - (1.0 - flax_m)  # the momentum attribute's value, then the update's float
    want_mean, want_var = keep * old_mean + (1.0 - keep) * mean, keep * old_var + (1.0 - keep) * var
    for factors in (bn_momentum.flax_bn_factors(flax_m), None):
        bn.running_mean.copy_(old_mean)
        bn.running_var.copy_(old_var)
        bn_momentum.set_bn_momentum(bn, 0.123 if factors is not None else flax_m)  # the factors win
        bn_momentum.set_bn_factors(bn, factors)
        bn(x)
        assert torch.equal(bn.running_mean, want_mean) and torch.equal(bn.running_var, want_var), factors


def test_device_bn_momentum_step_matches_jax_with_bn_momentum():
    """The train step with a scheduled momentum (its BatchNorm factors from a
    tensor) against the JAX step made ``with_bn_momentum``, whose momentum is
    a traced argument: one step of the narrowed model, B = 4, from the same
    converted weights, the JAX step in float64 as the lockstep runs it, under
    flax momentum 0.875 (torch 0.125, epoch 45 of the default schedule) and
    0.99; the loss within the lockstep's step-0 band 2e-5.

    A BatchNorm that the step calls once: its running statistics within 1e-4
    of each array's largest entry of the JAX step's (the lockstep's band for
    them, ``test_torch_port_train.py``). One that it calls n > 1 times (the
    backbone's, once a branch): the port applies the scheduled momentum at
    each call, as the reference's modules do; the JAX step runs the fixed
    momentum m0 = 0.9 and then re-blends with an observation recovered as if
    there had been one call (``rescale_batch_stats``: "exact for a single
    step"), which is another number. So, from each call's batch statistics
    o_1..o_n (recorded in the port, float64 below) and the old statistics:
    the port's within 1e-6 of mt^n old + sum (1 - mt) mt^(n-i) o_i, and the
    JAX step's within 1e-4 of its recovery mt old + (1 - mt) (S0 - m0 old) /
    (1 - m0), S0 = m0^n old + sum (1 - m0) m0^(n-i) o_i."""
    model_cfg = narrow_model_cfg()
    optim_cfg = ptt_synth_config()["OPTIMIZATION"]
    batch = _batches(1)[0]
    jm = jbuild(model_cfg)
    tx, _ = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=3, total_epochs=1)
    sample = {k: jnp.asarray(batch[k]) for k in ("search_points", "template_points")}
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b, train=False))(sample))
    m0 = bn_momentum.MODEL_BN_MOMENTUM
    multi_call = 0
    for flax_m in (1.0 - bn_momentum.bn_momentum_for_epoch(45), 0.99):
        tm = build_network(model_cfg, device="cpu", train=True)
        tm.load_state_dict(state_dict_from_variables(variables), strict=True)
        old = {k: v.double() for k, v in tm.state_dict().items()}
        calls = {}

        def record(module, args, name):
            var, mean = torch.var_mean(args[0].detach().reshape(-1, args[0].shape[-1]).float(), dim=0, unbiased=False)
            calls.setdefault(name, []).append({"running_mean": mean.double(), "running_var": var.double()})

        for name, m in tm.named_modules():
            if isinstance(m, layers.BatchNorm):
                m.register_forward_pre_hook(lambda module, args, name=name: record(module, args, name))
        opt = Optimizer(tm.parameters(), optim_cfg, iters_per_epoch=3)
        tmet = make_train_step(model_cfg, device="cpu")(tm, opt, batch, flax_m)
        with jax.enable_x64(True):
            f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), tree)  # noqa: E731
            params = f64(variables["params"])
            state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=f64(variables["batch_stats"]),
                               opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
            jstep = jax.jit(jmake_train_step(model_cfg, with_bn_momentum=True))
            state, jmet = jstep(state, f64(batch), jnp.float64(flax_m))
        assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 2e-5 * abs(float(jmet["loss"]))
        # the JAX step's statistics as the port's state_dict keys
        jstats = {k: torch.from_numpy(np.asarray(v)) for k, v in state_dict_from_variables(
            {"batch_stats": jax.device_get(state.batch_stats)}).items() if k.endswith(("_mean", "_var"))}
        assert {f"{name}.{s}" for name in calls for s in ("running_mean", "running_var")} == set(jstats)
        got = tm.state_dict()
        for name, observed in calls.items():
            n = len(observed)
            multi_call += n > 1
            for stat in ("running_mean", "running_var"):
                key, prev = f"{name}.{stat}", old[f"{name}.{stat}"]
                if n == 1:
                    assert _array_rel(got[key], jstats[key]) <= 1e-4, (flax_m, key)
                    continue
                port, fixed = flax_m ** n * prev, m0 ** n * prev
                for i, o in enumerate(observed, 1):
                    port = port + (1 - flax_m) * flax_m ** (n - i) * o[stat]
                    fixed = fixed + (1 - m0) * m0 ** (n - i) * o[stat]
                recovered = flax_m * prev + (1 - flax_m) * (fixed - m0 * prev) / (1 - m0)
                assert _array_rel(got[key].double(), port) <= 1e-6, (flax_m, key)
                assert _array_rel(jstats[key], recovered) <= 1e-4, (flax_m, key)
    assert multi_call > 0  # the backbone's BatchNorms took both branches
