"""Every OPTIMIZER x SCHEDULER of the JAX package's ``train/optim.py`` against
the port's ``train/optim.py`` on the CPU: ~20 updates in lockstep with
``build_optimizer_and_schedule``'s optax chain on seeded gradients, with
global-norm clipping and weight decay on; the OneCycle learning-rate and
momentum curves; and each optimizer's state through ``train/checkpoint.py``,
a resumed run continuing the schedule at its count.

Tolerances: parameters within 1e-6 of the largest entry of each array after
every update (float32 arithmetic in another order: optax rounds the update
before adding it, the port may fuse the two); the schedules within 1e-6
relative in the lockstep, and the whole OneCycle curves within 1e-6 of their
peak: both packages evaluate them in float32, but near the end of a phase
cos + 1 cancels and an ulp of the two cosines (XLA's and numpy's) shows."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.train.optim import build_optimizer_and_schedule, fastai_onecycle_schedules
from ptt_tpu_torch.config import ptt_synth_config
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.train.checkpoint import CheckpointManager
from ptt_tpu_torch.train.optim import OPTIMIZERS, Optimizer, onecycle_schedules
from tests.test_torch_port_train import narrow_model_cfg

torch.set_num_threads(1)

PARAM_TOL = 1e-6
SCHEDULE_RTOL = 1e-6
ITERS, EPOCHS = 5, 4  # 20 updates: OneCycle's rise (8) and part of its fall; StepLR drops twice


def _cfg(name, scheduler, wd):
    cfg = dict(ptt_synth_config()["OPTIMIZATION"], OPTIMIZER=name, LR=0.01, WEIGHT_DECAY=wd, STEP_SIZE=2,
               GAMMA=0.5, MOMENTUM=0.8, GRAD_NORM_CLIP=10)
    if scheduler is None:
        cfg.pop("SCHEDULER")
    else:
        cfg["SCHEDULER"] = scheduler
    return cfg


@pytest.mark.parametrize("wd", [0.0, 0.02])
@pytest.mark.parametrize("scheduler", ["step", None])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_optimizer_lockstep_with_optax(rng, name, scheduler, wd):
    """20 updates of a toy tree; every third gradient is large enough to be clipped."""
    optim_cfg = _cfg(name, scheduler, wd)
    tx, schedule = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=ITERS, total_epochs=EPOCHS)
    init = {"a": rng.standard_normal((6, 5)).astype(np.float32), "b": rng.standard_normal(7).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = [torch.tensor(init["a"], requires_grad=True), torch.tensor(init["b"], requires_grad=True)]
    opt = Optimizer(tparams, optim_cfg, iters_per_epoch=ITERS, total_epochs=EPOCHS)
    clipped = 0
    for step in range(ITERS * EPOCHS):
        scale = 30.0 if step % 3 == 0 else 0.5
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in init.items()}
        assert opt.lr_schedule(step) == pytest.approx(float(schedule(step)), rel=SCHEDULE_RTOL)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tparams[0].grad, tparams[1].grad = torch.from_numpy(g["a"]), torch.from_numpy(g["b"])
        clipped += float(opt.step()) >= 10
        for t, key in zip(tparams, ("a", "b")):
            ref = np.asarray(jparams[key])
            err = np.abs(t.detach().numpy() - ref).max() / np.abs(ref).max()
            assert err <= PARAM_TOL, (step, key, err)
    assert clipped == 7 and opt.count == ITERS * EPOCHS


@pytest.mark.parametrize("total_steps,moms,div,pct", [(20, [0.95, 0.85], 10.0, 0.4), (1000, [0.9, 0.8], 25.0, 0.3),
                                                      (7, [0.95, 0.85], 10.0, 0.0)])
def test_onecycle_curves_equal_jax(total_steps, moms, div, pct):
    jlr, jmom = fastai_onecycle_schedules(total_steps, 0.003, moms, div, pct)
    lr, mom = onecycle_schedules(total_steps, 0.003, moms, div, pct)
    for count in range(total_steps + 2):  # within float32 rounding of the curve's peak (see the module note)
        assert lr(count) == pytest.approx(float(jlr(count)), rel=0, abs=SCHEDULE_RTOL * 0.003)
        assert mom(count) == pytest.approx(float(jmom(count)), rel=0, abs=SCHEDULE_RTOL * max(moms))
    a1 = int(total_steps * pct)  # the rise (none at PCT_START 0) ends at lr_max and the lowest b1
    assert lr(0) == pytest.approx(0.003 / div if a1 else 0.003) and lr(a1) == pytest.approx(0.003)
    assert mom(a1) == pytest.approx(moms[1])


def test_adam_onecycle_moves_b1_and_step_fixes_it(rng):
    """adam_onecycle reads BETAS nowhere: b2 is 0.99, b1 follows MOMS, or is 0.9
    under SCHEDULER 'step'."""
    p = [torch.zeros(3, requires_grad=True)]
    opt = Optimizer(p, _cfg("adam_onecycle", None, 0.0), ITERS, EPOCHS)
    assert (opt.b2, opt.eps) == (0.99, 1e-8) and opt.mom_schedule(0) == pytest.approx(0.95)
    fixed = Optimizer(p, _cfg("adam_onecycle", "step", 0.0), ITERS, EPOCHS)
    assert (fixed.b1, fixed.b2, fixed.mom_schedule) == (0.9, 0.99, None)
    assert Optimizer(p, _cfg("adam", None, 0.0), ITERS, EPOCHS).mom_schedule is None


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_state_round_trips_and_resume_continues_the_schedule(tmp_path, name):
    """Two updates, a checkpoint, a fresh optimizer restored from it: the same
    count and state; its third update equals the uninterrupted run's."""
    optim_cfg = _cfg(name, None, 0.01)

    def fresh():
        torch.manual_seed(0)
        model = build_network(narrow_model_cfg(), device="cpu", train=True)
        return model, Optimizer(model.parameters(), optim_cfg, iters_per_epoch=ITERS, total_epochs=EPOCHS)

    def update(opt, k):
        for i, p in enumerate(opt.params):
            p.grad = torch.full_like(p, 0.01 * (k + 1) * (-1) ** i)
        opt.step()

    model, opt = fresh()
    for k in range(2):
        update(opt, k)
    mgr = CheckpointManager(tmp_path / "ckpt")
    mgr.save(model, opt, epoch=1, step=2)
    update(opt, 2)

    resumed_model, resumed = fresh()
    assert mgr.restore(resumed_model, resumed) == (1, 2)
    assert resumed.count == 2 and resumed.lr_schedule(resumed.count) == opt.lr_schedule(2)
    update(resumed, 2)
    for a, b in zip(resumed.params, opt.params):
        assert torch.equal(a, b)
    other = "sgd" if name != "sgd" else "adam"
    with pytest.raises(ValueError):
        Optimizer(resumed.params, _cfg(other, None, 0.01), ITERS, EPOCHS).load_state_dict(resumed.state_dict())
