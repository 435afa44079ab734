"""The port's training path against the JAX package's on the CPU: losses,
the Adam + StepLR + clip chain against optax, the BatchNorm momentum schedule,
train-mode modules against flax ``apply(train=True, mutable=["batch_stats"])``,
and ``make_train_step`` in lockstep with the JAX ``make_train_step`` from the
same converted weights on the same batches (docs/PARITY.md "Training-dynamics
lockstep" bands). Inputs are numpy arrays made from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.nn import heads as jheads
from ptt_tpu.nn import layers as jlayers
from ptt_tpu.nn import losses as jlosses
from ptt_tpu.nn import sa_module as jsa
from ptt_tpu.nn import similarity as jsim
from ptt_tpu.train import bn_momentum as jbnm
from ptt_tpu.train.optim import build_optimizer_and_schedule
from ptt_tpu.train.train_state import TrainState
from ptt_tpu.train.train_state import make_train_step as jmake_train_step
from ptt_tpu_torch.config import ptt_config, ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_variables, variables_from_state_dict
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset
from ptt_tpu_torch.nn import build_network, heads, layers, losses, sa_module, similarity
from ptt_tpu_torch.train import bn_momentum
from ptt_tpu_torch.train.optim import Optimizer
from ptt_tpu_torch.train.train_step import make_train_step

torch.set_num_threads(1)

TOL = 2e-4  # module outputs (docs/PARITY.md section 2.1)
STATS_RTOL = 1e-5  # running statistics after one call, relative to each array's largest entry


def narrow_model_cfg():
    """ptt.yaml's model with every width / 4 and fewer points (search 256,
    template 128 input points)."""
    cfg = ptt_config()["MODEL"]
    sa = cfg["BACKBONE_3D"]["SA_CONFIG"]
    sa.update(MLPS=[[0, 16, 16, 32], [32, 32, 32, 64], [64, 32, 32, 64]], NSAMPLE=[16, 16, 16],
              NPOINTS_SEARCH=[128, 64, 32], NPOINTS_TEMPLATE=[64, 32, 16])
    sim = cfg["SIMILARITY_MODULE"]
    sim["MLP"]["CHANNELS"] = [260, 64, 64, 64]
    sim["CONV"]["CHANNELS"] = [64, 64, 64]
    tb = {"DIM_INPUT": 64, "DIM_MODEL": 128, "KNN": 8}
    ch = cfg["CENTROID_HEAD"]
    ch["CLS_FC"]["CHANNELS"] = [64, 64, 64, 1]
    ch["REG_FC"]["CHANNELS"] = [67, 64, 64, 67]
    ch["TRANSFORMER_BLOCK"].update(tb)
    bh = cfg["BOX_HEAD"]
    bh["FC"] = [64, 64, 64, 5]
    bh["SA_CONFIG"].update(NPOINTS=16, NSAMPLE=8, MLPS=[65, 64, 64, 64])
    bh["TRANSFORMER_BLOCK"].update(tb)
    return cfg


def small_data_cfg(seed: int = 7):
    """ptt_synth.yaml's data at 4 tracklets x 4 frames (64 train items), with
    the narrowed model's 256 search and 128 template points."""
    return dict(ptt_synth_config()["DATA_CONFIG"], NUM_TRACKLETS=4, FRAMES_PER_TRACKLET=4,
                SEARCH_INPUT_SIZE=256, TEMPLATE_INPUT_SIZE=128, SYNTH_SEED=seed)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        out.update(_flat(v, key) if isinstance(v, dict) else {key: np.asarray(v)})
    return out


def _perturb(variables, rng):
    """Random weights with non-trivial BatchNorm statistics."""
    def f(path, x):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(np.abs(np.asarray(x) + 0.3 * noise) + 0.5)
        return x + 0.1 * jnp.asarray(noise)
    return jax.tree_util.tree_map_with_path(f, jax.device_get(variables))


def _load(tmod, variables, prefix):
    tmod.load_state_dict(state_dict_from_variables(jax.device_get(variables), prefix=prefix), strict=True)
    return tmod.train()


def _torch_stats(tmod, tprefix, fprefix):
    """The module's running statistics as flax ``batch_stats`` paths below
    ``fprefix`` (the module's flax path within the tracker)."""
    flat = variables_from_state_dict({f"{tprefix}.{k}": v for k, v in tmod.state_dict().items()})
    head = f"batch_stats/{fprefix}/"
    return {k[len(head):]: v for k, v in flat.items() if k.startswith(head)}


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(np.asarray(b)).max(), 1e-12))


def _check_stats(tmod, tprefix, fprefix, jstats):
    got, ref = _torch_stats(tmod, tprefix, fprefix), _flat(jstats)
    assert set(got) == set(ref) and ref
    for key in ref:
        assert _rel(got[key], ref[key]) <= STATS_RTOL, (key, _rel(got[key], ref[key]))


# ------------------------------------------------------------------------ losses


def test_losses_match_jax(rng):
    B, n, npp = 3, 64, 16
    cfg = ptt_config()["MODEL"]
    outputs = {
        "search_inds": rng.integers(0, 256, (B, n)).astype(np.int32),
        "pred_centroids_cls": rng.standard_normal((B, n)).astype(np.float32) * 4,
        "pred_centroids_votes": rng.standard_normal((B, n, 3)).astype(np.float32),
        "pred_box_center": (rng.standard_normal((B, npp, 3)) * 0.4).astype(np.float32),
        "pred_box_data": (rng.standard_normal((B, npp, 5)) * 2).astype(np.float32),
    }
    batch = {"cls_label": (rng.random((B, 256)) > 0.6).astype(np.float32),
             "reg_label": (rng.standard_normal((B, 4)) * 0.3).astype(np.float32)}
    jl, jtb = jlosses.compute_losses(cfg, {k: jnp.asarray(v) for k, v in outputs.items()},
                                     {k: jnp.asarray(v) for k, v in batch.items()})
    tl, ttb = losses.compute_losses(cfg, {k: torch.from_numpy(v) for k, v in outputs.items()},
                                    {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(ttb) == set(jtb)
    for key in jtb:
        np.testing.assert_allclose(float(ttb[key]), float(jtb[key]), rtol=1e-6, atol=1e-7, err_msg=key)
    x = np.linspace(-80, 80, 161, dtype=np.float32)
    z = (np.arange(161) % 2).astype(np.float32)
    np.testing.assert_allclose(losses.bce_with_logits(_t(x), _t(z), 2.0).numpy(),
                               np.asarray(jlosses.bce_with_logits(jnp.asarray(x), jnp.asarray(z), 2.0)),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------- optimizer


@pytest.mark.parametrize("weight_decay", [0, 0.01])
def test_adam_step_schedule_clip_match_optax(rng, weight_decay):
    """30 updates on a toy tree: the lr drops at steps 10 and 20, and every
    third step's gradient is large enough to be clipped."""
    optim_cfg = dict(ptt_synth_config()["OPTIMIZATION"], LR=0.01, STEP_SIZE=1, WEIGHT_DECAY=weight_decay)
    tx, schedule = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=10, total_epochs=3)
    init = {"a": rng.standard_normal((4, 3)).astype(np.float32), "b": rng.standard_normal(5).astype(np.float32)}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    jstate = tx.init(jparams)
    tparams = [_t(init["a"]).requires_grad_(True), _t(init["b"]).requires_grad_(True)]
    opt = Optimizer(tparams, optim_cfg, iters_per_epoch=10)
    clipped = 0
    for step in range(30):
        scale = 30.0 if step % 3 == 0 else 0.5
        g = {k: (rng.standard_normal(v.shape) * scale).astype(np.float32) for k, v in init.items()}
        assert opt.lr_schedule(step) == pytest.approx(float(schedule(step)), rel=1e-6)
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams, updates)
        tparams[0].grad, tparams[1].grad = _t(g["a"]), _t(g["b"])
        norm = float(opt.step())
        clipped += norm > 10
        assert norm == pytest.approx(float(np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))),
                                     rel=1e-5)
        for t, key in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jparams[key]), rtol=1e-5, atol=1e-6,
                                       err_msg=f"step {step} {key}")
    assert clipped == 10


def test_optimizer_refuses_unported_choices():
    """Every OPTIMIZER x SCHEDULER of the JAX package is ported; what it refuses
    (an unknown optimizer, a scheduler other than 'step' or none), the port
    refuses too."""
    base = ptt_synth_config()["OPTIMIZATION"]
    p = [torch.zeros(3, requires_grad=True)]
    for change in ({"OPTIMIZER": "rmsprop"}, {"OPTIMIZER": "lamb"}, {"SCHEDULER": "cosine"},
                   {"OPTIMIZER": "sgd", "SCHEDULER": "cosine"}):
        with pytest.raises(NotImplementedError):
            build_optimizer_and_schedule(dict(base, **change), iters_per_epoch=4, total_epochs=2)
        with pytest.raises(NotImplementedError):
            Optimizer(p, dict(base, **change), iters_per_epoch=4)


# -------------------------------------------------------------- BN momentum


def test_bn_momentum_schedule_and_update_match_jax(rng):
    for kw in ({}, {"bn_init": 0.3, "bn_decay": 0.7, "decay_step": 5, "bn_clip": 0.05}):
        for epoch in range(0, 120, 3):
            assert bn_momentum.bn_momentum_for_epoch(epoch, **kw) == jbnm.bn_momentum_for_epoch(epoch, **kw)
    x = rng.standard_normal((2, 30, 4, 6)).astype(np.float32) * 2 + 1
    jm = jlayers.SharedMLP([6, 16, 32])
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    _, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    target = 1.0 - bn_momentum.bn_momentum_for_epoch(45)  # flax momentum 0.875
    jstats = jbnm.rescale_batch_stats(v["batch_stats"], mut["batch_stats"], target)
    tm = _load(layers.SharedMLP([6, 16, 32]), v, "similarity_module/SharedMLP_0")
    bn_momentum.set_bn_momentum(tm, target)
    tm(_t(x))
    _check_stats(tm, "similarity_module.mlp", "similarity_module/SharedMLP_0", jstats)


# ------------------------------------------------------------------- modules


def test_shared_mlp_train(rng):
    x = (rng.standard_normal((2, 10, 4, 6)) * 3 + 2).astype(np.float32)
    jm = jlayers.SharedMLP([6, 16, 32])
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    jout, mut = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    tm = _load(layers.SharedMLP([6, 16, 32]), v, "similarity_module/SharedMLP_0")
    np.testing.assert_allclose(tm(_t(x)).detach().numpy(), np.asarray(jout), rtol=TOL, atol=TOL)
    _check_stats(tm, "similarity_module.mlp", "similarity_module/SharedMLP_0", mut["batch_stats"])


@pytest.mark.parametrize("C", [8, 0])
def test_sa_module_train(rng, C):
    B, N, M = 2, 256, 64
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, C)).astype(np.float32) if C else None
    kw = dict(mlp_channels=[C, 16, 32], radius=0.4, nsample=16, sample_method="fps")
    jm = jsa.PointnetSAModule(**kw)
    jargs = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    v = _perturb(jm.init(jax.random.PRNGKey(0), *jargs, npoint=M), rng)
    (jxyz, jfeat, jinds), mut = jm.apply(v, *jargs, npoint=M, train=True, mutable=["batch_stats"])
    tm = _load(sa_module.PointnetSAModule(**kw), v, "backbone_3d/sa_stages_0")
    txyz, tfeat, tinds = tm(_t(xyz), None if feats is None else _t(feats), npoint=M)
    np.testing.assert_array_equal(tinds.numpy(), np.asarray(jinds))
    np.testing.assert_array_equal(txyz.detach().numpy(), np.asarray(jxyz))
    np.testing.assert_allclose(tfeat.detach().numpy(), np.asarray(jfeat), rtol=TOL, atol=TOL)
    _check_stats(tm, "backbone_3d.sa_stages.0", "backbone_3d/sa_stages_0", mut["batch_stats"])


def test_cosine_sim_aug_train(rng):
    # 256 rows reach the ConvStack's BatchNorm: with 64, the float64 value is
    # 2e-4 from both frameworks' float32 outputs (small-batch statistics)
    B, n1, n2, C = 4, 16, 64, 24
    cfg = {"NAME": "CosineSimAug", "MLP": {"CHANNELS": [1 + 3 + C, 32, 32, 32], "BN": True},
           "CONV": {"CHANNELS": [32, 32, 32], "BN": True}}
    batch = {"search_feats": rng.standard_normal((B, n2, C)), "template_feats": rng.standard_normal((B, n1, C)),
             "template_seeds": rng.standard_normal((B, n1, 3))}
    jm = jsim.CosineSimAug(cfg)
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    v = _perturb(jm.init(jax.random.PRNGKey(0), jb), rng)
    jo, mut = jm.apply(v, jb, train=True, mutable=["batch_stats"])
    tm = _load(similarity.CosineSimAug(cfg), v, "similarity_module")
    to = tm({k: _t(x) for k, x in batch.items()})
    np.testing.assert_allclose(to["cosine_feats"].detach().numpy(), np.asarray(jo["cosine_feats"]),
                               rtol=TOL, atol=TOL)
    _check_stats(tm, "similarity_module", "similarity_module", mut["batch_stats"])


_TB = {"ENABLE": True, "NAME": "TransformerBlock", "DIM_INPUT": 24, "DIM_MODEL": 32, "KNN": 8,
       "N_HEADS": 1, "N_LAYERS": 1}


def test_heads_train(rng):
    B, n, C = 2, 64, 24
    ccfg = {"NAME": "CentroidVotingHead", "CLS_USE_SEARCH_XYZ": False, "CLS_FC": {"CHANNELS": [C, 32, 32, 1]},
            "REG_FC": {"CHANNELS": [3 + C, 32, 32, 3 + C]}, "TRANSFORMER_BLOCK": dict(_TB)}
    bcfg = {"NAME": "BoxVotingHead", "FC": [C, 32, 32, 5], "TRANSFORMER_BLOCK": dict(_TB),
            "SA_CONFIG": {"NPOINTS": 16, "RADIUS": 0.3, "NSAMPLE": 8, "MLPS": [1 + C, 32, 32, C],
                          "USE_XYZ": True, "NORMALIZE_XYZ": True, "SAMPLE_METHOD": "fps"}}
    batch = {"search_seeds": rng.standard_normal((B, n, 3)) * 0.3, "cosine_feats": rng.standard_normal((B, n, C))}
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    jc = jheads.CentroidVotingHead(ccfg)
    vc = _perturb(jax.jit(jc.init)(jax.random.PRNGKey(0), jb), rng)
    jo, mutc = jax.jit(lambda v, b: jc.apply(v, b, train=True, mutable=["batch_stats"]))(vc, jb)
    tc = _load(heads.CentroidVotingHead(ccfg), vc, "centroid_voting_head")
    to = tc({k: _t(x) for k, x in batch.items()})
    for key in ("pred_centroids_cls", "pred_centroids_votes", "votes_feats"):
        np.testing.assert_allclose(to[key].detach().numpy(), np.asarray(jo[key]), rtol=TOL, atol=TOL, err_msg=key)
    _check_stats(tc, "centroid_voting_head", "centroid_voting_head", mutc["batch_stats"])

    jb2 = {k: jo[k] for k in ("pred_centroids_votes", "votes_feats")}
    jbox = jheads.BoxVotingHead(bcfg)
    vb = _perturb(jax.jit(jbox.init)(jax.random.PRNGKey(1), jb2), rng)
    jo2, mutb = jax.jit(lambda v, b: jbox.apply(v, b, train=True, mutable=["batch_stats"]))(vb, jb2)
    tb = _load(heads.BoxVotingHead(bcfg), vb, "box_voting_head")
    to2 = tb({k: _t(np.asarray(v)) for k, v in jb2.items()})
    np.testing.assert_array_equal(to2["pred_box_center"].detach().numpy(), np.asarray(jo2["pred_box_center"]))
    np.testing.assert_allclose(to2["pred_box_data"].detach().numpy(), np.asarray(jo2["pred_box_data"]),
                               rtol=TOL, atol=TOL)
    _check_stats(tb, "box_voting_head", "box_voting_head", mutb["batch_stats"])


# ------------------------------------------------------------------ lockstep


def test_train_step_lockstep_with_jax():
    """3 steps of the narrowed model, B = 4, from the same converted weights on
    the same synthetic train batches: step-0 loss rel 2e-5, steps 1-2 rel
    <= 5e-3, step-0 grad_norm rel 1e-4, batch_stats after step 0 rel 1e-4.

    The JAX step runs in float64 (a scoped ``jax.enable_x64``) from the same
    float32 weights and batches. On the CPU, XLA's float32 reductions put the
    JAX package's own train step far from its float64 value at this size: its
    step-0 loss 0.4e-5 to 4.5e-5 away on random clouds (seven seeds), the
    band's size, and its step-0 gradient norm 4% away on these batches; the
    port's float32 step is within 1e-6 and 2e-5 of it."""
    model_cfg = narrow_model_cfg()
    optim_cfg = ptt_synth_config()["OPTIMIZATION"]
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg()), 4, shuffle=True, drop_last=True, num_workers=1)
    batches = list(loader)[:3]

    jm = jbuild(model_cfg)
    tx, _ = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=3, total_epochs=1)
    sample = {k: jnp.asarray(batches[0][k]) for k in ("search_points", "template_points")}
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b, train=False))(sample))
    tm = build_network(model_cfg, device="cpu", train=True)
    tm.load_state_dict(state_dict_from_variables(variables), strict=True)
    opt = Optimizer(tm.parameters(), optim_cfg, iters_per_epoch=3)
    tstep = make_train_step(model_cfg, device="cpu")

    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), tree)  # noqa: E731
        params = f64(variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=f64(variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
        jstep = jax.jit(jmake_train_step(model_cfg))
        for i, batch in enumerate(batches):
            state, jmet = jstep(state, f64(batch))
            tmet = tstep(tm, opt, batch)
            jloss, tloss = float(jmet["loss"]), float(tmet["loss"])
            assert np.isfinite(tloss)
            assert abs(tloss - jloss) <= (2e-5 if i == 0 else 5e-3) * abs(jloss), (i, tloss, jloss)
            if i == 0:
                assert float(tmet["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
                jstats = _flat(jax.device_get(state.batch_stats))
                tstats = {k[len("batch_stats/"):]: v for k, v in variables_from_state_dict(tm.state_dict()).items()
                          if k.startswith("batch_stats/")}
                assert set(tstats) == set(jstats)
                worst = max(_rel(tstats[k], jstats[k]) for k in jstats)
                assert worst <= 1e-4, worst


def test_build_network_train_flag():
    cfg = narrow_model_cfg()
    assert not build_network(cfg, device="cpu").training
    model = build_network(cfg, device="cpu", train=True)
    assert all(m.training for m in model.modules())
