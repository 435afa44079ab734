"""The port's modules (``ptt_tpu_torch.nn``) against their flax counterparts on
the same weights, carried over by ``ptt_tpu_torch.convert``, and the same
numpy inputs. Module outputs agree to 2e-4 (docs/PARITY.md section 2.1), the
whole forward's boxes to 2e-3, sample indices exactly."""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.nn import heads as jheads
from ptt_tpu.nn import layers as jlayers
from ptt_tpu.nn import sa_module as jsa
from ptt_tpu.nn import similarity as jsim
from ptt_tpu.nn import transformer as jtr
from ptt_tpu.train.checkpoint import load_variables_npz
from ptt_tpu_torch.config import PTT_CFG, ptt_config
from ptt_tpu_torch.convert import state_dict_from_npz, state_dict_from_variables
from ptt_tpu_torch.nn import build_network, heads, layers, sa_module, similarity, transformer

torch.set_num_threads(1)

ASSET = Path(__file__).parent / "assets" / "ptt_synth_trained.npz"
TOL = 2e-4


def _perturb(variables, rng):
    """Random weights with non-trivial BatchNorm statistics."""
    def f(path, x):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(np.abs(np.asarray(x) + 0.3 * noise) + 0.5)
        return x + 0.1 * jnp.asarray(noise)
    return jax.tree_util.tree_map_with_path(f, variables)


def _load(tmod, variables, prefix):
    tmod.load_state_dict(state_dict_from_variables(jax.device_get(variables), prefix=prefix), strict=True)
    return tmod.eval()


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), _np(ref), rtol=tol, atol=tol)


# ----------------------------------------------------------------------- layers


def test_shared_mlp(rng):
    x = rng.standard_normal((2, 10, 4, 6)).astype(np.float32)
    jm = jlayers.SharedMLP([6, 16, 32])
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = _load(layers.SharedMLP([6, 16, 32]), v, "similarity_module/SharedMLP_0")
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


def test_conv_stack(rng):
    x = rng.standard_normal((2, 10, 12)).astype(np.float32)
    jm = jlayers.ConvStack([12, 16, 16, 5])
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    tm = _load(layers.ConvStack([12, 16, 16, 5]), v, "similarity_module/ConvStack_0")
    _close(tm(_t(x)), jm.apply(v, jnp.asarray(x)))


@pytest.mark.parametrize("C,method", [(8, "fps"), (0, "fps"), (8, "sequence")])
def test_sa_module(rng, C, method):
    B, N, M = 2, 256, 64
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    xyz[:, N // 2:] = xyz[:, : N // 2]  # duplicates: FPS ties
    feats = rng.standard_normal((B, N, C)).astype(np.float32) if C else None
    kw = dict(mlp_channels=[C, 16, 32], radius=0.4, nsample=16, sample_method=method)
    jm = jsa.PointnetSAModule(**kw)
    jargs = (jnp.asarray(xyz), None if feats is None else jnp.asarray(feats))
    v = _perturb(jm.init(jax.random.PRNGKey(0), *jargs, npoint=M), rng)
    jxyz, jfeat, jinds = jm.apply(v, *jargs, npoint=M)
    tm = _load(sa_module.PointnetSAModule(**kw), v, "backbone_3d/sa_stages_0")
    txyz, tfeat, tinds = tm(_t(xyz), None if feats is None else _t(feats), npoint=M)
    np.testing.assert_array_equal(tinds.numpy(), _np(jinds))
    np.testing.assert_array_equal(txyz.numpy(), _np(jxyz))
    _close(tfeat, jfeat)


def test_cosine_sim_aug(rng):
    B, n1, n2, C = 2, 16, 32, 24
    cfg = {"NAME": "CosineSimAug", "MLP": {"CHANNELS": [1 + 3 + C, 32, 32, 32], "BN": True},
           "CONV": {"CHANNELS": [32, 32, 32], "BN": True}}
    batch = {"search_feats": rng.standard_normal((B, n2, C)), "template_feats": rng.standard_normal((B, n1, C)),
             "template_seeds": rng.standard_normal((B, n1, 3))}
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    jm = jsim.CosineSimAug(cfg)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jb), rng)
    tm = _load(similarity.CosineSimAug(cfg), v, "similarity_module")
    _close(tm({k: _t(x) for k, x in batch.items()})["cosine_feats"], jm.apply(v, jb)["cosine_feats"])


def test_transformer_block(rng):
    B, N, d, dm, k = 2, 40, 24, 32, 8
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, d)).astype(np.float32)
    jm = jtr.TransformerBlock(d, dm, k)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz), jnp.asarray(feats)), rng)
    jout, jattn = jm.apply(v, jnp.asarray(xyz), jnp.asarray(feats))
    tm = _load(transformer.TransformerBlock(d, dm, k), v, "centroid_voting_head/transformer_block")
    tout, tattn = tm(_t(xyz), _t(feats))
    _close(tout, jout)
    _close(tattn, jattn)


_TB = {"ENABLE": True, "NAME": "TransformerBlock", "DIM_INPUT": 24, "DIM_MODEL": 32, "KNN": 8,
       "N_HEADS": 1, "N_LAYERS": 1}


def test_centroid_voting_head(rng):
    B, n, C = 2, 32, 24
    cfg = {"NAME": "CentroidVotingHead", "CLS_USE_SEARCH_XYZ": False, "CLS_FC": {"CHANNELS": [C, 32, 32, 1]},
           "REG_FC": {"CHANNELS": [3 + C, 32, 32, 3 + C]}, "TRANSFORMER_BLOCK": dict(_TB)}
    batch = {"search_seeds": rng.standard_normal((B, n, 3)), "cosine_feats": rng.standard_normal((B, n, C))}
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    jm = jheads.CentroidVotingHead(cfg)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jb), rng)
    jo = jm.apply(v, jb)
    to = _load(heads.CentroidVotingHead(cfg), v, "centroid_voting_head")({k: _t(x) for k, x in batch.items()})
    for key in ("pred_centroids_cls", "pred_centroids_votes", "votes_feats"):
        _close(to[key], jo[key])


def test_box_voting_head(rng):
    B, n, C = 2, 64, 24
    cfg = {"NAME": "BoxVotingHead", "FC": [C, 32, 32, 5], "TRANSFORMER_BLOCK": dict(_TB),
           "SA_CONFIG": {"NPOINTS": 16, "RADIUS": 0.3, "NSAMPLE": 8, "MLPS": [1 + C, 32, 32, C],
                         "USE_XYZ": True, "NORMALIZE_XYZ": True, "SAMPLE_METHOD": "fps"}}
    batch = {"pred_centroids_votes": rng.standard_normal((B, n, 3)) * 0.3,
             "votes_feats": rng.standard_normal((B, n, 1 + C))}
    jb = {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()}
    jm = jheads.BoxVotingHead(cfg)
    v = _perturb(jm.init(jax.random.PRNGKey(0), jb), rng)
    jo = jm.apply(v, jb)
    to = _load(heads.BoxVotingHead(cfg), v, "box_voting_head")({k: _t(x) for k, x in batch.items()})
    np.testing.assert_array_equal(to["pred_box_center"].numpy(), _np(jo["pred_box_center"]))
    _close(to["pred_box_data"], jo["pred_box_data"])


# -------------------------------------------------------------- the whole model


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def test_config_matches_yaml():
    cfg = cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml")
    assert PTT_CFG["MODEL"] == _plain(cfg.MODEL)
    assert PTT_CFG["TEST"] == _plain(cfg.TEST)
    assert PTT_CFG["CLASS_NAMES"] == cfg.CLASS_NAMES
    for key, value in PTT_CFG["DATA_CONFIG"].items():
        assert value == cfg.DATA_CONFIG[key], key
    fresh = ptt_config()
    fresh["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] = 9.0
    assert PTT_CFG["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] == 0.3


def test_build_network_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    with pytest.raises(RuntimeError):
        build_network(copy.deepcopy(PTT_CFG["MODEL"]))


def test_full_forward_matches_jax_on_trained_asset():
    """Full ptt.yaml width on the committed trained weights, two frames of
    object-like clouds (duplicated points included, as resampling makes them)."""
    cfg = cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml")
    jm = jbuild(cfg.MODEL)
    params, batch_stats, _ = load_variables_npz(ASSET)
    tm = build_network(ptt_config()["MODEL"], device="cpu")
    tm.load_state_dict(state_dict_from_npz(ASSET), strict=True)

    rng = np.random.default_rng(3)
    scale = np.array([2.5, 1.2, 0.8], np.float32)
    search = (rng.standard_normal((2, 1024, 3)) * scale).astype(np.float32)
    template = (rng.standard_normal((2, 512, 3)) * scale * 0.5).astype(np.float32)
    search[:, 700:] = search[:, :324]
    template[:, 400:] = template[:, :112]

    jo = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
        {"params": params, "batch_stats": batch_stats},
        {"search_points": jnp.asarray(search), "template_points": jnp.asarray(template)})
    with torch.no_grad():
        to = tm({"search_points": torch.from_numpy(search), "template_points": torch.from_numpy(template)})
    for key in ("search_inds", "template_inds"):
        np.testing.assert_array_equal(to[key].numpy(), _np(jo[key]))
    _close(to["pred_box_data"], jo["pred_box_data"], tol=2e-3)
    np.testing.assert_array_equal(to["pred_box_data"][..., 4].argmax(1).numpy(),
                                  _np(jo["pred_box_data"])[..., 4].argmax(1))
