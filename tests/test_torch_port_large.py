"""The port's ptt_large.yaml and P2B configurations against the JAX package on
the CPU: the 9 transformer variants of ``nn/transformer.py`` at 2e-4 from the
same numpy weights, the configuration dicts against the YAML, the weight
bridge both ways for the new sub-paths, 'ffps' sampling, and whole forwards at
narrowed widths (``pred_box_data`` within 2e-3, the same best proposal)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.nn import sa_module as jsa
from ptt_tpu.nn import transformer as jtr
from ptt_tpu.utils.torch_converter import export_state_dict
from ptt_tpu_torch.config import p2b_config, p2b_synth_config, ptt_large_config
from ptt_tpu_torch.convert import state_dict_from_variables, variables_from_state_dict
from ptt_tpu_torch.nn import build_network, sa_module, transformer

torch.set_num_threads(1)

TOL = 2e-4
PREFIX = "centroid_voting_head/transformer_block"
B, N, D_POINTS, D_MODEL, KNN = 2, 40, 24, 32, 8


def _perturb(variables, rng):
    """Random weights with non-trivial normalisation parameters."""
    def f(path, x):
        noise = rng.standard_normal(x.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(np.abs(np.asarray(x) + 0.3 * noise) + 0.5)
        return x + 0.1 * jnp.asarray(noise)
    return jax.tree_util.tree_map_with_path(f, variables)


def _plain(obj):
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=tol, atol=tol)


# ------------------------------------------------------------ transformer variants


def _variant_inputs(name, rng):
    """(flax args, torch args) of one call of the variant ``name``."""
    xyz = rng.standard_normal((B, N, 3)).astype(np.float32)
    feats = rng.standard_normal((B, N, D_POINTS)).astype(np.float32)
    if name == "TransformerBlockBackbone":  # the centers are the points (N == M)
        idx = rng.integers(0, N, (B, N, KNN)).astype(np.int32)
        grouped = np.stack([xyz[b][idx[b]] for b in range(B)])  # (B, N, KNN, 3)
        args = (xyz, grouped, idx, feats)
    elif name == "CrossAttentionBlock":
        args = (xyz, feats, rng.standard_normal((B, N, D_POINTS)).astype(np.float32))
    else:
        args = (xyz, feats)
    return tuple(jnp.asarray(a) for a in args), tuple(torch.from_numpy(a) for a in args)


def _variant_cfg(name):
    return {"NAME": name, "DIM_INPUT": D_POINTS, "DIM_MODEL": D_MODEL, "KNN": KNN, "N_HEADS": 4, "N_LAYERS": 2}


@pytest.mark.parametrize("name", sorted(jtr.ALL_TRANSFORMERS))
def test_transformer_variant_matches_flax(rng, name):
    """Every registry entry, built by ``build_transformer`` from the same config
    (MulTransformerBlock with 4 heads and 2 layers), on the flax variant's
    perturbed weights carried over by ``convert.py``."""
    assert sorted(transformer.ALL_TRANSFORMERS) == sorted(jtr.ALL_TRANSFORMERS)
    jm = jtr.build_transformer(_variant_cfg(name))
    jargs, targs = _variant_inputs(name, rng)
    v = _perturb(jm.init(jax.random.PRNGKey(0), *jargs), rng)
    tm = transformer.build_transformer(_variant_cfg(name))
    tm.load_state_dict(state_dict_from_variables(jax.device_get(v), prefix=PREFIX), strict=True)
    tm.eval()
    jout = jm.apply(v, *jargs)
    with torch.no_grad():
        tout = tm(*targs)
    if name == "TransformerBlockBackbone":
        _close(tout, jout)
    else:
        _close(tout[0], jout[0])
        _close(tout[1], jout[1])


def test_layer_norm_takes_flax_epsilon():
    layer = transformer.MulHeadTransformerLayer(D_POINTS, D_MODEL, KNN, heads=4)
    assert layer.norm1.eps == layer.norm2.eps == 1e-6
    # one fc_gamma MLP of head_dim, shared by the heads
    assert layer.fc_gamma[0].weight.shape == (D_MODEL // 4, D_MODEL // 4)


def test_mul_transformer_keys_equal_torch_converter(rng):
    """A reference-keyed file (the JAX package's ``export_state_dict``) loads
    into the port's MulTransformerBlock with strict=True and gives the flax
    outputs; ``variables_from_state_dict`` gives back the flax variables."""
    jm = jtr.build_transformer(_variant_cfg("MulTransformerBlock"))
    jargs, targs = _variant_inputs("MulTransformerBlock", rng)
    v = _perturb(jm.init(jax.random.PRNGKey(0), *jargs), rng)
    ref = export_state_dict({"centroid_voting_head": {"transformer_block": jax.device_get(v["params"])}})
    head = "centroid_voting_head.transformer_block."
    assert all(k.startswith(head) for k in ref)
    tm = transformer.build_transformer(_variant_cfg("MulTransformerBlock"))
    assert set(tm.state_dict()) == {k[len(head):] for k in ref}
    tm.load_state_dict({k[len(head):]: torch.tensor(np.asarray(a)) for k, a in ref.items()}, strict=True)
    with torch.no_grad():
        _close(tm(*targs)[0], jm.apply(v, *jargs)[0])
    back = variables_from_state_dict(tm.state_dict())
    flat = {f"params/{'/'.join(str(p.key) for p in path)}": np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(jax.device_get(v["params"]))[0]}
    assert set(back) == set(flat)
    for k, a in flat.items():
        np.testing.assert_array_equal(back[k], a)


@pytest.mark.parametrize("name", ["TransformerBlockCosine", "CrossAttentionBlock", "TransformerBlockMLP"])
def test_own_keys_round_trip(rng, name):
    """The sub-paths the JAX converter has no mapping for (fc_sim, fc3) and the
    MLP2-shaped fc1/fc2: state_dict -> flax variables -> state_dict, bit for bit,
    with the flax leaves the flax module has."""
    jm = jtr.build_transformer(_variant_cfg(name))
    jargs, _ = _variant_inputs(name, rng)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), *jargs))
    tm = transformer.build_transformer(_variant_cfg(name))
    back = variables_from_state_dict(tm.state_dict())
    flat = {f"params/{'/'.join(str(p.key) for p in path)}": x.shape
            for path, x in jax.tree_util.tree_flatten_with_path(v["params"])[0]}
    assert {k: a.shape for k, a in back.items()} == flat
    again = state_dict_from_variables(back)
    tm.load_state_dict(again, strict=True)
    for k, t in tm.state_dict().items():
        assert torch.equal(t, again[k]), k


# ------------------------------------------------------------------ configurations


@pytest.mark.parametrize("fn, path", [
    (ptt_large_config, "tools/cfgs/kitti_models/ptt_large.yaml"),
    (p2b_config, "tools/cfgs/kitti_models/p2b.yaml"),
    (p2b_synth_config, "tools/cfgs/synthetic_models/p2b_synth.yaml"),
], ids=["ptt_large", "p2b", "p2b_synth"])
def test_config_matches_yaml(fn, path):
    """Each dict equals what the JAX package's loader reads, for every key the
    port holds; a fresh dict shares nothing with the tables it was merged from."""
    cfg = cfg_from_yaml_file(path)
    ours = fn()
    assert ours["MODEL"] == _plain(cfg.MODEL)
    assert ours["TEST"] == _plain(cfg.TEST)
    for section in ("DATA_CONFIG", "OPTIMIZATION", "TRAIN"):
        for key, value in ours.get(section, {}).items():
            ref = _plain(cfg[section][key])
            ref = float(ref) if key == "EPS" else ref  # the YAML loader keeps "1e-06" as a string
            assert _plain(value) == ref, (section, key)
    ours["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] = 9.0
    assert fn()["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] == 0.3


def test_p2b_builds_the_ptt_graph_without_transformers():
    model = build_network(p2b_synth_config()["MODEL"], device="cpu")
    assert model.centroid_voting_head.transformer_block is None
    assert model.box_voting_head.transformer_block is None
    with pytest.raises(NotImplementedError):
        build_network(dict(p2b_synth_config()["MODEL"], NAME="Siamese"), device="cpu")


# -------------------------------------------------------------------------- ffps


@pytest.mark.parametrize("C", [0, 8])
def test_ffps_indices_match_jax(rng, C):
    """FPS in [xyz | features] space, ties to the lowest index (duplicated rows
    make ties), equal to the JAX package's indices."""
    n, m = 96, 32
    xyz = rng.standard_normal((2, n, 3)).astype(np.float32)
    xyz[:, n // 2:] = xyz[:, : n // 2]
    feats = rng.standard_normal((2, n, C)).astype(np.float32) if C else None
    ref = jsa.sample_indices("ffps", jnp.asarray(xyz), None if feats is None else jnp.asarray(feats), m)
    got = sa_module.sample_indices("ffps", torch.from_numpy(xyz), m, features=None if feats is None
                                   else torch.from_numpy(feats))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------------ whole forwards


def _narrowed(path):
    """The YAML's MODEL with narrow backbone and transformer widths; the point
    counts, the samplers, the heads' structure and the 256-wide features stay."""
    cfg = cfg_from_yaml_file(path)
    sa = cfg.MODEL.BACKBONE_3D.SA_CONFIG
    sa.MLPS = [[0, 16, 16, 32], [32, 32, 32, 64], [64, 32, 32, 64]]
    cfg.MODEL.BOX_HEAD.SA_CONFIG.MLPS = [257, 32, 32, 256]
    for head in (cfg.MODEL.CENTROID_HEAD, cfg.MODEL.BOX_HEAD):
        head.TRANSFORMER_BLOCK.DIM_MODEL = 32
    return cfg


@pytest.mark.parametrize("path, search, template", [
    ("tools/cfgs/kitti_models/ptt_large.yaml", 2048, 1024),
    ("tools/cfgs/synthetic_models/p2b_synth.yaml", 1024, 512),
], ids=["ptt_large", "p2b_synth"])
def test_forward_matches_jax(path, search, template):
    """The whole eval forward on the JAX package's perturbed init, converted
    with strict=True: sample indices equal, pred_box_data within 2e-3, the same
    best proposal."""
    cfg = _narrowed(path)
    rng = np.random.default_rng(5)
    scale = np.array([2.5, 1.2, 0.8], np.float32)
    batch = {"search_points": (rng.standard_normal((2, search, 3)) * scale).astype(np.float32),
             "template_points": (rng.standard_normal((2, template, 3)) * scale * 0.5).astype(np.float32)}
    batch["search_points"][:, search - 200:] = batch["search_points"][:, :200]  # resampling repeats points
    jm = jbuild(cfg.MODEL)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    v = _perturb(jax.jit(lambda b: jm.init(jax.random.PRNGKey(0), b, train=False))(jb), rng)
    jo = jax.jit(lambda v, b: jm.apply(v, b, train=False))(v, jb)

    tm = build_network(copy.deepcopy(_plain(cfg.MODEL)), device="cpu")
    tm.load_state_dict(state_dict_from_variables(jax.device_get(v)), strict=True)
    with torch.no_grad():
        to = tm({k: torch.from_numpy(a) for k, a in batch.items()})
    for key in ("search_inds", "template_inds"):
        np.testing.assert_array_equal(to[key].numpy(), np.asarray(jo[key]))
    _close(to["pred_box_data"], jo["pred_box_data"], tol=2e-3)
    np.testing.assert_array_equal(to["pred_box_data"][..., 4].argmax(1).numpy(),
                                  np.asarray(jo["pred_box_data"])[..., 4].argmax(1))
