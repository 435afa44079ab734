"""Weight bridge between the JAX package's variables and this package's
``state_dict``, both ways.

The JAX package stores a model as a flat numpy dict (``train/checkpoint.py``
``save_variables_npz``; ``tests/assets/ptt_synth_trained.npz``), keyed by flax
module paths such as ``params/backbone_3d/sa_stages_0/SharedMLP_0/Dense_0/kernel``
and ``batch_stats/.../BatchNorm_0/mean``. ``state_dict_from_npz`` opens such a
file with ``np.load`` alone and returns tensors under this package's module
names, ready for ``load_state_dict(strict=True)``.

Flax ``Dense`` kernels are (in, out) and are transposed to ``nn.Linear``'s
(out, in); BatchNorm ``scale``/``bias``/``mean``/``var`` become
``weight``/``bias``/``running_mean``/``running_var`` (plus a zero
``num_batches_tracked``), LayerNorm ``scale``/``bias`` ``weight``/``bias``;
``__meta__/*`` entries are metadata, not weights. The transformer keys are
those of the JAX package's ``utils/torch_converter.py`` ``export_state_dict``
(``transformer_block.layers.0.fc_gamma.0.weight``, ``...norm1.weight``); the
two sub-paths it has no mapping for, ``fc_sim`` and ``fc3``, keep their flax
names.
``variables_from_state_dict`` is the reverse: a ``state_dict`` -> the flat
``params/...`` and ``batch_stats/...`` dict of numpy arrays of such a file.

The reference PyTorch code names its modules otherwise
(``backbone_3d.SA_modules.0.mlp_module.layer0.conv.weight``, 1x1 convolutions
with trailing unit dimensions), as the JAX package's
``utils/torch_converter.py`` writes them. ``reference_state_dict`` and
``state_dict_from_reference`` translate between the two layouts.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# flax module path -> torch module path, applied in order to "/"-joined paths
_RENAMES = (
    (r"sa_stages_(\d+)", r"sa_stages/\1"),
    (r"(^|/)SharedMLP_0", r"\1mlp"),
    (r"similarity_module/ConvStack_0", r"similarity_module/conv"),
    (r"centroid_voting_head/ConvStack_0", r"centroid_voting_head/cls_fc"),
    (r"centroid_voting_head/ConvStack_1", r"centroid_voting_head/reg_fc"),
    (r"box_voting_head/ConvStack_0", r"box_voting_head/fc"),
    # MulTransformerBlock's stack
    (r"(^|/)layer_(\d+)/", r"\1layers/\2/"),
    # MLP2 = Linear -> ReLU -> Linear: nn.Sequential indices 0 and 2
    # (TransformerBlockMLP's fc1 and fc2 are MLP2s too)
    (r"(fc_delta|fc_gamma|fc1|fc2)/Linear_0/Dense_0", r"\1/0"),
    (r"(fc_delta|fc_gamma|fc1|fc2)/Linear_1/Dense_0", r"\1/2"),
    # transformer Linear wrappers hold one Dense
    (r"(fc1|fc2|fc3|fc_sim|proj|w_qs|w_ks|w_vs)/Dense_0", r"\1"),
    (r"(^|/)Dense_(\d+)$", r"\1linears/\2"),
    (r"(^|/)BatchNorm_(\d+)$", r"\1bns/\2"),
)

# torch module path -> flax module path, the reverse of _RENAMES
_RENAMES_BACK = (
    (r"(^|/)linears/(\d+)$", r"\1Dense_\2"),
    (r"(^|/)bns/(\d+)$", r"\1BatchNorm_\2"),
    (r"(fc_delta|fc_gamma|fc1|fc2)/0$", r"\1/Linear_0/Dense_0"),
    (r"(fc_delta|fc_gamma|fc1|fc2)/2$", r"\1/Linear_1/Dense_0"),
    (r"(^|/)(fc1|fc2|fc3|fc_sim|proj|w_qs|w_ks|w_vs)$", r"\1\2/Dense_0"),
    (r"(^|/)layers/(\d+)/", r"\1layer_\2/"),
    (r"box_voting_head/fc/", r"box_voting_head/ConvStack_0/"),
    (r"centroid_voting_head/reg_fc/", r"centroid_voting_head/ConvStack_1/"),
    (r"centroid_voting_head/cls_fc/", r"centroid_voting_head/ConvStack_0/"),
    (r"similarity_module/conv/", r"similarity_module/ConvStack_0/"),
    (r"(^|/)mlp/", r"\1SharedMLP_0/"),
    (r"sa_stages/(\d+)", r"sa_stages_\1"),
)

_LEAVES = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def _flatten(tree: Mapping, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _rename(module: str) -> str:
    for pattern, repl in _RENAMES:
        module = re.sub(pattern, repl, module)
    return module


def torch_key(flax_key: str) -> str:
    """``params/<module path>/<leaf>`` -> the torch state_dict key."""
    collection, *path, leaf = flax_key.split("/")
    module = _rename("/".join(path))
    try:
        name = _LEAVES[(collection, leaf)]
    except KeyError:
        raise KeyError(f"no torch counterpart for {flax_key!r}") from None
    return module.replace("/", ".") + "." + name


def state_dict_from_variables(variables: Mapping, prefix: str = "") -> dict:
    """Flax variables, nested ({"params": ..., "batch_stats": ...}) or flat
    ("params/..." keys), -> torch state_dict of float32 tensors. ``prefix`` is
    the flax path of a submodule's variables within the whole tracker (e.g.
    ``centroid_voting_head/transformer_block``); the keys are then those of the
    matching torch submodule."""
    flat = _flatten(variables)
    tprefix = _rename(prefix).replace("/", ".") + "." if prefix else ""
    state = {}
    for key, value in flat.items():
        if key.startswith("__meta__/"):
            continue
        if prefix:
            collection, rest = key.split("/", 1)
            key = f"{collection}/{prefix}/{rest}"
        arr = np.asarray(value, dtype=np.float32)
        if key.endswith("/kernel"):
            arr = arr.T
        tkey = torch_key(key)[len(tprefix):]
        state[tkey] = torch.tensor(arr)
        if tkey.endswith(".running_mean"):
            state[tkey[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def _flax_key(torch_key_: str) -> str | None:
    """A torch state_dict key -> its ``params/...`` or ``batch_stats/...`` key;
    None for ``num_batches_tracked``, which flax does not keep."""
    module, name = torch_key_.rsplit(".", 1)
    if name == "num_batches_tracked":
        return None
    path = module.replace(".", "/")
    for pattern, repl in _RENAMES_BACK:
        path = re.sub(pattern, repl, path)
    # BatchNorm and LayerNorm weights are flax "scale"s, Linear weights "kernel"s
    is_norm = re.search(r"(^|/)(BatchNorm_\d+|norm\d)$", path) is not None
    leaf = {("weight", True): ("params", "scale"), ("bias", True): ("params", "bias"),
            ("running_mean", True): ("batch_stats", "mean"), ("running_var", True): ("batch_stats", "var"),
            ("weight", False): ("params", "kernel"), ("bias", False): ("params", "bias")}.get((name, is_norm))
    if leaf is None:
        raise KeyError(f"no flax counterpart for {torch_key_!r}")
    return f"{leaf[0]}/{path}/{leaf[1]}"


def variables_from_state_dict(state_dict: Mapping) -> dict:
    """A torch state_dict -> the flat dict of float32 numpy arrays that
    ``train/checkpoint.py`` ``save_variables_npz`` of the JAX package writes
    (Linear weights transposed back to (in, out) kernels)."""
    out = {}
    for key, value in state_dict.items():
        fkey = _flax_key(key)
        if fkey is None:
            continue
        arr = value.detach().cpu().numpy().astype(np.float32)
        out[fkey] = arr.T if fkey.endswith("/kernel") else arr
    return out


def state_dict_from_npz(path) -> dict:
    """The torch state_dict of a JAX-package ``.npz`` variables file."""
    with np.load(path, allow_pickle=False) as data:
        return state_dict_from_variables({k: data[k] for k in data.files})


def npz_metadata(path) -> dict:
    """The ``__meta__/*`` entries of a JAX-package ``.npz`` file, as Python scalars."""
    with np.load(path, allow_pickle=False) as data:
        return {k.split("/", 1)[1]: data[k][()].item() for k in data.files if k.startswith("__meta__/")}


# the reference's sequential names of the flax ConvStack_k of each top-level module
_CONVSTACK_NAMES = {
    "similarity_module": ["conv"],
    "centroid_voting_head": ["cla_layer", "vote_layer"],
    "box_voting_head": ["refine_layer"],
}
# tensors of a reference state_dict that are not weights of the tracker
IGNORED_REFERENCE_SUFFIXES = ("num_batches_tracked", "cls_loss_func.pos_weight", "global_step")


def _reference_bn_leaf(collection: str, leaf: str) -> str:
    if collection == "batch_stats":
        return {"mean": "running_mean", "var": "running_var"}[leaf]
    return {"scale": "weight", "bias": "bias"}[leaf]


def _reference_key_of_flax(collection: str, segs: list) -> str:
    """A flax variable path -> the reference state_dict key (the JAX package's
    ``torch_converter._flax_to_torch_key``)."""
    top = segs[0]
    out = [top]
    i = 1
    while i < len(segs):
        seg = segs[i]
        if seg.startswith("sa_stages_"):
            out.append(f"SA_modules.{seg.split('_')[-1]}")
        elif seg.startswith("SharedMLP"):
            out.append("mlp" if top == "similarity_module" else "mlp_module")
            sub, leaf = segs[i + 1], segs[i + 2]
            j = sub.split("_")[-1]
            out.append(f"layer{j}.conv.{'weight' if leaf == 'kernel' else 'bias'}" if sub.startswith("Dense")
                       else f"layer{j}.normlayer.bn.{_reference_bn_leaf(collection, leaf)}")
            return ".".join(out)
        elif seg.startswith("ConvStack"):
            out.append(_CONVSTACK_NAMES[top][int(seg.split("_")[-1])])
            sub, leaf = segs[i + 1], segs[i + 2]
            j = sub.split("_")[-1]
            out.append(f"{j}.conv.{'weight' if leaf == 'kernel' else 'bias'}" if sub.startswith("Dense")
                       else f"{j}.normlayer.bn.{_reference_bn_leaf(collection, leaf)}")
            return ".".join(out)
        elif seg == "transformer_block":
            out.append(seg)
            rest = segs[i + 1:]
            if rest[0].startswith("layer_"):
                out.append(f"layers.{rest[0].split('_')[-1]}")
                rest = rest[1:]
            name = "weight" if rest[-1] in ("kernel", "scale") else "bias"
            if rest[0] in ("fc1", "fc2", "proj") or rest[0].startswith("w_") or rest[0] in ("norm1", "norm2"):
                out.append(f"{rest[0]}.{name}")
            elif rest[0] in ("fc_delta", "fc_gamma"):
                out.append(f"{rest[0]}.{2 * int(rest[1].split('_')[-1])}.{name}")
            else:
                raise KeyError(f"the reference layout has no name for transformer sub-path {rest}")
            return ".".join(out)
        elif seg == "cov_final":
            out.append(f"cov_final.{'weight' if segs[i + 1] == 'kernel' else 'bias'}")
            return ".".join(out)
        else:
            out.append(seg)
        i += 1
    raise KeyError(f"unmapped flax path {collection}:{'/'.join(segs)}")


def reference_key(key: str) -> str | None:
    """The reference state_dict key of this package's ``key``; None for
    ``num_batches_tracked``. Sub-paths the reference layout has no name for
    (``fc_sim``, ``fc3``) keep this package's key."""
    fkey = _flax_key(key)
    if fkey is None:
        return None
    collection, *segs = fkey.split("/")
    try:
        return _reference_key_of_flax(collection, segs)
    except KeyError:
        return key


def _reference_conv_rank(ref_key: str) -> int:
    """Spatial rank of the reference's 1x1 convolution a weight belongs to:
    2 for the SharedMLP layers (Conv2d), 1 for the conv1d stacks and cov_final,
    0 for anything else."""
    if ".conv.weight" in ref_key:
        return 2 if (".mlp." in ref_key or ".mlp_module." in ref_key) else 1
    return 1 if ref_key.endswith("cov_final.weight") else 0


def reference_state_dict(state_dict: Mapping) -> dict:
    """This package's state_dict -> the reference layout, as the JAX package's
    ``export_state_dict`` writes it (no ``num_batches_tracked``)."""
    out = {}
    for key, value in state_dict.items():
        rkey = reference_key(key)
        if rkey is not None:
            t = value.detach().cpu()
            out[rkey] = t.reshape(tuple(t.shape) + (1,) * _reference_conv_rank(rkey)).clone()
    return out


def state_dict_from_reference(ref_state: Mapping, template: Mapping):
    """A reference-layout state_dict -> this package's keys and shapes, for the
    tracker whose state_dict is ``template``. Returns (state, problems): state
    holds every template key found with the same shape once the reference's
    trailing unit dimensions are dropped; problems lists, one line each, the
    template keys missing or of another shape and the reference tensors left
    over (those of IGNORED_REFERENCE_SUFFIXES aside). ``num_batches_tracked``
    is taken from the template."""
    state, problems, used = {}, [], set()
    for key, tmpl in template.items():
        rkey = reference_key(key)
        if rkey is None:
            state[key] = tmpl.clone()
            continue
        if rkey not in ref_state:
            problems.append(f"missing: {key} (reference {rkey})")
            continue
        used.add(rkey)
        src = torch.as_tensor(ref_state[rkey])
        shape = tuple(src.shape)
        while len(shape) > tmpl.dim() and shape[-1] == 1:
            shape = shape[:-1]
        if shape != tuple(tmpl.shape):
            problems.append(f"shape: {key} {tuple(tmpl.shape)} vs reference {rkey} {tuple(src.shape)}")
            continue
        state[key] = src.reshape(shape).to(tmpl.dtype)
    problems += [f"unused: {k}" for k in ref_state if k not in used and not k.endswith(IGNORED_REFERENCE_SUFFIXES)]
    return state, problems
