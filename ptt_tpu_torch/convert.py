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
``num_batches_tracked``); ``__meta__/*`` entries are metadata, not weights.
``variables_from_state_dict`` is the reverse: a ``state_dict`` -> the flat
``params/...`` and ``batch_stats/...`` dict of numpy arrays of such a file.
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
    # MLP2 = Linear -> ReLU -> Linear: nn.Sequential indices 0 and 2
    (r"(fc_delta|fc_gamma)/Linear_0/Dense_0", r"\1/0"),
    (r"(fc_delta|fc_gamma)/Linear_1/Dense_0", r"\1/2"),
    # transformer Linear wrappers hold one Dense
    (r"(fc1|fc2|w_qs|w_ks|w_vs)/Dense_0", r"\1"),
    (r"(^|/)Dense_(\d+)$", r"\1linears/\2"),
    (r"(^|/)BatchNorm_(\d+)$", r"\1bns/\2"),
)

# torch module path -> flax module path, the reverse of _RENAMES
_RENAMES_BACK = (
    (r"(^|/)linears/(\d+)$", r"\1Dense_\2"),
    (r"(^|/)bns/(\d+)$", r"\1BatchNorm_\2"),
    (r"(fc_delta|fc_gamma)/0$", r"\1/Linear_0/Dense_0"),
    (r"(fc_delta|fc_gamma)/2$", r"\1/Linear_1/Dense_0"),
    (r"(^|/)(fc1|fc2|w_qs|w_ks|w_vs)$", r"\1\2/Dense_0"),
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
    is_bn = re.search(r"(^|/)BatchNorm_\d+$", path) is not None
    leaf = {("weight", True): ("params", "scale"), ("bias", True): ("params", "bias"),
            ("running_mean", True): ("batch_stats", "mean"), ("running_var", True): ("batch_stats", "var"),
            ("weight", False): ("params", "kernel"), ("bias", False): ("params", "bias")}.get((name, is_bn))
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
