"""The YAML configurations of ``tools/cfgs/`` as plain dicts (no YAML parser is
needed where the port runs), and the command-line overrides.

``PTT_CFG`` is the whole of ``tools/cfgs/kitti_models/ptt.yaml``. Every other
file of ``tools/cfgs/`` is derived from its ``_BASE_CONFIG_`` the way the JAX
package's loader derives it, by a recursive override (``merged``), and
``config_by_path`` returns any of them by its path. The tests hold each equal
to the YAML as the JAX package's loader reads it (which keeps ``EPS: 1e-06`` as
the string '1e-06'; here it is the float).

``cfg_from_list`` applies ``--set KEY.PATH VALUE`` overrides with the JAX
package's coercion rules (``ptt_tpu/config.py``): a scalar is parsed as a Python
literal and must keep its type, a list takes "3,4,5" or a literal tuple cast to
its element type, and a sub-dict merges "k1:v1,k2:v2" with each value cast to
its key's type.
"""

from __future__ import annotations

import copy
from ast import literal_eval
from pathlib import Path

_TRANSFORMER_BLOCK = {
    "ENABLE": True,
    "NAME": "TransformerBlock",
    "DIM_INPUT": 256,
    "DIM_MODEL": 512,
    "KNN": 16,
    "N_HEADS": 1,
    "N_LAYERS": 1,
}

PTT_CFG = {
    "CLASS_NAMES": "Car",
    "DATA_CONFIG": {
        "DATASET": "KittiTrackingDataset",
        "DATA_PATH": "../data/kitti",
        "DEBUG": False,
        "REF_COOR": "lidar",
        "USE_Z_AXIS": True,
        "LOAD_FROM_DATABASE": True,
        "LIDAR_CROP_OFFSET": 10.0,
        "NUM_CANDIDATES_PERFRAME": 4,
        "SEARCH_INPUT_SIZE": 1024,
        "TEMPLATE_INPUT_SIZE": 512,
        "SEARCH_BB_OFFSET": 0.0,
        "SEARCH_BB_SCALE": 1.25,
        "MODEL_BB_OFFSET": 0.0,
        "MODEL_BB_SCALE": 1.25,
        "REFINE_BOX_SIZE": True,
        "POINT_CLOUD_RANGE": [-1, -1, -1],
        "DATA_SPLIT": {"train": "train", "test": "test"},
        "SAMPLED_INTERVAL": 1,
        "INFO_PATH": {"train": "kitti_infos_train.pkl", "test": "kitti_infos_test.pkl"},
        "FOV_POINTS_ONLY": False,
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z"],
            "src_feature_list": ["x", "y", "z", "intensity"],
        },
    },
    "MODEL": {
        "NAME": "PTT",
        "BACKBONE_3D": {
            "NAME": "PointNet2BackboneLight",
            "DEBUG": False,
            "SA_CONFIG": {
                "SAMPLE_METHOD": ["fps", "sequence", "sequence"],
                "USE_XYZ": True,
                "NORMALIZE_XYZ": True,
                "NPOINTS_SEARCH": [512, 256, 128],
                "NPOINTS_TEMPLATE": [256, 128, 64],
                "RADIUS": [0.3, 0.5, 0.7],
                "NSAMPLE": [32, 32, 32],
                "MLPS": [[0, 64, 64, 128], [128, 128, 128, 256], [256, 128, 128, 256]],
            },
        },
        "SIMILARITY_MODULE": {
            "NAME": "CosineSimAug",
            "DEBUG": False,
            "MLP": {"CHANNELS": [260, 256, 256, 256], "BN": True},
            "CONV": {"CHANNELS": [256, 256, 256], "BN": True},
        },
        "CENTROID_HEAD": {
            "NAME": "CentroidVotingHead",
            "DEBUG": False,
            "CLS_USE_SEARCH_XYZ": False,
            "CLS_FC": {"CHANNELS": [256, 256, 256, 1]},
            "REG_FC": {"CHANNELS": [259, 256, 256, 259]},
            "TRANSFORMER_BLOCK": dict(_TRANSFORMER_BLOCK),
            "LOSS_CONFIG": {
                "CLS_LOSS": "BinaryCrossEntropy",
                "CLS_LOSS_REDUCTION": "mean",
                "CLS_LOSS_POS_WEIGHT": 1.0,
                "REG_LOSS": "smooth-l1",
                "LOSS_WEIGHTS": {"centroids_cls_weight": 0.2, "centroids_reg_weight": 1.0},
            },
        },
        "BOX_HEAD": {
            "NAME": "BoxVotingHead",
            "DEBUG": False,
            "FC": [256, 256, 256, 5],
            "SA_CONFIG": {
                "NPOINTS": 64,
                "RADIUS": 0.3,
                "NSAMPLE": 16,
                "MLPS": [257, 256, 256, 256],
                "USE_XYZ": True,
                "NORMALIZE_XYZ": True,
                "SAMPLE_METHOD": "fps",
            },
            "TRANSFORMER_BLOCK": dict(_TRANSFORMER_BLOCK),
            "LOSS_CONFIG": {
                "CLS_LOSS": "BinaryCrossEntropy",
                "CLS_LOSS_REDUCTION": "none",
                "CLS_LOSS_POS_WEIGHT": 2.0,
                "REG_LOSS": "smooth-l1",
                "LOSS_WEIGHTS": {"boxes_cls_weight": 1.5, "boxes_reg_weight": 0.2},
            },
        },
    },
    "OPTIMIZATION": {
        "DEBUG": False,
        "BATCH_SIZE_PER_GPU": 48,
        "NUM_EPOCHS": 60,
        "OPTIMIZER": "adam",
        "LR": 0.001,
        "WEIGHT_DECAY": 0,
        "BETAS": [0.5, 0.999],
        "EPS": 1e-06,
        "SCHEDULER": "step",
        "STEP_SIZE": 12,
        "GAMMA": 0.2,
        "GRAD_NORM_CLIP": 10,
        "STEPS_PER_DISPATCH": 1,
    },
    "TRAIN": {"WITH_EVAL": {"ENABLE": False, "START_EPOCH": 3, "INTERVAL": 1}},
    "TEST": {
        "VISUALIZE": False,
        "SAVE_PCD": False,
        "SHAPE_AGGREGATION": "firstandprevious",
        "REF_BOX": "previous_result",
    },
}


def merged(base: dict, override: dict) -> dict:
    """A fresh dict: ``base`` with ``override`` merged in recursively (a dict
    value merges into the dict it replaces, any other value replaces it), the
    rule of the JAX package's ``_BASE_CONFIG_`` inheritance."""
    out = copy.deepcopy(base)
    for key, value in override.items():
        if isinstance(value, dict) and isinstance(out.get(key), dict):
            out[key] = merged(out[key], value)
        else:
            out[key] = copy.deepcopy(value)
    return out


_MUL_TRANSFORMER_BLOCK = dict(_TRANSFORMER_BLOCK, NAME="MulTransformerBlock", N_HEADS=4, N_LAYERS=2)
_POINT_SHARDING = {"POINT_SHARDING": {"ENABLED": True, "AXIS": "point"}}
# the P2B graph: both transformers off and 'sequence' sampling at every backbone stage
_P2B_MODEL = {
    "BACKBONE_3D": {"SA_CONFIG": {"SAMPLE_METHOD": ["sequence", "sequence", "sequence"]}},
    "CENTROID_HEAD": {"TRANSFORMER_BLOCK": {"ENABLE": False}},
    "BOX_HEAD": {"TRANSFORMER_BLOCK": {"ENABLE": False}},
}

# each file of tools/cfgs/, by its path there: (its _BASE_CONFIG_, what it overrides)
_FILES = {
    "kitti_models/ptt.yaml": (None, PTT_CFG),
    "kitti_models/ptt_large.yaml": ("kitti_models/ptt.yaml", {
        "DATA_CONFIG": {"SEARCH_INPUT_SIZE": 2048, "TEMPLATE_INPUT_SIZE": 1024},
        "MODEL": {
            "BACKBONE_3D": {"SA_CONFIG": {"NPOINTS_SEARCH": [1024, 512, 256], "NPOINTS_TEMPLATE": [512, 256, 128]}},
            "CENTROID_HEAD": {"TRANSFORMER_BLOCK": _MUL_TRANSFORMER_BLOCK},
            "BOX_HEAD": {"SA_CONFIG": {"NPOINTS": 128}, "TRANSFORMER_BLOCK": _MUL_TRANSFORMER_BLOCK},
        },
    }),
    "kitti_models/p2b.yaml": ("kitti_models/ptt.yaml", {
        "DATA_CONFIG": {"REF_COOR": "camera", "USE_Z_AXIS": False},
        "MODEL": _P2B_MODEL,
        "TRAIN": {"WITH_EVAL": {"START_EPOCH": 10}},
    }),
    "kitti_models/ptt_waymo.yaml": ("kitti_models/ptt_large.yaml", {
        "DATA_CONFIG": {"SEARCH_INPUT_SIZE": 8192, "TEMPLATE_INPUT_SIZE": 2048},
        "MODEL": dict(_POINT_SHARDING, **{
            "BACKBONE_3D": {"SA_CONFIG": {"NPOINTS_SEARCH": [2048, 1024, 256], "NPOINTS_TEMPLATE": [1024, 512, 128]}},
            "BOX_HEAD": {"SA_CONFIG": {"NPOINTS": 128}},
        }),
    }),
    "nuscenes_models/ptt.yaml": ("kitti_models/ptt.yaml", {
        "CLASS_NAMES": "trailer",
        "DATA_CONFIG": {
            "DATASET": "NuscenesTrackingDataset",
            "DATA_PATH": "../data/nuScenes",
            "VERSION": "v1.0-trainval",
            "KEY_FRAME_ONLY": False,
            "INIT_POINTS_THRESHOLD": 1,
            "USE_RUNNING_MEMORY": True,
            "DATA_SPLIT": {"train": "train_track", "test": "val"},
            "INFO_PATH": {"train": "nuScenes_infos_train.dat", "test": "nuScenes_infos_test.dat"},
        },
        "OPTIMIZATION": {"NUM_EPOCHS": 40},
        "TRAIN": {"WITH_EVAL": {"START_EPOCH": 5}},
    }),
    "synthetic_models/ptt_synth.yaml": ("kitti_models/ptt.yaml", {
        "CLASS_NAMES": "Car",
        "DATA_CONFIG": {"DATASET": "SyntheticTrackingDataset", "NUM_TRACKLETS": 64, "FRAMES_PER_TRACKLET": 24,
                        "POINTS_PER_FRAME": 600, "CLUTTER_POINTS": 400, "SYNTH_SEED": 1234},
        "OPTIMIZATION": {"NUM_EPOCHS": 30, "STEP_SIZE": 12},
        "TRAIN": {"WITH_EVAL": {"ENABLE": True, "START_EPOCH": 0, "INTERVAL": 5}},
    }),
    "synthetic_models/ptt_synth_aug.yaml": ("synthetic_models/ptt_synth.yaml", {
        "DATA_CONFIG": {"DATA_AUGMENTOR": {"AUG_CONFIG_LIST": [
            {"NAME": "random_world_flip", "ALONG_AXIS_LIST": ["x", "y"]},
            {"NAME": "random_world_rotation", "WORLD_ROT_ANGLE": 0.1745},
            {"NAME": "random_world_scaling", "WORLD_SCALE_RANGE": [0.95, 1.05]},
        ]}},
        "OPTIMIZATION": {"NUM_EPOCHS": 40},
    }),
    "synthetic_models/ptt_synth_ps.yaml": ("synthetic_models/ptt_synth.yaml", {"MODEL": _POINT_SHARDING}),
    "synthetic_models/ptt_synth_strong.yaml": ("synthetic_models/ptt_synth.yaml", {
        "DATA_CONFIG": {"NUM_TRACKLETS": 128},
        "OPTIMIZATION": {"NUM_EPOCHS": 60, "STEP_SIZE": 24},
        "TRAIN": {"WITH_EVAL": {"ENABLE": True, "START_EPOCH": 30, "INTERVAL": 10}},
    }),
    "synthetic_models/p2b_synth.yaml": ("synthetic_models/ptt_synth.yaml", {
        "MODEL": dict(_P2B_MODEL, NAME="P2B"),
        "OPTIMIZATION": {"NUM_EPOCHS": 15},
    }),
    "synthetic_models/p2b_synth_strong.yaml": ("synthetic_models/p2b_synth.yaml", {
        "DATA_CONFIG": {"NUM_TRACKLETS": 128},
        "OPTIMIZATION": {"NUM_EPOCHS": 60, "STEP_SIZE": 24, "MIXED_PRECISION": True},
    }),
}

KNOWN_CONFIGS = tuple(f"tools/cfgs/{name}" for name in _FILES)


def _relative(path) -> str:
    """A config path -> its path under ``tools/cfgs/`` (the part after the last
    ``cfgs`` directory, or the path itself when it names none)."""
    parts = Path(path).parts
    if "cfgs" in parts:
        parts = parts[len(parts) - parts[::-1].index("cfgs"):]
    return "/".join(parts)


def config_by_path(path) -> dict:
    """The configuration of the YAML file at ``path`` (``tools/cfgs/...``, from
    any directory), as a fresh dict the caller may edit. Raises KeyError naming
    the known files for any other path."""
    name = _relative(path)
    if name not in _FILES:
        raise KeyError(f"no configuration {str(path)!r}; the port knows {', '.join(KNOWN_CONFIGS)}")
    base, override = _FILES[name]
    return merged(config_by_path(base), override) if base else copy.deepcopy(override)


def cli_config(cfg_file, set_cfgs=None) -> dict:
    """What the CLIs run: ``config_by_path(cfg_file)`` with ``TAG`` (the file's
    stem) and ``EXP_GROUP_PATH`` (its directory under ``tools/cfgs/``), then the
    ``--set`` overrides."""
    cfg = config_by_path(cfg_file)
    rel = Path(_relative(cfg_file))
    cfg["TAG"] = rel.stem
    cfg["EXP_GROUP_PATH"] = rel.parent.as_posix() if rel.parent != Path(".") else ""
    if set_cfgs:
        cfg_from_list(set_cfgs, cfg)
    return cfg


def ptt_config() -> dict:
    """``kitti_models/ptt.yaml``."""
    return config_by_path("kitti_models/ptt.yaml")


def ptt_synth_config() -> dict:
    """``synthetic_models/ptt_synth.yaml``: ptt.yaml trained on the synthetic
    tracklets (Adam betas (0.5, 0.999), eps 1e-6, StepLR 12 epochs x 0.2,
    clip 10, batch 48, 30 epochs)."""
    return config_by_path("synthetic_models/ptt_synth.yaml")


def ptt_large_config() -> dict:
    """``kitti_models/ptt_large.yaml``."""
    return config_by_path("kitti_models/ptt_large.yaml")


def p2b_config() -> dict:
    """``kitti_models/p2b.yaml`` (KITTI): camera-frame boxes, no z offset, the P2B model."""
    return config_by_path("kitti_models/p2b.yaml")


def p2b_synth_config() -> dict:
    """``synthetic_models/p2b_synth.yaml``: ptt_synth.yaml with MODEL.NAME P2B,
    the P2B model and 15 epochs."""
    return config_by_path("synthetic_models/p2b_synth.yaml")


def check_ported(cfg: dict, training: bool, devices: int = 1, sync_bn: bool = False) -> None:
    """Raises NotImplementedError, naming the ROADMAP.md item, for what the port
    does not run: what needs more than one GPU (POINT_SHARDING over ``devices``
    > 1, ``--sync_bn``), and clouds beyond the kernels' largest forms. The CLIs
    call it before they build a loader; they run on one device, where
    POINT_SHARDING splits nothing, as in the JAX package."""
    from .ops.fps import MAX_POINTS
    from .ops.group import BACKWARD_MAX_POINTS

    todo = []
    if cfg["MODEL"].get("POINT_SHARDING", {}).get("ENABLED", False) and devices > 1:
        todo.append(f"MODEL.POINT_SHARDING over {devices} devices (Queue 1 item 10)")
    if sync_bn:
        todo.append("--sync_bn: multi-GPU training (Queue 1 item 9)")
    n = int(cfg["DATA_CONFIG"]["SEARCH_INPUT_SIZE"])
    if cfg["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["SAMPLE_METHOD"][0] in ("fps", "ffps") and n > MAX_POINTS:
        todo.append(f"FPS over {n} points, the FPS kernel takes at most {MAX_POINTS}")
    if training and n > BACKWARD_MAX_POINTS:
        todo.append(f"training on {n}-point clouds, the group backward takes at most {BACKWARD_MAX_POINTS}")
    if todo:
        raise NotImplementedError("not ported (ROADMAP.md): " + "; ".join(todo))


def point_sharding_note(cfg: dict):
    """The log line of a configuration with POINT_SHARDING run on one device,
    or None."""
    ps = cfg["MODEL"].get("POINT_SHARDING", {})
    if ps.get("ENABLED", False):
        return (f"POINT_SHARDING: one device, so the point axis '{ps.get('AXIS', 'point')}' is not split "
                "(the JAX package installs a point mesh only over several local devices)")
    return None


def log_config_to_file(config: dict, pre: str = "cfg", logger=None) -> None:
    """Log every key of ``config``, one line each, sections by their dotted path."""
    for key, val in config.items():
        if isinstance(val, dict):
            logger.info("\n%s.%s = dict()" % (pre, key))
            log_config_to_file(val, pre=pre + "." + key, logger=logger)
            continue
        logger.info("%s.%s: %s" % (pre, key, val))


def _walk_to_parent(config: dict, dotted_key: str):
    """The dict that holds the last segment of ``A.B.C``, and that segment.
    Every segment must exist already: ``--set`` overrides keys, it adds none."""
    node = config
    *parents, leaf = dotted_key.split(".")
    for seg in parents:
        if seg not in node:
            raise KeyError(f"--set: no such config section {seg!r} in {dotted_key!r}")
        node = node[seg]
    if leaf not in node:
        raise KeyError(f"--set: no such config key {leaf!r} in {dotted_key!r}")
    return node, leaf


def _coerce_override(raw: str, old):
    """The command-line string ``raw`` as a value of ``old``'s shape and type."""
    try:
        value = literal_eval(raw)
    except (ValueError, SyntaxError):
        value = raw  # a bare string
    if type(value) is type(old):
        return value
    if isinstance(old, dict):
        for pair in value.split(","):
            k, _, v = pair.partition(":")
            old[k] = type(old[k])(v)
        return old
    if isinstance(old, list):
        items = list(value) if isinstance(value, tuple) else value.split(",")
        return [type(old[0])(x) for x in items]
    raise TypeError(f"--set: cannot override a {type(old).__name__} with {raw!r} "
                    f"(parsed as {type(value).__name__})")


def cfg_from_list(cfg_list, config: dict) -> dict:
    """Apply ``--set KEY.PATH VALUE ...`` pairs to ``config`` in place."""
    if len(cfg_list) % 2 != 0:
        raise ValueError("--set expects KEY VALUE pairs; got an odd-length list")
    for dotted, raw in zip(cfg_list[::2], cfg_list[1::2]):
        node, leaf = _walk_to_parent(config, dotted)
        node[leaf] = _coerce_override(raw, node[leaf])
    return config
