"""The settings of ``tools/cfgs/kitti_models/ptt.yaml`` and
``tools/cfgs/synthetic_models/ptt_synth.yaml`` that the port runs on, as plain
dicts (no YAML parser is needed where the port runs).

``PTT_CFG`` holds the whole MODEL and TEST sections and the DATA_CONFIG keys the
device tracker reads; ``ptt_synth_config()`` adds the OPTIMIZATION and TRAIN
sections and the DATA_CONFIG keys of synthetic training. The tests hold both
equal to the YAML as the JAX package's loader reads it.
"""

from __future__ import annotations

import copy

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
        "REF_COOR": "lidar",
        "USE_Z_AXIS": True,
        "SEARCH_INPUT_SIZE": 1024,
        "TEMPLATE_INPUT_SIZE": 512,
        "SEARCH_BB_OFFSET": 0.0,
        "SEARCH_BB_SCALE": 1.25,
        "MODEL_BB_OFFSET": 0.0,
        "MODEL_BB_SCALE": 1.25,
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
    "TEST": {
        "VISUALIZE": False,
        "SAVE_PCD": False,
        "SHAPE_AGGREGATION": "firstandprevious",
        "REF_BOX": "previous_result",
    },
}


def ptt_config() -> dict:
    """A fresh deep copy of ``PTT_CFG`` that the caller may edit."""
    return copy.deepcopy(PTT_CFG)


# ptt.yaml's OPTIMIZATION with ptt_synth.yaml's NUM_EPOCHS and STEP_SIZE
_SYNTH_OPTIMIZATION = {
    "DEBUG": False,
    "BATCH_SIZE_PER_GPU": 48,
    "NUM_EPOCHS": 30,
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
}

# the DATA_CONFIG keys of ptt.yaml that training reads, and ptt_synth.yaml's own
_SYNTH_DATA_CONFIG = {
    "DATASET": "SyntheticTrackingDataset",
    "NUM_CANDIDATES_PERFRAME": 4,
    "SAMPLED_INTERVAL": 1,
    "REFINE_BOX_SIZE": True,
    "POINT_FEATURE_ENCODING": {
        "encoding_type": "absolute_coordinates_encoding",
        "used_feature_list": ["x", "y", "z"],
        "src_feature_list": ["x", "y", "z", "intensity"],
    },
    "NUM_TRACKLETS": 64,
    "FRAMES_PER_TRACKLET": 24,
    "POINTS_PER_FRAME": 600,
    "CLUTTER_POINTS": 400,
    "SYNTH_SEED": 1234,
}


def ptt_synth_config() -> dict:
    """ptt.yaml trained on the synthetic tracklets (ptt_synth.yaml): a fresh
    dict with MODEL, TEST, OPTIMIZATION (Adam betas (0.5, 0.999), eps 1e-6,
    StepLR 12 epochs x 0.2, clip 10, batch 48), TRAIN and DATA_CONFIG."""
    cfg = ptt_config()
    cfg["DATA_CONFIG"].update(copy.deepcopy(_SYNTH_DATA_CONFIG))
    cfg["OPTIMIZATION"] = copy.deepcopy(_SYNTH_OPTIMIZATION)
    cfg["TRAIN"] = {"WITH_EVAL": {"ENABLE": True, "START_EPOCH": 0, "INTERVAL": 5}}
    return cfg
