"""Top-level tracker (the JAX package's ``nn/tracker.py``): the batch dict flows
backbone -> similarity -> centroid head -> box head. ``model.train()`` selects
the training path (batch statistics in every BatchNorm, the grouped-first-linear
kernels in every SA stage), ``model.eval()`` the inference path."""

from __future__ import annotations

from torch import nn

from .. import resolve_device
from .backbone import PointNet2BackboneLight
from .heads import BoxVotingHead, CentroidVotingHead
from .similarity import CosineSimAug


class PTT(nn.Module):
    """batch in:  search_points (B, 1024, 3), template_points (B, 512, 3)
    batch out: seeds/feats/inds per branch, cosine_feats, centroid votes + cls,
               box proposals pred_box_data (B, 64, 5)."""

    def __init__(self, model_cfg: dict, input_channels: int = 3):
        super().__init__()
        for key, name in (("BACKBONE_3D", "PointNet2BackboneLight"),
                          ("SIMILARITY_MODULE", "CosineSimAug"),
                          ("CENTROID_HEAD", "CentroidVotingHead"),
                          ("BOX_HEAD", "BoxVotingHead")):
            if model_cfg[key]["NAME"] != name:
                raise NotImplementedError(f"{key}.NAME {model_cfg[key]['NAME']!r} is not ported yet")
        self.backbone_3d = PointNet2BackboneLight(model_cfg["BACKBONE_3D"], input_channels)
        self.similarity_module = CosineSimAug(model_cfg["SIMILARITY_MODULE"])
        self.centroid_voting_head = CentroidVotingHead(model_cfg["CENTROID_HEAD"])
        self.box_voting_head = BoxVotingHead(model_cfg["BOX_HEAD"])

    def forward(self, batch: dict) -> dict:
        out = self.backbone_3d(batch)
        out = self.similarity_module(out)
        out = self.centroid_voting_head(out)
        return self.box_voting_head(out)


# P2B is the PTT graph with both transformers off and 'sequence' sampling: a
# difference of configuration only, as in the JAX package
ALL_TRACKERS = {"PTT": PTT, "P2B": PTT}


def build_network(model_cfg: dict, input_channels: int = 3, device="cuda", train: bool = False) -> PTT:
    """The tracker of ``model_cfg`` (MODEL section) on ``device`` (CUDA unless
    the caller asks for the CPU), in eval mode unless ``train``."""
    if model_cfg["NAME"] not in ALL_TRACKERS:
        raise NotImplementedError(f"MODEL.NAME {model_cfg['NAME']!r} is not ported yet")
    return ALL_TRACKERS[model_cfg["NAME"]](model_cfg, input_channels).train(train).to(resolve_device(device))


def set_use_kernels(model: nn.Module, use_kernels: bool) -> None:
    """Route every FPS, SA and grouped-first-linear call of ``model`` through
    the CUDA kernels (True, the default) or through their plain PyTorch
    versions (False)."""
    for m in model.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = use_kernels
