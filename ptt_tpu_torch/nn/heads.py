"""VoteNet-style voting heads (the JAX package's ``nn/heads.py``); their losses
are functions of the output dict in ``nn/losses.py``."""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvStack
from .sa_module import PointnetSAModule
from .transformer import build_transformer


class CentroidVotingHead(nn.Module):
    """Adds pred_centroids_cls (B, n), pred_centroids_votes (B, n, 3) and
    votes_feats (B, n, 1 + C) = [sigmoid(cls) | voted features]."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        tb_cfg = model_cfg["TRANSFORMER_BLOCK"]
        self.transformer_block = build_transformer(tb_cfg) if tb_cfg["ENABLE"] else None
        self.cls_use_xyz = bool(model_cfg.get("CLS_USE_SEARCH_XYZ", False))
        self.cls_fc = ConvStack(model_cfg["CLS_FC"]["CHANNELS"])
        self.reg_fc = ConvStack(model_cfg["REG_FC"]["CHANNELS"])

    def forward(self, batch: dict) -> dict:
        out = dict(batch)
        seeds_xyz = batch["search_seeds"]
        fusion_feats = batch["cosine_feats"]
        if self.transformer_block is not None:
            fusion_feats, _ = self.transformer_block(seeds_xyz, fusion_feats)
        if self.cls_use_xyz:
            fusion_feats = torch.cat([seeds_xyz, fusion_feats], dim=-1)
            voting_input = fusion_feats
        else:
            voting_input = torch.cat([seeds_xyz, fusion_feats], dim=-1)
        cls_logits = self.cls_fc(fusion_feats)[..., 0]
        voting_results = voting_input + self.reg_fc(voting_input)  # residual vote

        out["pred_centroids_cls"] = cls_logits
        out["pred_centroids_votes"] = voting_results[..., 0:3].contiguous()
        out["votes_feats"] = torch.cat(
            [torch.sigmoid(cls_logits)[..., None], voting_results[..., 3:]], dim=-1
        )
        return out


class BoxVotingHead(nn.Module):
    """Vote aggregation (one more SA stage over the votes) and proposal
    refinement. Adds pred_box_center (B, np, 3) and pred_box_data (B, np, 5) =
    [cx, cy, cz, theta_deg, score_logit]."""

    def __init__(self, model_cfg: dict):
        super().__init__()
        sa_cfg = model_cfg["SA_CONFIG"]
        self.npoint = int(sa_cfg["NPOINTS"])
        self.vote_aggregation = PointnetSAModule(
            mlp_channels=sa_cfg["MLPS"],
            radius=float(sa_cfg["RADIUS"]),
            nsample=int(sa_cfg["NSAMPLE"]),
            use_xyz=bool(sa_cfg.get("USE_XYZ", True)),
            normalize_xyz=bool(sa_cfg.get("NORMALIZE_XYZ", True)),
            sample_method=sa_cfg["SAMPLE_METHOD"],
        )
        tb_cfg = model_cfg["TRANSFORMER_BLOCK"]
        self.transformer_block = build_transformer(tb_cfg) if tb_cfg["ENABLE"] else None
        self.fc = ConvStack(model_cfg["FC"])

    def forward(self, batch: dict) -> dict:
        out = dict(batch)
        centers, proposal_feats, _ = self.vote_aggregation(
            batch["pred_centroids_votes"], batch["votes_feats"], npoint=self.npoint
        )
        if self.transformer_block is not None:
            proposal_feats, _ = self.transformer_block(centers, proposal_feats)
        offsets = self.fc(proposal_feats)  # (B, np, 5)
        out["pred_box_center"] = centers
        out["pred_box_data"] = torch.cat([offsets[..., 0:3] + centers, offsets[..., 3:]], dim=-1)
        return out
