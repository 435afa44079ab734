"""PointNet++ Siamese backbone (the JAX package's ``nn/backbone.py``): three SA
stages shared by the search branch (1024 -> 512/256/128 points) and the
template branch (512 -> 256/128/64), then a pointwise projection. ``inds``
compose the per-stage sample indices back to the raw input order.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops import fps, point_ops
from .layers import Linear
from .sa_module import PointnetSAModule


class PointNet2BackboneLight(nn.Module):
    def __init__(self, model_cfg: dict, input_channels: int = 3):
        super().__init__()
        self.model_cfg = model_cfg
        sa_cfg = model_cfg["SA_CONFIG"]
        feat_channels = input_channels - 3
        stages = []
        for k in range(len(sa_cfg["RADIUS"])):
            mlps = list(sa_cfg["MLPS"][k])
            if k == 0:
                mlps[0] = feat_channels
            stages.append(
                PointnetSAModule(
                    mlp_channels=mlps,
                    radius=float(sa_cfg["RADIUS"][k]),
                    nsample=int(sa_cfg["NSAMPLE"][k]),
                    use_xyz=bool(sa_cfg.get("USE_XYZ", True)),
                    normalize_xyz=bool(sa_cfg.get("NORMALIZE_XYZ", True)),
                    sample_method=sa_cfg["SAMPLE_METHOD"][k],
                )
            )
        self.sa_stages = nn.ModuleList(stages)
        c_last = sa_cfg["MLPS"][-1][-1]
        self.cov_final = Linear(c_last, 256)
        self.use_kernels = True

    def _branch(self, points, npoints, inds0=None):
        xyz = points[..., 0:3].contiguous()
        features = points[..., 3:] if points.shape[-1] > 3 else None
        inds_list = []
        for k, (stage, npoint) in enumerate(zip(self.sa_stages, npoints)):
            xyz, features, inds = stage(xyz, features, npoint=int(npoint),
                                        inds=inds0 if k == 0 else None)
            inds_list.append(inds)
        point_features = self.cov_final(features)
        inds = inds_list[0].long()
        for nxt in inds_list[1:]:
            inds = torch.gather(inds, 1, nxt.long())
        return xyz, point_features, inds.int()

    def forward(self, batch: dict) -> dict:
        sa_cfg = self.model_cfg["SA_CONFIG"]
        out = dict(batch)
        # both branches' stage-0 FPS in one launch: the template's rounds ride
        # along with the search's
        inds0_s = inds0_t = None
        if sa_cfg["SAMPLE_METHOD"][0] == "fps":
            sample = fps.furthest_point_sample if self.use_kernels else point_ops.furthest_point_sample
            inds0_s, inds0_t = fps.furthest_point_sample_pair(
                batch["search_points"][..., 0:3].float().contiguous(), int(sa_cfg["NPOINTS_SEARCH"][0]),
                batch["template_points"][..., 0:3].float().contiguous(), int(sa_cfg["NPOINTS_TEMPLATE"][0]),
                sample=sample,
            )
        out["search_seeds"], out["search_feats"], out["search_inds"] = self._branch(
            batch["search_points"], sa_cfg["NPOINTS_SEARCH"], inds0=inds0_s)
        out["template_seeds"], out["template_feats"], out["template_inds"] = self._branch(
            batch["template_points"], sa_cfg["NPOINTS_TEMPLATE"], inds0=inds0_t)
        out.pop("search_points")
        out.pop("template_points")
        return out
