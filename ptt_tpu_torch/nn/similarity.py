"""P2B cosine-similarity feature augmentation (the JAX package's
``nn/similarity.py``): for every (template seed i, search seed j) pair the
descriptor [cos(f_i, f_j) | template_xyz_i | template_feats_i] goes through a
shared MLP, is max-pooled over the template axis and projected.
"""

from __future__ import annotations

import torch
from torch import nn

from .layers import ConvStack, SharedMLP, matmul


class CosineSimAug(nn.Module):
    def __init__(self, model_cfg: dict):
        super().__init__()
        if not model_cfg["MLP"]["BN"]:
            raise NotImplementedError("CosineSimAug without BatchNorm is not ported yet")
        self.mlp = SharedMLP(model_cfg["MLP"]["CHANNELS"], bn=True)
        self.conv = ConvStack(model_cfg["CONV"]["CHANNELS"], bn=model_cfg["CONV"]["BN"])

    def forward(self, batch: dict) -> dict:
        out = dict(batch)
        search_feats = batch["search_feats"]  # (B, n2, C)
        template_feats = batch["template_feats"]  # (B, n1, C)
        template_xyz = batch["template_seeds"]  # (B, n1, 3)

        t_norm = template_feats / template_feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        s_norm = search_feats / search_feats.norm(dim=-1, keepdim=True).clamp_min(1e-8)
        sim = torch.bmm(t_norm.float(), s_norm.float().transpose(1, 2))  # (B, n1, n2), float32 as in the JAX module

        # Layer 0 is linear over [sim | xyz_i | feats_i] and only the sim term
        # varies with j: project (xyz_i | feats_i) once per template seed and add
        # the sim row as an outer product, instead of building the (B, n1, n2,
        # 1+3+C) concat (the same function, with ~1/260 of layer 0's work)
        def first_linear(kernel):  # (1+3+C, C1)
            proj_t = matmul(torch.cat([template_xyz, template_feats], dim=-1), kernel[1:])
            return sim[..., None] * kernel[0] + proj_t[:, :, None, :]

        fused = self.mlp(None, first_linear_apply=first_linear)
        fused = fused.amax(dim=1)  # max over the template axis -> (B, n2, C')
        out["cosine_feats"] = self.conv(fused)
        return out
