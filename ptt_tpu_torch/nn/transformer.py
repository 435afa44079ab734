"""Point-transformer vector attention over a kNN neighbourhood (the JAX
package's ``nn/transformer.py`` ``TransformerBlock``, the default of ptt.yaml):
per-channel logits ``fc_gamma(q - k + delta)`` softmaxed over the k neighbours,
with ``delta = fc_delta(x_i - x_j)`` added to the values.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.point_ops import group_points, knn
from .layers import mlp2


class TransformerBlock(nn.Module):
    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__()
        self.k = k
        self.d_model = d_model
        self.fc1 = nn.Linear(d_points, d_model)
        self.w_qs = nn.Linear(d_model, d_model, bias=False)
        self.w_ks = nn.Linear(d_model, d_model, bias=False)
        self.w_vs = nn.Linear(d_model, d_model, bias=False)
        self.fc_delta = mlp2(3, d_model, d_model)
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc2 = nn.Linear(d_model, d_points)

    def forward(self, xyz, features):
        """(B, N, 3), (B, N, d_points) -> (features (B, N, d_points), attn (B, N, k, d_model))."""
        knn_idx = knn(self.k, xyz, xyz)  # (B, N, k)
        knn_xyz = group_points(xyz, knn_idx)

        pre = features
        x = self.fc1(features)
        q = self.w_qs(x)
        k = group_points(self.w_ks(x), knn_idx)
        v = group_points(self.w_vs(x), knn_idx)

        pos_enc = self.fc_delta(xyz[:, :, None] - knn_xyz)
        attn = self.fc_gamma(q[:, :, None] - k + pos_enc)
        attn = torch.softmax(attn / math.sqrt(self.d_model), dim=-2)  # over the k neighbours

        res = (attn * (v + pos_enc)).sum(dim=2)
        return self.fc2(res) + pre, attn


ALL_TRANSFORMERS = {"TransformerBlock": TransformerBlock}


def build_transformer(cfg: dict) -> nn.Module:
    name = cfg["NAME"]
    if name not in ALL_TRANSFORMERS:
        raise NotImplementedError(f"transformer {name!r} is not ported yet")
    return ALL_TRANSFORMERS[name](int(cfg["DIM_INPUT"]), int(cfg["DIM_MODEL"]), int(cfg["KNN"]))
