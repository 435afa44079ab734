"""Point-transformer attention blocks: the JAX package's ``nn/transformer.py``
registry of 9 variants. The default of ptt.yaml is ``TransformerBlock``,
vector attention over a kNN neighbourhood: per-channel logits
``fc_gamma(q - k + delta)`` softmaxed over the k neighbours, with
``delta = fc_delta(x_i - x_j)`` added to the values. ptt_large.yaml runs
``MulTransformerBlock``, a stack of multi-head layers with LayerNorms.

Every block but ``TransformerBlockBackbone`` returns ``(features, attn)``.
Submodule names are the flax names (``fc1``, ``w_qs``, ``fc_gamma``,
``layers.<i>``, ``norm1``, ...), which ``convert.py`` maps both ways.
LayerNorm takes flax's epsilon, 1e-6 (torch's default is 1e-5).

Every block's forward is the span ``transformer.block`` of ``utils/timer.py``
(``n``: the points it attends over, batch included), recorded where the
forward runs eagerly (a captured graph's replay runs no Python); each kNN
search counts one ``launches.knn``, which a replay advances too.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from ..ops.point_ops import group_points, knn
from ..utils import timer
from .layers import LayerNorm, Linear, matmul, mlp2

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _traced(forward):
    """A block's ``forward(xyz, ...)`` inside the span ``transformer.block``."""
    @functools.wraps(forward)
    def traced(self, xyz, *args):
        with timer.span("transformer.block", n=xyz.shape[0] * xyz.shape[1]):
            return forward(self, xyz, *args)

    return traced


def _neighbourhood(xyz, k):
    """kNN of every point among the points (self included): (idx (B, N, k),
    their xyz (B, N, k, 3))."""
    idx = knn(k, xyz, xyz)
    timer.count("launches.knn")
    return idx, group_points(xyz, idx)


def _attend(logits, values, scale: int):
    """Softmax of ``logits / sqrt(scale)`` over the neighbour axis (-2) and the
    weighted sum of ``values`` over it: (attn, (..., F)). The JAX blocks divide
    by a numpy float, which promotes bf16 logits to float32: so do these."""
    attn = torch.softmax(logits.float() / math.sqrt(scale), dim=-2)
    return attn, (attn * values).sum(dim=-2)


class _QKV(nn.Module):
    """fc1, the bias-free query/key/value projections and fc_delta, the parts
    every block but the STD/ALL pair reads over a kNN neighbourhood."""

    def __init__(self, d_points: int, d_model: int, k: int, fc1: nn.Module | None = None):
        super().__init__()
        self.k = k
        self.d_model = d_model
        self.fc1 = fc1 if fc1 is not None else Linear(d_points, d_model)
        self.w_qs = Linear(d_model, d_model, bias=False)
        self.w_ks = Linear(d_model, d_model, bias=False)
        self.w_vs = Linear(d_model, d_model, bias=False)
        self.fc_delta = mlp2(3, d_model, d_model)

    def qkv(self, xyz, features):
        """-> (x = fc1(features), q (B, N, d), k and v (B, N, k, d) at the
        neighbours, pos_enc (B, N, k, d))."""
        idx, knn_xyz = _neighbourhood(xyz, self.k)
        x = self.fc1(features)
        q = self.w_qs(x)
        k = group_points(self.w_ks(x), idx)
        v = group_points(self.w_vs(x), idx)
        return x, q, k, v, self.fc_delta(xyz[:, :, None] - knn_xyz)


class TransformerBlock(_QKV):
    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc2 = Linear(d_model, d_points)

    @_traced
    def forward(self, xyz, features):
        """(B, N, 3), (B, N, d_points) -> (features (B, N, d_points), attn (B, N, k, d_model))."""
        _, q, k, v, pos_enc = self.qkv(xyz, features)
        attn, res = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
        return self.fc2(res) + features, attn


class TransformerBlockMLP(_QKV):
    """TransformerBlock with two-layer (MLP2) in and out projections."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k, fc1=mlp2(d_points, d_model, d_model))
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc2 = mlp2(d_model, d_model, d_points)

    @_traced
    def forward(self, xyz, features):
        _, q, k, v, pos_enc = self.qkv(xyz, features)
        attn, res = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
        return self.fc2(res) + features, attn


class TransformerBlockOffset(_QKV):
    """TransformerBlock that feeds (x - attended) through the out projection."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc2 = Linear(d_model, d_points)

    @_traced
    def forward(self, xyz, features):
        x, q, k, v, pos_enc = self.qkv(xyz, features)
        attn, res = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
        return self.fc2(x - res) + features, attn


class TransformerBlockCosine(_QKV):
    """kNN vector attention with the cosine similarity of q and k as one more
    channel of the relative term, projected back by fc_sim."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_sim = Linear(d_model + 1, d_model)
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc2 = Linear(d_model, d_points)

    @_traced
    def forward(self, xyz, features):
        _, q, k, v, pos_enc = self.qkv(xyz, features)
        q = q[:, :, None]
        sim = (q * k).sum(-1) / torch.clamp_min(q.norm(dim=-1) * k.norm(dim=-1), 1e-8)
        rel = self.fc_sim(torch.cat([sim[..., None], q - k], dim=-1))
        attn, res = _attend(self.fc_gamma(rel + pos_enc), v + pos_enc, self.d_model)
        return self.fc2(res) + features, attn


class TransformerBlockBackbone(_QKV):
    """Attention over neighbourhoods an SA stage already grouped; the centers
    are the points (N == M), as in the reference. Called with (new_xyz (B, M, 3),
    grouped_xyz (B, M, ns, 3), grouped_idx (B, M, ns), features (B, N, C));
    returns the attended features (B, M, d_model) only, with no out projection."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_gamma = mlp2(d_model, d_model, d_model)

    @_traced
    def forward(self, new_xyz, grouped_xyz, grouped_idx, features):
        x = self.fc1(features)
        q = self.w_qs(x)
        k = group_points(self.w_ks(x), grouped_idx)
        v = group_points(self.w_vs(x), grouped_idx)
        pos_enc = self.fc_delta(new_xyz[:, :, None] - grouped_xyz)
        _, out = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
        return out


class CrossAttentionBlock(_QKV):
    """Template -> search attention over the search points' kNN: queries from
    the template features, keys and values from the search features, both
    through the one fc1; the template has as many points as the search."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_gamma = mlp2(d_model, d_model, d_model)
        self.fc3 = Linear(d_model, d_points)

    @_traced
    def forward(self, xyz, search_feat, template_feat):
        idx, knn_xyz = _neighbourhood(xyz, self.k)
        s = self.fc1(search_feat)
        q = self.w_qs(self.fc1(template_feat))
        k = group_points(self.w_ks(s), idx)
        v = group_points(self.w_vs(s), idx)
        pos_enc = self.fc_delta(xyz[:, :, None] - knn_xyz)
        attn, res = _attend(self.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, self.d_model)
        return self.fc3(res) + search_feat, attn


class _Global(nn.Module):
    """fc1, q/k/v and a pointwise fc_delta of the absolute xyz: the parts of
    the two blocks without a neighbourhood."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__()
        self.d_model = d_model
        self.fc1 = Linear(d_points, d_model)
        self.w_qs = Linear(d_model, d_model, bias=False)
        self.w_ks = Linear(d_model, d_model, bias=False)
        self.w_vs = Linear(d_model, d_model, bias=False)
        self.fc_delta = mlp2(3, d_model, d_model)
        self.fc2 = Linear(d_model, d_points)


class TransformerBlockSTD(_Global):
    """Global scalar attention: softmax(q k^T / sqrt(d)) over all points."""

    @_traced
    def forward(self, xyz, features):
        x = self.fc1(features)
        q, k, v = self.w_qs(x), self.w_ks(x), self.w_vs(x)
        # the logits in float32 whatever q and k are (the JAX block's preferred type)
        attn = torch.softmax(torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(self.d_model), dim=-1)
        res = matmul(attn, v + self.fc_delta(xyz))
        return self.fc2(res) + features, attn


class TransformerBlockALL(_Global):
    """Pointwise vector attention, the softmax taken over the points."""

    def __init__(self, d_points: int, d_model: int, k: int):
        super().__init__(d_points, d_model, k)
        self.fc_gamma = mlp2(d_model, d_model, d_model)

    @_traced
    def forward(self, xyz, features):
        x = self.fc1(features)
        q, k, v = self.w_qs(x), self.w_ks(x), self.w_vs(x)
        pos_enc = self.fc_delta(xyz)
        attn = torch.softmax(self.fc_gamma(q - k + pos_enc).float() / math.sqrt(self.d_model), dim=-2)
        return self.fc2(attn * (v + pos_enc)) + features, attn


class MulHeadTransformerLayer(_QKV):
    """Multi-head kNN vector attention: the d_model channels split into
    ``heads`` heads of head_dim, one fc_gamma MLP (head_dim -> head_dim) shared
    by all heads, then a bias-free proj, LayerNorm, fc2 and a second LayerNorm
    before the residual. (The JAX package's dropout after proj is 0 and off in
    eval mode; it is left out.)"""

    def __init__(self, d_points: int, d_model: int, k: int, heads: int):
        super().__init__(d_points, d_model, k)
        self.heads = heads
        self.head_dim = d_model // heads
        self.fc_gamma = mlp2(self.head_dim, self.head_dim, self.head_dim)
        self.proj = Linear(d_model, d_model, bias=False)
        self.norm1 = LayerNorm(d_model, eps=LN_EPS)
        self.fc2 = Linear(d_model, d_points)
        self.norm2 = LayerNorm(d_points, eps=LN_EPS)

    def forward(self, xyz, features):
        _, q, k, v, pos_enc = self.qkv(xyz, features)
        B, N, _ = q.shape

        def split(t):  # (B, N, K, H * hd) -> (B, H, N, K, hd)
            return t.reshape(B, N, t.shape[2], self.heads, self.head_dim).permute(0, 3, 1, 2, 4)

        qh = q.reshape(B, N, self.heads, self.head_dim).transpose(1, 2)
        kh, vh, ph = split(k), split(v), split(pos_enc)
        attn, res = _attend(self.fc_gamma(qh[:, :, :, None] - kh + ph), vh + ph, self.head_dim)
        res = self.norm1(self.proj(res.transpose(1, 2).reshape(B, N, self.d_model)))
        return self.norm2(self.fc2(res)) + features, attn


class MulTransformerBlock(nn.Module):
    """A stack of ``layers`` MulHeadTransformerLayers; returns the last
    layer's features and attention."""

    def __init__(self, d_points: int, d_model: int, k: int, heads: int, layers: int):
        super().__init__()
        self.layers = nn.ModuleList(MulHeadTransformerLayer(d_points, d_model, k, heads) for _ in range(layers))

    @_traced
    def forward(self, xyz, features):
        attn = None
        for layer in self.layers:
            features, attn = layer(xyz, features)
        return features, attn


ALL_TRANSFORMERS = {
    "MulTransformerBlock": MulTransformerBlock,
    "TransformerBlock": TransformerBlock,
    "TransformerBlockALL": TransformerBlockALL,
    "TransformerBlockBackbone": TransformerBlockBackbone,
    "TransformerBlockCosine": TransformerBlockCosine,
    "TransformerBlockMLP": TransformerBlockMLP,
    "TransformerBlockOffset": TransformerBlockOffset,
    "TransformerBlockSTD": TransformerBlockSTD,
    "CrossAttentionBlock": CrossAttentionBlock,
}


def build_transformer(cfg: dict) -> nn.Module:
    """The block named by ``cfg["NAME"]`` with DIM_INPUT, DIM_MODEL, KNN (and
    N_HEADS, N_LAYERS for MulTransformerBlock)."""
    cls = ALL_TRANSFORMERS[cfg["NAME"]]
    args = [int(cfg["DIM_INPUT"]), int(cfg["DIM_MODEL"]), int(cfg["KNN"])]
    if cls is MulTransformerBlock:
        args += [int(cfg["N_HEADS"]), int(cfg["N_LAYERS"])]
    return cls(*args)
