"""Pointwise MLP stacks with eval-mode BatchNorm, channel-last like the JAX
package's ``nn/layers.py``: input (..., C_in) -> (..., C_out).

Linear layers inside BatchNorm stacks get kaiming-normal weights (fan_in, ReLU
gain) and no bias when BatchNorm follows, as in the JAX package; the bare
linear layers of the transformer are ``torch.nn.Linear`` with its default init,
which is the init the JAX package copies.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.sa import fold_bn

BN_EPS = 1e-5


def _bn_linear(c_in: int, c_out: int, bias: bool) -> nn.Linear:
    lin = nn.Linear(c_in, c_out, bias=bias)
    nn.init.kaiming_normal_(lin.weight, nonlinearity="relu")
    return lin


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis of a channel-last tensor."""
    return bn(x.reshape(-1, x.shape[-1])).reshape(x.shape)


def mlp2(c_in: int, hidden: int, c_out: int) -> nn.Sequential:
    """Linear -> ReLU -> Linear (the JAX package's MLP2)."""
    return nn.Sequential(nn.Linear(c_in, hidden), nn.ReLU(), nn.Linear(hidden, c_out))


class SharedMLP(nn.Module):
    """Linear (+ BatchNorm) + ReLU per layer over the last axis.
    ``channels`` = [in, h1, ..., out]."""

    def __init__(self, channels: Sequence[int], bn: bool = True):
        super().__init__()
        self.bn = bn
        pairs = list(zip(channels[:-1], channels[1:]))
        self.linears = nn.ModuleList(_bn_linear(a, b, bias=not bn) for a, b in pairs)
        self.bns = nn.ModuleList(nn.BatchNorm1d(b, eps=BN_EPS) for _, b in pairs) if bn else None

    def forward(self, x, first_linear_apply=None):
        """``first_linear_apply``: replaces layer 0's linear by a function of its
        (in, out) weight, for callers that compute layer 0 in a cheaper
        decomposed form (CosineSimAug). Layer 0 is bias-free under BatchNorm."""
        for i, lin in enumerate(self.linears):
            if i == 0 and first_linear_apply is not None:
                if not self.bn:
                    raise ValueError("first_linear_apply needs the bias-free layer 0 of a BatchNorm stack")
                x = first_linear_apply(lin.weight.t())
            else:
                x = lin(x)
            if self.bn:
                x = _batch_norm(self.bns[i], x)
            x = torch.relu(x)
        return x

    def folded(self):
        """Per-layer (weights, biases) with eval-mode BatchNorm folded in, weights
        in (in, out) layout."""
        weights, biases = [], []
        for i, lin in enumerate(self.linears):
            w = lin.weight.t()
            if self.bn:
                bn = self.bns[i]
                w, b = fold_bn(w, bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            else:
                b = lin.bias
            weights.append(w)
            biases.append(b)
        return weights, biases


class ConvStack(nn.Module):
    """Linear + BatchNorm + ReLU for every layer but the last, which is a bare
    linear projection with a bias. ``channels`` = [in, h1, ..., out]."""

    def __init__(self, channels: Sequence[int], bn: bool = True):
        super().__init__()
        self.bn = bn
        pairs = list(zip(channels[:-1], channels[1:]))
        last = len(pairs) - 1
        self.linears = nn.ModuleList(
            _bn_linear(a, b, bias=not (bn and i < last)) for i, (a, b) in enumerate(pairs)
        )
        self.bns = nn.ModuleList(nn.BatchNorm1d(b, eps=BN_EPS) for _, b in pairs[:-1]) if bn else None

    def forward(self, x):
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                if self.bn:
                    x = _batch_norm(self.bns[i], x)
                x = torch.relu(x)
        return x
