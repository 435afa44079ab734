"""Pointwise MLP stacks with BatchNorm, channel-last like the JAX package's
``nn/layers.py``: input (..., C_in) -> (..., C_out).

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, which is
not ``torch.nn.BatchNorm1d``'s training rule: the running variance is updated
with the biased batch variance, where torch would use the unbiased one (the gap
is n / (n - 1)). The modules keep ``nn.BatchNorm1d`` as the holder of the
weights and running statistics (its ``momentum`` is the torch-convention weight
of the new batch, 1 - flax's); in train mode the normalization and the update
are written out. Flax computes the batch variance as E[x^2] - E[x]^2;
``torch.var_mean`` gives the same statistic, rounded more accurately. (PyTorch's
own ``batch_norm`` is not used in train mode: on the CPU it puts the tracker's
features 1e-4 from a float64 run, which the tests could not tell from a fault.)

Linear layers inside BatchNorm stacks get kaiming-normal weights (fan_in, ReLU
gain) and no bias when BatchNorm follows, as in the JAX package; the bare
linear layers of the transformer keep ``torch.nn.Linear``'s default init,
which is the init the JAX package copies.

Mixed precision (``train/train_step.py``) runs the model on bfloat16 copies of
the parameters, and every layer here follows flax's promotion rather than
autocast: a linear layer computes in the promoted type of its input and
weights (``Linear``, ``matmul``: bf16 weights under a float32 input compute in
float32), BatchNorm takes its statistics in float32 and returns the promoted
type of its input and parameters, and the running statistics stay float32.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.sa import fold_bn

BN_EPS = 1e-5


class Linear(nn.Linear):
    """``nn.Linear`` whose input, weight and bias meet in their promoted type,
    as in flax's Dense (a float32 input under bf16 weights computes in float32)."""

    def forward(self, x):
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with its statistics in float32 and its output in the
    promoted type of its input and parameters, as flax's LayerNorm."""

    def forward(self, x):
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


def matmul(a, b):
    """``a @ b`` in the promoted type of the two, as jnp's ``@``."""
    dtype = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dtype), b.to(dtype))


def _bn_linear(c_in: int, c_out: int, bias: bool) -> nn.Linear:
    lin = Linear(c_in, c_out, bias=bias)
    nn.init.kaiming_normal_(lin.weight, nonlinearity="relu")
    return lin


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """BatchNorm over the last axis of a channel-last tensor: flax's train rule
    (batch statistics, running-stat update in place) when ``bn.training``, the
    running statistics otherwise."""
    flat = x.reshape(-1, x.shape[-1])
    if not bn.training:
        return bn(flat).reshape(x.shape)
    var, mean = torch.var_mean(flat.float(), dim=0, unbiased=False)
    with torch.no_grad():
        keep = 1.0 - bn.momentum  # flax momentum: the weight of the old statistics
        bn.running_mean.copy_(keep * bn.running_mean + (1.0 - keep) * mean)
        bn.running_var.copy_(keep * bn.running_var + (1.0 - keep) * var)
    y = torch.addcmul(bn.bias, x - mean, torch.rsqrt(var + bn.eps) * bn.weight)
    return y.to(torch.promote_types(x.dtype, bn.weight.dtype))


def mlp2(c_in: int, hidden: int, c_out: int) -> nn.Sequential:
    """Linear -> ReLU -> Linear (the JAX package's MLP2)."""
    return nn.Sequential(Linear(c_in, hidden), nn.ReLU(), Linear(hidden, c_out))


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
