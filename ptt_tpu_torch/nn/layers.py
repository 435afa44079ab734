"""Pointwise MLP stacks with BatchNorm, channel-last like the JAX package's
``nn/layers.py``: input (..., C_in) -> (..., C_out).

BatchNorm follows flax's ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, which is
not ``torch.nn.BatchNorm1d``'s training rule: the running variance is updated
with the biased batch variance, where torch would use the unbiased one (the gap
is n / (n - 1)). ``BatchNorm`` keeps ``nn.BatchNorm1d``'s weights and running
statistics (its ``momentum`` is the torch-convention weight of the new batch,
1 - flax's) and writes out the normalization and the update in train mode; a
module call either way, so forward hooks see every BatchNorm
(``utils/profiling.py``). Flax computes the batch variance as E[x^2] -
E[x]^2; ``torch.var_mean`` gives the same statistic, rounded more accurately. (PyTorch's
own ``batch_norm`` is not used in train mode: on the CPU it puts the tracker's
features 1e-4 from a float64 run, which the tests could not tell from a fault.)

Under data parallelism (``utils/dist.py``, a process group of more than one
rank) the statistics are those of the global batch, as in the JAX package's
sharded step, where XLA reduces over the global array: one all-reduce that
carries the gradient, of [sum x, sum x^2, n] per layer in float64, then flax's
``var = max(E[x^2] - E[x]^2, 0)``; every rank makes the same running-statistics
update. With no group, or one rank, the statistics are ``torch.var_mean``'s.

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

Eval-mode products on the card: a ``Linear`` call that ``ops/linear.py``
``takes_kernel`` accepts (CUDA float32, no autograd, K and N on the kernel's
tiles, M at or above its crossover), in eval mode with ``use_kernels`` on
(``nn.set_use_kernels``), is one launch of ``csrc/tf32x3.cu`` with the bias in
its epilogue; so is ``mlp2``'s Linear -> ReLU, and ``SharedMLP``'s Linear ->
eval BatchNorm -> ReLU, the ReLU and the BatchNorm's scale and shift in the
epilogue too. Every other call runs as before (``F.linear``, then the
BatchNorm and ReLU modules); a CUDA float32 one counts ``linear.plain``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import linear as linear_ops
from ..ops.sa import fold_bn
from ..utils import timer
from ..utils.dist import all_reduce_sum, get_dist_info

BN_EPS = 1e-5


def _takes_kernel(lin: nn.Linear, x: torch.Tensor, bn=None) -> bool:
    """Whether ``lin`` on ``x``, then ``bn`` if given, is one launch of the
    eval-mode product kernel (module docstring). Counts ``linear.plain`` for a
    CUDA float32 call that it leaves to ``F.linear``."""
    if x.device.type != "cuda" or x.dtype != torch.float32:
        return False
    k = lin.in_features
    if (lin.use_kernels and not lin.training and (bn is None or (not bn.training and lin.bias is None))
            and lin.weight.dtype == torch.float32 and x.is_contiguous()
            and linear_ops.takes_kernel(x.numel() // k, k, lin.out_features, x.dtype, x.device,
                                        torch.is_grad_enabled())):
        return True
    timer.count("linear.plain")
    return False


class Linear(nn.Linear):
    """``nn.Linear`` whose input, weight and bias meet in their promoted type,
    as in flax's Dense (a float32 input under bf16 weights computes in float32).
    ``bn`` (a ``BatchNorm``) and ``relu`` follow the product, in the kernel's
    epilogue where the call takes it (module docstring)."""

    use_kernels = True

    def forward(self, x, bn=None, relu: bool = False):
        if _takes_kernel(self, x, bn):
            vectors = None if bn is None else (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
            return linear_ops.linear_tf32x3(x, self.weight, self.bias, bn=vectors, relu=relu)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        y = F.linear(x.to(dtype), self.weight.to(dtype), bias)
        if bn is not None:
            y = bn(y)
        return torch.relu(y) if relu else y


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


def _global_moments(flat: torch.Tensor):
    """(mean, biased variance) in float32 of the rows of ``flat`` on every rank:
    one differentiable all-reduce of [sum x, sum x^2, n] in float64, and
    flax's E[x^2] - E[x]^2, clipped at 0."""
    c = flat.shape[-1]
    x = flat.double()
    n = torch.full((1,), float(flat.shape[0]), dtype=torch.float64, device=flat.device)
    sums = all_reduce_sum(torch.cat([x.sum(0), (x * x).sum(0), n]))
    mean = sums[:c] / sums[-1]
    var = torch.clamp(sums[c:2 * c] / sums[-1] - mean * mean, min=0.0)
    return var.float(), mean.float()


class BatchNorm(nn.BatchNorm1d):
    """BatchNorm over the last axis of a channel-last tensor: flax's train rule
    (batch statistics, over every rank's batch in a process group; running-stat
    update in place) when ``training``, the running statistics otherwise.

    The update reads its factors from ``factors``, a (2,) float32 tensor on
    the input's device that the train step fills before each dispatch
    (``train/bn_momentum.py`` ``set_bn_factors``), so that a captured step
    follows a momentum schedule; without one, from ``momentum`` as Python
    floats, which a float32 tensor times a float rounds to those factors
    (``flax_bn_factors``)."""

    factors = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(-1, x.shape[-1])
        if not self.training:
            return super().forward(flat).reshape(x.shape)
        if get_dist_info()[1] > 1:
            var, mean = _global_moments(flat)
        else:
            var, mean = torch.var_mean(flat.float(), dim=0, unbiased=False)
        with torch.no_grad():
            if self.factors is None:  # Python floats: a capture outside the train step keeps them as they are
                keep = 1.0 - self.momentum
                rest = 1.0 - keep
            else:
                keep, rest = self.factors.unbind()
            self.running_mean.copy_(keep * self.running_mean + rest * mean)
            self.running_var.copy_(keep * self.running_var + rest * var)
        y = torch.addcmul(self.bias, x - mean, torch.rsqrt(var + self.eps) * self.weight)
        return y.to(torch.promote_types(x.dtype, self.weight.dtype))


class MLP2(nn.Sequential):
    """Linear -> ReLU -> Linear, submodules ``0``, ``1``, ``2``; the ReLU is
    applied by the first Linear, in its epilogue where it takes the kernel."""

    def forward(self, x):
        return self[2](self[0](x, relu=True))


def mlp2(c_in: int, hidden: int, c_out: int) -> nn.Sequential:
    """Linear -> ReLU -> Linear (the JAX package's MLP2)."""
    return MLP2(Linear(c_in, hidden), nn.ReLU(), Linear(hidden, c_out))


class SharedMLP(nn.Module):
    """Linear (+ BatchNorm) + ReLU per layer over the last axis.
    ``channels`` = [in, h1, ..., out]."""

    def __init__(self, channels: Sequence[int], bn: bool = True):
        super().__init__()
        self.bn = bn
        pairs = list(zip(channels[:-1], channels[1:]))
        self.linears = nn.ModuleList(_bn_linear(a, b, bias=not bn) for a, b in pairs)
        self.bns = nn.ModuleList(BatchNorm(b, eps=BN_EPS) for _, b in pairs) if bn else None

    def forward(self, x, first_linear_apply=None):
        """``first_linear_apply``: replaces layer 0's linear by a function of its
        (in, out) weight, for callers that compute layer 0 in a cheaper
        decomposed form (CosineSimAug). Layer 0 is bias-free under BatchNorm."""
        for i, lin in enumerate(self.linears):
            bn = self.bns[i] if self.bn else None
            if i == 0 and first_linear_apply is not None:
                if not self.bn:
                    raise ValueError("first_linear_apply needs the bias-free layer 0 of a BatchNorm stack")
                x = torch.relu(bn(first_linear_apply(lin.weight.t())))
            else:
                x = lin(x, bn=bn, relu=True)
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
        self.bns = nn.ModuleList(BatchNorm(b, eps=BN_EPS) for _, b in pairs[:-1]) if bn else None

    def forward(self, x):
        last = len(self.linears) - 1
        for i, lin in enumerate(self.linears):
            x = lin(x)
            if i < last:
                if self.bn:
                    x = self.bns[i](x)
                x = torch.relu(x)
        return x
