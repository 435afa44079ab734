"""BatchNorm momentum schedule (the JAX package's ``train/bn_momentum.py``):
torch-convention momentum 0.5 * 0.5^(epoch // 20), clipped at 0.01, the
pointnet2 rule, used when OPTIMIZATION.BN_SCHEDULER is set.

The JAX package bakes flax momentum 0.9 into its modules and re-blends the
updated statistics afterwards, new = mt * old + (1 - mt) * obs with obs
recovered from the fixed-momentum update, mt a traced argument of the step.
Here the update uses the scheduled momentum directly: the same statistics,
without the recovery's rounding. The train step puts its two factors on the
device (``flax_bn_factors``) and points every BatchNorm at them
(``set_bn_factors``), so that one captured step serves every epoch, as one
compiled JAX step does. Flax momentum m weights the old statistics; torch
momentum 1 - m weights the new batch.
"""

from __future__ import annotations

import torch
from torch import nn

MODEL_BN_MOMENTUM = 0.9  # flax momentum of every BatchNorm when no schedule is set


def bn_momentum_for_epoch(epoch: int, bn_init: float = 0.5, bn_decay: float = 0.5,
                          decay_step: int = 20, bn_clip: float = 0.01) -> float:
    """Torch-convention momentum for ``epoch``."""
    return max(bn_init * bn_decay ** (epoch // decay_step), bn_clip)


def set_bn_momentum(model: nn.Module, flax_momentum: float) -> None:
    """Every BatchNorm of ``model`` keeps ``flax_momentum`` of its old
    statistics in its next train-mode update."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.momentum = 1.0 - float(flax_momentum)


def flax_bn_factors(flax_momentum: float) -> torch.Tensor:
    """(keep, 1 - keep), the weights of the old statistics and of the batch's
    in a train-mode update under flax momentum ``flax_momentum``, as a (2,)
    float32 tensor on the host: each computed in double from the momentum
    ``set_bn_momentum`` sets, as ``nn/layers.py`` BatchNorm computes them
    without factors, and rounded to float32, as a float32 tensor times a
    Python float rounds the float."""
    keep = 1.0 - (1.0 - float(flax_momentum))
    return torch.tensor([keep, 1.0 - keep], dtype=torch.float32)


def set_bn_factors(model: nn.Module, factors) -> None:
    """Every BatchNorm of ``model`` reads its update's factors from
    ``factors`` (a (2,) float32 tensor on its device), or from its momentum
    with None."""
    for m in model.modules():
        if isinstance(m, nn.BatchNorm1d):
            m.factors = factors
