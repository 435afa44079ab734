"""BatchNorm momentum schedule (the JAX package's ``train/bn_momentum.py``):
torch-convention momentum 0.5 * 0.5^(epoch // 20), clipped at 0.01, the
pointnet2 rule, used when OPTIMIZATION.BN_SCHEDULER is set.

The JAX package bakes flax momentum 0.9 into its modules and re-blends the
updated statistics afterwards, new = mt * old + (1 - mt) * obs with obs
recovered from the fixed-momentum update. Here a module's momentum is an
attribute, so the train step sets the scheduled momentum before the forward and
the update uses it directly: the same statistics, without the recovery's
rounding. Flax momentum m weights the old statistics; torch momentum 1 - m
weights the new batch.
"""

from __future__ import annotations

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
