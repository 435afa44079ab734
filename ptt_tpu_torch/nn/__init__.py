"""PyTorch modules of the PTT tracker (train and eval mode) and its losses."""

from .losses import compute_losses
from .tracker import PTT, build_network, set_use_kernels

__all__ = ["PTT", "build_network", "compute_losses", "set_use_kernels"]
