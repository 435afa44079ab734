"""PyTorch modules of the PTT tracker, eval mode."""

from .tracker import PTT, build_network, set_use_kernels

__all__ = ["PTT", "build_network", "set_use_kernels"]
