"""PointNet++ set-abstraction module (the JAX package's ``nn/sa_module.py``):
sample centers, group each center's neighbourhood, run the shared MLP and take
the max over the neighbourhood.

- eval: one fused SA stage with the MLP's BatchNorm folded in — the CUDA kernel
  ``csrc/sa.cu`` on the GPU, its plain version on the CPU;
- train on the GPU: ball query + group + the bias-free layer 0 as the CUDA
  kernels of ``csrc/group.cu`` (``ops/group.py``), slot-major (B, ns, M, H),
  then BatchNorm and the other layers in plain PyTorch and the max over axis 1;
- train on the CPU: the plain composite, query_and_group -> SharedMLP -> max.

``use_kernels = False`` routes FPS and the SA stage through their plain
PyTorch versions on any device, so a run on the GPU can hold the kernel path
against the plain one on the same weights and inputs.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops import fps, group, point_ops, sa
from .layers import SharedMLP


def sample_indices(method: str, xyz: torch.Tensor, npoint: int, use_kernels: bool = True,
                   features: torch.Tensor | None = None) -> torch.Tensor:
    """Center sampling: 'fps', 'ffps' (FPS on squared distances in [xyz |
    features] space, plain PyTorch as in the JAX package, which has no kernel
    for it; under a point group ``point_ops.square_distance`` splits the
    distance rows), or 'sequence'/'rs' (the first ``npoint`` points, as in the
    reference). -> (B, npoint) int32."""
    if method == "fps":  # on float32 coordinates, bf16-rounded ones under mixed precision
        fn = fps.furthest_point_sample if use_kernels else point_ops.furthest_point_sample
        return fn(xyz.detach().float().contiguous(), npoint)
    if method == "ffps":
        fused = xyz if features is None else torch.cat([xyz, features], dim=-1)
        fused = fused.detach()
        return point_ops.furthest_point_sample_with_dist(point_ops.square_distance(fused, fused), npoint)
    if method in ("rs", "sequence"):
        ar = torch.arange(npoint, dtype=torch.int32, device=xyz.device)
        return ar[None, :].expand(xyz.shape[0], npoint)
    raise NotImplementedError(f"sample method {method!r} is not ported yet")


class PointnetSAModule(nn.Module):
    """(B, N, 3) xyz + (B, N, C) features -> (new_xyz (B, npoint, 3),
    new_features (B, npoint, C_out), inds (B, npoint)).
    ``mlp_channels`` = [C_in, h1, ..., C_out]; 3 is added for the relative xyz
    when ``use_xyz``."""

    def __init__(self, mlp_channels: Sequence[int], radius: float, nsample: int,
                 use_xyz: bool = True, normalize_xyz: bool = True, sample_method: str = "fps",
                 bn: bool = True):
        super().__init__()
        spec = list(mlp_channels)
        if use_xyz:
            spec[0] += 3
        self.mlp = SharedMLP(spec, bn=bn)
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.use_xyz = use_xyz
        self.normalize_xyz = normalize_xyz
        self.sample_method = sample_method
        self.use_kernels = True

    def forward(self, xyz, features=None, npoint: int | None = None, inds=None):
        xyz = xyz.contiguous()
        if inds is None:
            inds = sample_indices(self.sample_method, xyz, npoint, self.use_kernels, features)
        new_xyz = point_ops.gather_points(xyz, inds)
        if self.training:
            return new_xyz, self._train_features(xyz, new_xyz, features), inds
        weights, biases = self.mlp.folded()
        sa_fn = sa.fused_sa_inference if self.use_kernels else sa.fused_sa_plain
        new_features = sa_fn(xyz, new_xyz, features, self.radius, self.nsample, weights, biases,
                             normalize_xyz=self.normalize_xyz, use_xyz=self.use_xyz)
        return new_xyz, new_features, inds

    def _train_features(self, xyz, new_xyz, features):
        if self.use_kernels and self.mlp.bn and xyz.device.type == "cuda":
            def first_linear(w1):
                return group.grouped_first_linear(xyz, new_xyz, features, w1, self.radius, self.nsample,
                                                  normalize_xyz=self.normalize_xyz, use_xyz=self.use_xyz)

            return self.mlp(None, first_linear_apply=first_linear).amax(dim=1)
        grouped, _, _ = point_ops.query_and_group(self.radius, self.nsample, xyz, new_xyz, features,
                                                  use_xyz=self.use_xyz, normalize_xyz=self.normalize_xyz)
        return self.mlp(grouped).amax(dim=2)
