"""Farthest point sampling: the CUDA kernel ``csrc/fps.cu`` behind the port of
the JAX package's ``ops/pallas_fps.py``, with its plain PyTorch version
(``point_ops.furthest_point_sample``) for tensors on the CPU.
"""

from __future__ import annotations

import torch

from . import _build, point_ops

# kernel launches made through furthest_point_sample (a run resets it to 0)
launches = 0

_MAX_SHARED_BYTES = 227 * 1024


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if xyz.device.type == "cpu":
        return point_ops.furthest_point_sample(xyz, npoint)
    return _launch(xyz, npoint)


def _launch(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    global launches
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: no kernel for device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: want (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample: xyz must be contiguous")
    B, N, _ = xyz.shape
    if not 1 <= npoint <= N:
        raise ValueError(f"furthest_point_sample: npoint {npoint} not in [1, {N}]")
    if N * 16 > _MAX_SHARED_BYTES:
        raise ValueError(f"furthest_point_sample: N = {N} points do not fit in shared memory")
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    fn = _build.function("fps_forward")
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    _build.check_launch(err, "fps")
    launches += 1
    return out


def chain_probe(batch: int, n: int, npoint: int, device) -> None:
    """Launch the dependent chain of ``npoint`` rounds alone, in the launch
    geometry ``furthest_point_sample`` uses for (batch, n, 3) -> npoint
    (csrc/fps.cu ``fps_chain_kernel``): a timing of it gives what this design's
    barriers and reductions cost without its per-point work. Not counted as a launch."""
    out = torch.empty((batch,), dtype=torch.int32, device=device)
    fn = _build.function("fps_chain_probe")
    with torch.cuda.device(device):
        err = fn(out.data_ptr(), batch, n, npoint, torch.cuda.current_stream().cuda_stream)
    _build.check_launch(err, "fps chain probe")


def furthest_point_sample_pair(xyz_a, npoint_a: int, xyz_b, npoint_b: int,
                               sample=furthest_point_sample):
    """FPS of the two Siamese branches in one call of ``sample``. The smaller
    cloud is padded to the larger N with copies of its point 0: pads sit at
    distance 0 from the first choice and never win while a real point remains,
    and greedy FPS is prefix-stable, so cutting the padded run to ``npoint_b``
    equals the unpadded run. Returns (idx_a (B, npoint_a), idx_b (B, npoint_b))."""
    if xyz_a.shape[1] < xyz_b.shape[1] or npoint_a < npoint_b:
        raise ValueError("furthest_point_sample_pair: pass the larger branch first")
    B, Na, _ = xyz_a.shape
    Nb = xyz_b.shape[1]
    if Nb < Na:
        xyz_b = torch.cat([xyz_b, xyz_b[:, :1].expand(B, Na - Nb, 3)], dim=1)
    idx = sample(torch.cat([xyz_a, xyz_b], dim=0), npoint_a)
    return idx[:B], idx[B:, :npoint_b]
