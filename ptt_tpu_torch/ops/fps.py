"""Farthest point sampling: the CUDA kernel ``csrc/fps.cu`` behind the port of
the JAX package's ``ops/pallas_fps.py``, with its plain PyTorch version
(``point_ops.furthest_point_sample``) for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import timer
from . import _build, point_ops

# The kernel's forms, (largest N, warps a row, points a thread), as csrc/fps.cu
# states them (FPS_FORMS): a cloud runs in the first form that holds it, a thread
# keeps its points in registers, and a cloud beyond the last form is refused.
KERNEL_FORMS = ((128, 1, 4), (1024, 8, 4), (2048, 16, 4), (8192, 16, 16))
MAX_POINTS = KERNEL_FORMS[-1][0]


def kernel_form(n: int):
    """(warps a row, points a thread) of the form ``csrc/fps.cu`` runs a cloud of
    ``n`` points in; ValueError beyond the largest."""
    for limit, warps, pts in KERNEL_FORMS:
        if n <= limit:
            return warps, pts
    raise ValueError(f"furthest_point_sample: the kernel takes at most N = {MAX_POINTS} points "
                     f"(its largest form keeps every point in a thread's registers), got {n}")


def check_kernel_shapes(n: int, npoint: int) -> None:
    """Raises ValueError unless ``csrc/fps.cu`` takes (B, n, 3) -> npoint: the
    kernel has one path per form and the wrapper refuses what no form takes."""
    if n < 1 or not 1 <= npoint <= n:
        raise ValueError(f"furthest_point_sample: npoint {npoint} not in [1, {n}]")
    kernel_form(n)


def built_form(n: int):
    """``kernel_form`` as the built library has it (builds it: only where nvcc is)."""
    warps, pts = ctypes.c_int(0), ctypes.c_int(0)
    if _build.function("fps_form")(n, ctypes.byref(warps), ctypes.byref(pts)) != 0:
        raise ValueError(f"furthest_point_sample: csrc/fps.cu has no form for N = {n}")
    return warps.value, pts.value


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """(B, N, 3) float32 -> (B, npoint) int32: the CUDA kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if xyz.device.type == "cpu":
        return point_ops.furthest_point_sample(xyz, npoint)
    return _launch(xyz, npoint)


def furthest_point_sample_packed(xyz: torch.Tensor, npoint: int, warps: int, pts: int) -> torch.Tensor:
    """The kernel's round written out in plain PyTorch, for the form ``warps`` x
    ``pts``: point i sits in slot i // threads of thread i % threads; a thread
    takes the first of its slots that holds its largest running minimum; a warp
    takes the largest of its threads' values, compared as the unsigned integers
    their bits are (every running minimum is a float in [+0, 1e10], and those
    order as their bits do), and then the lowest index among the threads that
    hold it; the block does the same over its warps. Slots past N hold 0 and an
    index above every real one. Equal to ``point_ops.furthest_point_sample``."""
    xyz = xyz.float()
    B, N, _ = xyz.shape
    threads = 32 * warps
    cap = threads * pts
    if N > cap:
        raise ValueError(f"furthest_point_sample_packed: {warps} x {pts} holds {cap} points, got {N}")
    dev = xyz.device
    pad = torch.zeros((B, cap - N, 3), dtype=torch.float32, device=dev)
    cloud = torch.cat([xyz, pad], dim=1)
    min_d2 = torch.cat([torch.full((B, N), 1e10, dtype=torch.float32, device=dev),
                        torch.zeros((B, cap - N), dtype=torch.float32, device=dev)], dim=1)
    index = torch.arange(cap, device=dev).expand(B, cap)
    no_index = torch.iinfo(torch.int64).max
    rows = torch.arange(B, device=dev)
    cur = torch.zeros(B, dtype=torch.long, device=dev)
    out = torch.zeros(B, npoint, dtype=torch.long, device=dev)

    def lowest_of_largest(bits, idx):
        """Over the last axis: the largest bits, and the lowest idx among its holders."""
        top = bits.amax(dim=-1, keepdim=True)
        return top[..., 0], torch.where(bits == top, idx, no_index).amin(dim=-1)

    for k in range(1, npoint):
        d = cloud - cloud[rows, cur][:, None, :]
        min_d2 = torch.minimum(min_d2, point_ops._sq_norm(d))
        bits = min_d2.view(torch.int32).long()  # non-negative floats: the int32 is the unsigned value
        # a thread's slots: (B, pts, threads) -> the first slot with the thread's largest value
        per_thread = bits.reshape(B, pts, threads)
        slots = torch.arange(pts, device=dev)[None, :, None]
        slot = torch.where(per_thread == per_thread.amax(dim=1, keepdim=True), slots, pts).amin(dim=1)
        t_bits = torch.gather(per_thread, 1, slot[:, None, :])[:, 0]
        t_idx = torch.gather(index.reshape(B, pts, threads), 1, slot[:, None, :])[:, 0]
        w_bits, w_idx = lowest_of_largest(t_bits.reshape(B, warps, 32), t_idx.reshape(B, warps, 32))
        _, cur = lowest_of_largest(w_bits, w_idx)
        out[:, k] = cur
    return out.int()


def _launch(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    if xyz.device.type != "cuda":
        raise ValueError(f"furthest_point_sample: no kernel for device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"furthest_point_sample: want (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    if not xyz.is_contiguous():
        raise ValueError("furthest_point_sample: xyz must be contiguous")
    B, N, _ = xyz.shape
    check_kernel_shapes(N, npoint)
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    fn = _build.function("fps_forward")
    guard, stream = _build.on_device(xyz.device)
    with guard:
        err = fn(xyz.data_ptr(), out.data_ptr(), B, N, npoint, stream)
    _build.check_launch(err, "fps")
    timer.count("launches.fps")
    return out


PROBE_STEPS = ("alu", "shfl", "redux", "ballot", "smem_load", "smem_store_load", "barrier")


def latency_probe(device, iters: int = 4096) -> dict:
    """Cycles of one dependent step of each primitive an FPS round is made of, read
    on ``device`` by csrc/fps.cu ``fps_probe_kernel``: float add, warp shuffle,
    ``redux.sync``, shared-memory load, shared-memory store then load, and a
    block barrier of 1, 4 and 16 warps. Not counted as a launch."""
    fn = _build.function("fps_probe")
    out = {}
    guard, stream = _build.on_device(torch.device(device))
    with guard:
        for warps in (1, 4, 16):
            buf = torch.zeros(len(PROBE_STEPS) + 3, dtype=torch.int64, device=device)
            _build.check_launch(fn(buf.data_ptr(), iters, 32 * warps, stream),
                                "fps probe")
            cycles = (buf[:len(PROBE_STEPS)].double() / iters).tolist()
            if warps == 1:
                out.update(zip(PROBE_STEPS[:-1], cycles))
                out["clock_ghz"] = float(buf[len(PROBE_STEPS)]) / float(buf[len(PROBE_STEPS) + 1])
            out[f"barrier_{warps}"] = cycles[-1]
    return out


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
