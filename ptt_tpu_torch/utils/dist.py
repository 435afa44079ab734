"""Multi-process helpers (the JAX package's ``utils/dist.py``), on
``torch.distributed``: one process per GPU, launched by ``torchrun``
(``python -m torch.distributed.run``).

- ``init_distributed`` joins the group that torchrun's environment describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``),
  or the one a ``file://`` init method names;
- ``get_dist_info`` gives (rank, world size), (0, 1) with no group;
- ``all_gather_array`` / ``merge_metric_lists`` gather small per-rank arrays
  and per-frame metric lists to every rank;
- ``all_reduce_sum`` is an all-reduce that carries a gradient (BatchNorm
  statistics over the global batch), ``all_reduce_mean_`` averages tensors in
  place through one flat buffer (the gradients of a train step);
- ``broadcast_module`` copies rank 0's parameters and buffers to every rank;
- ``point_groups`` makes each node's ranks a process group (the point axis of
  POINT_SHARDING is split over it), ``all_gather_rows`` gathers a group's row
  slices along dim 1, and ``data_shard`` is this rank's shard of the data when
  the ranks of a node share theirs.

The backend is NCCL unless the caller names another; nothing switches it.
NCCL needs a GPU a rank, so two ranks on one device are refused. Gloo takes
CPU tensors and CUDA tensors, and allows ranks that share a device.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist


def get_dist_info():
    """(rank, world size) of this process; (0, 1) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(backend: str = "nccl", init_method: str = "env://", device="cuda"):
    """Join the process group of ``RANK`` and ``WORLD_SIZE`` (torchrun sets
    them, and ``MASTER_ADDR`` / ``MASTER_PORT`` for ``env://``), and resolve
    this rank's device: ``"cuda"`` is ``cuda:{LOCAL_RANK}``, an explicit
    ``cuda:N`` is kept. Returns (rank, world size, device).

    Raises when NCCL is asked for without a GPU, with a CPU device, or with
    two ranks of one host on one device (gloo allows that)."""
    from .. import resolve_device

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    if backend == "nccl" and (torch.device(device).type != "cuda" or not torch.cuda.is_available()):
        raise RuntimeError(f"the nccl backend runs on CUDA devices, not on {device!r}; "
                           "name --dist_backend gloo to run the ranks on the CPU")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    device = resolve_device(device)
    if backend == "nccl":
        # before any NCCL collective: each rank's host and device, over a gloo group
        check = dist.new_group(backend="gloo")
        places = [None] * world
        dist.all_gather_object(places, (socket.gethostname(), device.index), group=check)
        dist.destroy_process_group(check)
        shared = [r for r in range(world) if r != rank and places[r] == places[rank]]
        if shared:
            raise RuntimeError(f"rank {rank} and rank {shared[0]} are both on {device} of {places[rank][0]}: "
                               "NCCL needs a device a rank; give each rank its own GPU, or name "
                               "--dist_backend gloo to share one")
    return rank, world, device


def local_world_size() -> int:
    """The ranks of this node: torchrun's ``LOCAL_WORLD_SIZE``, or the whole
    world where it is not set (a ``file://`` start); 1 with no group."""
    world = get_dist_info()[1]
    return int(os.environ.get("LOCAL_WORLD_SIZE", world)) if world > 1 else 1


def point_groups():
    """Each node's ranks as a process group of the default backend: ranks
    [k * L, (k + 1) * L) for node k, L = ``local_world_size()``, torchrun's
    numbering. ``new_group`` is collective over the whole world, so every rank
    makes every group, in the order of the nodes. Returns (this rank's group,
    its ranks)."""
    rank, world = get_dist_info()
    local = local_world_size()
    if world % local:
        raise ValueError(f"{world} ranks do not split into nodes of {local}")
    mine = None
    for node in range(world // local):
        ranks = list(range(node * local, (node + 1) * local))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = (group, ranks)
    return mine


def data_shard():
    """(shard, shards) of this rank when the ranks of a node share one shard
    of the data: the node's index and the number of nodes."""
    rank, world = get_dist_info()
    local = local_world_size()
    return rank // local, world // local


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (B, n, ...) of the process group ``group``,
    concatenated along dim 1 in the group's rank order: (B, n * size, ...).
    Every rank's ``x`` has the same shape. A CUDA tensor on gloo is staged
    through pinned host memory (gloo's collectives run on the host); on NCCL
    it is gathered where it lies."""
    size = dist.get_world_size(group)
    x = x.contiguous()
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    src = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x) if staged else x
    out = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(out, src, group=group)
    rows = torch.cat(out, dim=1)
    return rows.to(x.device) if staged else rows


def all_equal(values, group) -> bool:
    """Whether every rank of ``group`` passed the same list of integers."""
    device = torch.device("cuda", torch.cuda.current_device()) if dist.get_backend(group) == "nccl" else "cpu"
    t = torch.tensor(values, dtype=torch.int64, device=device)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return all(torch.equal(o, out[0]) for o in out)


def group_broadcast_(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """``x`` (contiguous) replaced in place by rank ``src``'s (a global rank of
    ``group``); staged through host memory as ``all_gather_rows`` stages it."""
    if not x.is_contiguous():
        raise ValueError("group_broadcast_ takes a contiguous tensor")
    staged = x.device.type == "cuda" and dist.get_backend(group) == "gloo"
    buf = x.cpu() if staged else x
    dist.broadcast(buf, src=src, group=group)
    if staged:
        x.copy_(buf)
    return x


def barrier() -> None:
    """Wait for every rank; nothing with no group."""
    if get_dist_info()[1] > 1:
        dist.barrier()


def _comm_device():
    """Where the gathered host arrays go: the current GPU for NCCL, else the CPU."""
    return torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl" else torch.device("cpu")


def all_gather_array(x: np.ndarray) -> np.ndarray:
    """Gather one fixed-shape per-rank array to every rank: (world, *x.shape).
    With no group: ``x[None]``."""
    x = np.asarray(x)
    world = get_dist_info()[1]
    if world == 1:
        return x[None]
    t = torch.from_numpy(np.ascontiguousarray(x).reshape(-1)).to(_comm_device())
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy().reshape(world, *x.shape)


def merge_metric_lists(values, contribute: bool = True) -> np.ndarray:
    """Gather variable-length per-rank metric lists (per-frame overlaps) into
    one flat array on every rank, in rank order. A rank that does not
    ``contribute`` (one that repeats its point group's first rank's frames)
    still enters the gathers, with an empty list.

    Pads to the longest list for the fixed-shape gather, then slices each row
    back to its rank's true length (gathered beside it), so a NaN metric value
    (a degenerate-box IoU) survives the merge instead of being dropped with the
    padding."""
    values = np.asarray(list(values) if contribute else [], np.float64)
    lengths = all_gather_array(np.asarray(np.int64(values.shape[0])))  # (world,)
    max_n = int(lengths.max()) if lengths.size else 0
    padded = np.zeros(max_n)
    padded[: len(values)] = values
    gathered = all_gather_array(padded)  # (world, max_n)
    return np.concatenate(
        [row[: int(k)] for row, k in zip(gathered, np.atleast_1d(lengths))]
    ) if max_n else values


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks. Every rank's result depends on every rank's input,
    so the gradient of an input is the sum of the ranks' output gradients."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks, differentiable: the backward sums the
    ranks' gradients (the gradient of a loss that is the sum of the ranks')."""
    return _AllReduceSum.apply(x)


@torch.no_grad()
def all_reduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the ranks: one all-reduce (SUM,
    then a division by the world size) of one flat buffer."""
    world = get_dist_info()[1]
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat /= world
    offset = 0
    for t in tensors:
        t.copy_(flat[offset: offset + t.numel()].view_as(t))
        offset += t.numel()


@torch.no_grad()
def broadcast_module(module) -> None:
    """Rank 0's parameters and buffers on every rank; nothing with no group."""
    if get_dist_info()[1] == 1:
        return
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=0)
