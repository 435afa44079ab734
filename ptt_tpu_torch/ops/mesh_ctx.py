"""Point-axis context (the point-mesh half of the JAX package's
``ops/mesh_ctx.py``): for Waymo-scale clouds the POINT dimension is the axis
to split. A point group installed here makes ``point_ops.square_distance`` /
``knn`` / ``ball_query`` / ``three_nn`` and the SA kernel (``ops/sa.py``)
split their query or center rows over the ranks of the group: each rank
computes its contiguous slice of the rows against the full cloud, which every
rank of the group holds, and the slices are gathered along dim 1 in rank
order. No collective runs inside an op; the gather is the only communication.

The JAX package splits over the local devices of one process (a ``('point',)``
mesh); the port has one process a GPU, so its counterpart is the ranks of one
node (``utils/dist.py`` ``point_groups``). Installed by the entry point that
owns the group (``tools/test_tracking.py`` for POINT_SHARDING configurations),
read by the ops at each call, as the JAX ops read the mesh at trace time.

The batch-axis half of the JAX module (``set_mesh`` / ``use_mesh`` /
``shard_batched``) has no counterpart, for the reason its own docstring gives:
the reference's CUDA kernels "run under torch DDP's one-process-per-GPU
model, where every kernel is single-device by construction"; so do the port's.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass

from ..utils import timer


@dataclass(frozen=True)
class PointGroup:
    """The ranks a point axis is split over: ``group`` is their
    ``torch.distributed`` process group, ``ranks`` their global ranks in row
    order (rank ``ranks[i]`` computes row slice i), ``index`` this process's
    place in ``ranks``. ``axis`` is a label, the configuration's AXIS."""

    group: object
    ranks: tuple
    index: int
    axis: str = "point"

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rows(self, n: int) -> slice:
        """This rank's slice of ``n`` rows (``n`` divisible by the size)."""
        per = n // self.size
        return slice(self.index * per, (self.index + 1) * per)


# A ContextVar (not a module global), as in the JAX package: two threads each
# see only the group they scoped.
_POINT_CTX: contextvars.ContextVar[PointGroup | None] = contextvars.ContextVar("ptt_tpu_torch_point_group",
                                                                                default=None)


def set_point_group(group: PointGroup | None) -> None:
    """Install the group the point-axis ops split over (None clears)."""
    _POINT_CTX.set(group)


def get_point_group() -> PointGroup | None:
    """The installed group if it has more than one rank, else None: a group
    of one splits nothing."""
    group = _POINT_CTX.get()
    return group if group is not None and group.size > 1 else None


@contextlib.contextmanager
def use_point_group(group: PointGroup | None):
    token = _POINT_CTX.set(group)
    try:
        yield
    finally:
        _POINT_CTX.reset(token)


def leads(group: PointGroup | None = None) -> bool:
    """Whether this process speaks for its point group (its first rank, or
    any process without a group): the one that writes results and whose
    frames count in a metric merge."""
    group = get_point_group() if group is None else group
    return group is None or group.index == 0


def check_same_data(arrays, what: str) -> None:
    """Under a point group, raises unless every rank of it holds the same
    numpy ``arrays`` (by shape and CRC-32): a rank whose rows differ would
    split where another does not, and the ranks would wait on each other's
    gathers for ever."""
    group = get_point_group()
    if group is None:
        return
    import zlib

    import numpy as np

    from ..utils import dist

    arrays = [np.ascontiguousarray(a) for a in arrays]
    if not dist.all_equal([zlib.crc32(a) for a in arrays] + [n for a in arrays for n in a.shape], group.group):
        raise RuntimeError(f"the ranks {list(group.ranks)} of a point group hold different {what}: each rank of a "
                           "group must hold the same clouds")


def gather_rows(x, group: PointGroup):
    """The group's row slices of ``x`` gathered along dim 1 (``utils/dist.py``
    ``all_gather_rows``), counted in ``mesh.gathers`` and, with this rank's
    slice, ``mesh.gathered_bytes``."""
    from ..utils import dist

    out = dist.all_gather_rows(x, group.group)
    timer.count("mesh.gathers")
    timer.count("mesh.gathered_bytes", out.numel() * out.element_size())
    return out


def shard_pointwise(fn, group: PointGroup, n_sharded: int, n_replicated: int, n_out: int = 1):
    """``fn`` for row-independent point ops, split over ``group``: the first
    ``n_sharded`` arguments are cut to this rank's rows of dim 1 (the point or
    center axis), the next ``n_replicated`` (the reference clouds) are passed
    whole, and every output (``n_out`` > 1 for a tuple, e.g. three_nn's
    (dist, idx)) is gathered along dim 1. The row count must divide by the
    group's size (the dispatch in ``point_ops`` makes sure of it)."""

    def run(*args):
        rows = group.rows(args[0].shape[1])
        local = [a[:, rows] for a in args[:n_sharded]] + list(args[n_sharded:n_sharded + n_replicated])
        out = fn(*local)
        if n_out == 1:
            return gather_rows(out, group)
        return tuple(gather_rows(o, group) for o in out)

    return run
