"""Eval CLI (the JAX package's ``tools/test_tracking.py``):

    python3 -m ptt_tpu_torch.tools.test_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml --ckpt FILE
    python3 -m ptt_tpu_torch.tools.test_tracking --cfg_file ... --eval_all [--ckpt_dir DIR]

Tracks every tracklet of the test split with one checkpoint, or watches a
checkpoint directory and evaluates each new ``checkpoint_epoch_<N>.pth`` once
(``--eval_all``), appending ``<N> <Success> <Precision>`` to ``eval_list.txt``.
Results go to ``output/<exp_group>/<tag>/<extra_tag>/eval/<eval_tag>/``.

Two paths: the device tracker (default; tracklets in batches of
``--batch_size``, frames subsampled on the host to ``--max_points``), and
``--host_loop``, the per-frame host evaluator whose crops are the JAX host
loop's.

One process per GPU, as the JAX CLI's ``--launcher jax``:

    torchrun --nproc_per_node 8 -m ptt_tpu_torch.tools.test_tracking --launcher pytorch --ckpt FILE

Rank i tracks tracklet i of each batch of world-size tracklets and writes
``track_result.rank{i}.txt``; Success and Precision are merged over the ranks,
and rank 0 logs them. ``--dist_backend`` is nccl (a GPU a rank) unless gloo is
named.

MODEL.POINT_SHARDING (``ptt_waymo.yaml``) splits the point axis over the ranks
of each node, as the JAX CLI splits it over the local devices of a process:
the ranks of a node form a point group (``utils/dist.py`` ``point_groups``;
torchrun's LOCAL_WORLD_SIZE, or the whole world where it is not set), every
rank of it tracks the node's shard of the tracklets (the loader's batch is the
number of nodes), the large neighbourhood ops and SA stages split their rows
over it (``ops/mesh_ctx.py``), and its first rank writes the node's result
file. The frame step then runs eagerly (``eval/device_loop.py``
``graph_mode``). On one card, as two ranks sharing it:

    torchrun --nproc_per_node 2 -m ptt_tpu_torch.tools.test_tracking --launcher pytorch --dist_backend gloo \
        --device cuda:0 --cfg_file tools/cfgs/kitti_models/ptt_waymo.yaml ...
"""

from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

OUTPUT_ROOT = Path(__file__).resolve().parents[2] / "output"
TEST_SEED = 2  # the seed of the reference's test script


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate PTT tracker checkpoints on one GPU, or one process per GPU")
    parser.add_argument("--cfg_file", type=str, default="tools/cfgs/kitti_models/ptt.yaml",
                        help="config for eval, by its tools/cfgs/ path")
    parser.add_argument("--batch_size", type=int, default=8, help="tracklets per device dispatch (device tracker)")
    parser.add_argument("--workers", type=int, default=0,
                        help="the loader's worker processes; 0 (the default): in this process, since a test "
                             "item is a whole tracklet already in memory, which a worker would only copy")
    parser.add_argument("--extra_tag", type=str, default="default")
    parser.add_argument("--ckpt", type=str, default=None, help="checkpoint file or run directory to evaluate")
    parser.add_argument("--host_loop", action="store_true", default=False,
                        help="use the per-frame host evaluator")
    parser.add_argument("--max_points", type=int, default=16384,
                        help="per-frame point budget of the device tracker")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--max_waiting_mins", type=int, default=120)
    parser.add_argument("--start_epoch", type=int, default=1)
    parser.add_argument("--eval_tag", type=str, default="default")
    parser.add_argument("--eval_all", action="store_true", default=False,
                        help="watch the ckpt dir and evaluate every new checkpoint")
    parser.add_argument("--ckpt_dir", type=str, default=None, help="ckpt dir to watch with --eval_all")
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    from . import add_launcher_args

    add_launcher_args(parser)
    return parser.parse_args(argv)


def eval_single_ckpt(args, cfg, model, loader, ckpt_path, logger, result_dir, epoch_tag="?"):
    """Load ``ckpt_path`` (strict) into ``model`` and track the test split.
    Returns (success, precision, frames per second or None on the host loop)."""
    from ..eval.device_loop import eval_one_epoch_device
    from ..eval.evaluator import eval_one_epoch
    from ..train.checkpoint import load_params_from_file, resolve_checkpoint_path

    if ckpt_path is not None:
        load_params_from_file(resolve_checkpoint_path(ckpt_path), model, logger, strict=True)
    else:
        logger.info("no --ckpt given: evaluating a randomly initialized network")
    from ..ops.mesh_ctx import leads

    if not leads():  # the group's first rank writes the results of the tracklets it shares
        result_dir = None
    if args.host_loop:
        succ, prec = eval_one_epoch(cfg, model, loader, epoch_id=epoch_tag, logger=logger, result_dir=result_dir,
                                    device=args.device)
        return succ, prec, None
    return eval_one_epoch_device(cfg, model, loader, epoch_id=epoch_tag, logger=logger, max_points=args.max_points,
                                 batch_size=args.batch_size, result_dir=result_dir, device=args.device)


def repeat_eval_ckpt(args, cfg, model, loader, ckpt_dir, logger, result_dir, poll_interval: float = 30.0,
                     eval_fn=eval_single_ckpt):
    """Watch ``ckpt_dir`` and evaluate each ``checkpoint_epoch_<N>.pth`` with N >=
    ``--start_epoch`` once, into ``result_dir/epoch_<N>``, appending a line to
    ``result_dir/eval_list.txt`` (which also says, after a restart, what was
    evaluated); give up after ``--max_waiting_mins`` without a new one. In a
    process group every rank evaluates what rank 0 found, and rank 0 writes
    the list."""
    from ..train.checkpoint import CheckpointManager
    from ..utils.dist import get_dist_info

    rank, world = get_dist_info()

    ckpt_dir = Path(ckpt_dir)
    record_file = Path(result_dir) / "eval_list.txt"
    evaluated = set()
    if record_file.exists():
        evaluated = {int(line.split()[0]) for line in record_file.read_text().splitlines() if line.strip()}
    wait_start = time.time()
    while True:
        epochs = CheckpointManager.epochs_in(ckpt_dir) if ckpt_dir.is_dir() else []
        todo = [e for e in epochs if e not in evaluated and e >= args.start_epoch]
        if world > 1:
            import torch.distributed as dist

            found = [todo, (time.time() - wait_start) / 60 >= args.max_waiting_mins]
            dist.broadcast_object_list(found, src=0)
            todo, waited = found
        else:
            waited = (time.time() - wait_start) / 60 >= args.max_waiting_mins
        if not todo:
            if waited:
                logger.info("max waiting time reached; stopping watcher")
                return
            time.sleep(poll_interval)
            continue
        wait_start = time.time()
        for epoch in todo:
            succ, prec, _ = eval_fn(args, cfg, model, loader, ckpt_dir / f"checkpoint_epoch_{epoch}.pth", logger,
                                    Path(result_dir) / f"epoch_{epoch}", epoch_tag=epoch)
            evaluated.add(epoch)
            if rank == 0:
                with open(record_file, "a") as f:
                    f.write(f"{epoch} {succ:.2f} {prec:.2f}\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import cli_config
    from . import launch

    cfg = cli_config(args.cfg_file, args.set_cfgs)
    return launch(args, lambda rank, world: evaluate(args, cfg, rank, world))


def evaluate(args, cfg: dict, rank: int, world: int) -> int:
    """The run of ``main``, as rank ``rank`` of ``world`` processes."""
    from .. import resolve_device
    from ..config import check_ported, log_config_to_file, point_sharding_note
    from ..data.loader import build_dataloader
    from ..eval.device_loop import graph_mode
    from ..nn import build_network
    from ..ops.mesh_ctx import use_point_group
    from ..utils.common import create_logger, set_manual_seed
    from ..utils.dist import data_shard
    from . import build_counts, describe_process, kernel_launches, summary_line

    check_ported(cfg, training=False)
    device = resolve_device(args.device)
    set_manual_seed(TEST_SEED)
    output_dir = OUTPUT_ROOT / cfg["EXP_GROUP_PATH"] / cfg["TAG"] / args.extra_tag
    result_dir = output_dir / "eval" / args.eval_tag
    result_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(result_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt", rank=rank)
    logger.info(describe_process(device, args, rank, world))
    log_config_to_file(cfg, logger=logger)
    group = point_group(cfg, rank, world)
    note = point_sharding_note(cfg, ranks=1 if group is None else group.size)
    if note:
        logger.info(note)
    # each rank tracks its shard: the loader's batch is one tracklet a shard; the ranks of a point group share one
    shard, shards = (rank, world) if group is None else data_shard()

    t0 = time.perf_counter()
    _, loader = build_dataloader(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], batch_size=shards, workers=args.workers,
                                 logger=logger, training=False, num_shards=shards, shard_id=shard)
    load_seconds = time.perf_counter() - t0
    model = build_network(cfg["MODEL"], device=device)
    before, split_before, built_before = kernel_launches(), point_split_counts(), build_counts()
    try:
        with use_point_group(group):
            if args.eval_all:
                repeat_eval_ckpt(args, cfg, model, loader, args.ckpt_dir or output_dir / "ckpt", logger, result_dir)
                record = {}
            else:
                succ, prec, fps = eval_single_ckpt(args, cfg, model, loader, args.ckpt, logger, result_dir)
                record = {"success": succ, "precision": prec, "frames_per_s": fps}
            if not args.host_loop:
                record["graph"] = graph_mode(device)
    finally:
        loader.close()
    record.update(dataset_seconds=load_seconds,
                  launches={key: n - before[key] for key, n in kernel_launches().items()},
                  **{key: n - built_before[key] for key, n in build_counts().items()}, world_size=world)
    if group is not None:
        split = point_split_counts()
        record["point_group"] = {
            "ranks": group.size, "axis": group.axis, "shards": shards,
            "gathers": split["gathers"] - split_before["gathers"],
            "gathered_bytes": split["gathered_bytes"] - split_before["gathered_bytes"],
            "sa_split": {m: n - split_before["sa_split"].get(m, 0) for m, n in split["sa_split"].items()}}
    logger.info(summary_line(record))
    return 0


def point_group(cfg: dict, rank: int, world: int):
    """MODEL.POINT_SHARDING with more than one rank on this node: each node's
    ranks made a process group (every rank makes every group), and this rank's
    as the point group the evaluation installs (``ops/mesh_ctx.py``), as the
    JAX CLI installs a point mesh over a process's local devices; else None."""
    from ..ops.mesh_ctx import PointGroup
    from ..utils.dist import local_world_size, point_groups

    ps = cfg["MODEL"].get("POINT_SHARDING", {})
    if not ps.get("ENABLED", False) or world == 1 or local_world_size() == 1:
        return None
    handle, ranks = point_groups()
    return PointGroup(handle, tuple(ranks), ranks.index(rank), str(ps.get("AXIS", "point")))


def point_split_counts() -> dict:
    """The point-axis counters so far: gathers, the bytes they brought in, and
    the SA launches on a slice of the centers by the stage's center count."""
    from ..utils import timer

    prefix = "launches.sa_split."
    return {"gathers": timer.counter("mesh.gathers"), "gathered_bytes": timer.counter("mesh.gathered_bytes"),
            "sa_split": {int(name[len(prefix):]): n for name, n in timer.counters(prefix).items()}}


if __name__ == "__main__":
    raise SystemExit(main())
