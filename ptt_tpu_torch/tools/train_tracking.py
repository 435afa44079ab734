"""Train CLI (the JAX package's ``tools/train_tracking.py``):

    python3 -m ptt_tpu_torch.tools.train_tracking --cfg_file tools/cfgs/kitti_models/ptt.yaml \
        [--epochs N] [--batch_size B] [--pretrained_model FILE] [--ckpt FILE] [--set KEY VALUE ...]

The same flags and output layout, ``output/<exp_group>/<tag>/<extra_tag>/
{ckpt,tensorboard}``, on one GPU (``--device``, default ``cuda``). A run resumes
from the newest checkpoint of its directory, or from ``--ckpt``;
``--pretrained_model`` loads the weights of any file ``load_params_from_file``
reads, those of the model's shapes only. With TRAIN.WITH_EVAL the device tracker
scores the test split after each epoch from START_EPOCH, every INTERVAL epochs.

Data parallelism, one process per GPU:

    torchrun --nproc_per_node 8 -m ptt_tpu_torch.tools.train_tracking --launcher pytorch --cfg_file ...

Each rank loads its shard of every global batch of ``--batch_size`` (default
BATCH_SIZE_PER_GPU, the global batch as in the JAX CLI), which the world size
must divide; BatchNorm statistics, loss denominators and the gradient are the
global batch's (``train/train_step.py``), so ``--sync_bn`` changes nothing and
is accepted as in the JAX CLI. TRAIN.WITH_EVAL shards the test tracklets over
the ranks and merges the metrics. Rank 0 logs, writes tensorboard and saves.
``--dist_backend`` is nccl (a GPU a rank) unless gloo is named. A
MODEL.POINT_SHARDING configuration trains data-parallel over every rank, as
the JAX train CLI (which installs no point mesh), and logs one line that says so.
"""

from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

OUTPUT_ROOT = Path(__file__).resolve().parents[2] / "output"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="train the PTT tracker on one GPU, or one process per GPU")
    parser.add_argument("--cfg_file", type=str, default="tools/cfgs/kitti_models/ptt.yaml",
                        help="config for training, by its tools/cfgs/ path")
    parser.add_argument("--batch_size", type=int, default=None,
                        help="global batch size, split over the ranks (default BATCH_SIZE_PER_GPU)")
    parser.add_argument("--epochs", type=int, default=None, help="number of epochs to train for")
    parser.add_argument("--workers", type=int, default=4,
                        help="the loader's worker processes (0: items built in this process)")
    parser.add_argument("--extra_tag", type=str, default="default", help="extra tag for this experiment")
    parser.add_argument("--ckpt", type=str, default=None, help="training checkpoint to resume from")
    parser.add_argument("--pretrained_model", type=str, default=None,
                        help="weights to start from, shape-checked and partial")
    parser.add_argument("--sync_bn", action="store_true", default=False,
                        help="accepted for the reference's flags; BatchNorm statistics are always the global batch's")
    parser.add_argument("--fix_random_seed", action="store_true", default=True)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt_save_interval", type=int, default=1)
    parser.add_argument("--max_ckpt_save_num", type=int, default=30)
    parser.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--set", dest="set_cfgs", default=None, nargs=argparse.REMAINDER,
                        help="set extra config keys if needed")
    from . import add_launcher_args

    add_launcher_args(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import cli_config
    from . import launch

    cfg = cli_config(args.cfg_file, args.set_cfgs)
    return launch(args, lambda rank, world: train(args, cfg, rank, world))


def train(args, cfg: dict, rank: int, world: int) -> int:
    """The run of ``main``, as rank ``rank`` of ``world`` processes."""
    from .. import resolve_device
    from ..config import check_ported, log_config_to_file, point_sharding_note
    from ..data.loader import build_dataloader
    from ..eval.device_loop import eval_one_epoch_device
    from ..nn import build_network
    from ..train.checkpoint import load_params_from_file, resolve_checkpoint_path
    from ..train.trainer import Trainer
    from ..utils.common import create_logger, set_manual_seed
    from . import build_counts, describe_process, kernel_launches, summary_line

    check_ported(cfg, training=True)
    device = resolve_device(args.device)
    if args.fix_random_seed:
        set_manual_seed(args.seed)
    output_dir = OUTPUT_ROOT / cfg["EXP_GROUP_PATH"] / cfg["TAG"] / args.extra_tag
    output_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(output_dir / f"log_train_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt", rank=rank)
    logger.info("**********************Start logging**********************")
    logger.info(describe_process(device, args, rank, world))
    if args.sync_bn:
        logger.info("--sync_bn: a no-op, BatchNorm statistics are always taken over the global batch")
    log_config_to_file(cfg, logger=logger)
    note = point_sharding_note(cfg, training=True)
    if note:
        logger.info(note)

    batch_size = args.batch_size or cfg["OPTIMIZATION"]["BATCH_SIZE_PER_GPU"]
    if args.epochs is not None:
        cfg["OPTIMIZATION"]["NUM_EPOCHS"] = args.epochs
    dataset, train_loader = build_dataloader(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], batch_size,
                                             workers=args.workers, logger=logger, training=True, seed=args.seed,
                                             num_shards=world, shard_id=rank)
    logger.info(f"train dataset: {len(dataset)} samples, {len(train_loader)} iters/epoch of {batch_size}"
                + (f" ({batch_size // world} a rank)" if world > 1 else ""))
    model = build_network(cfg["MODEL"], device=device, train=True)

    tb_writer = None
    if rank == 0:
        try:
            from torch.utils.tensorboard import SummaryWriter

            tb_writer = SummaryWriter(str(output_dir / "tensorboard"))
        except ImportError:
            logger.info("tensorboard unavailable; scalar logging disabled")

    eval_fn, evals = None, {"seconds": 0.0, "launches": dict.fromkeys(kernel_launches(), 0), "results": {}}
    with_eval = cfg.get("TRAIN", {}).get("WITH_EVAL", {})
    if with_eval.get("ENABLE", False):
        # the test tracklets sharded as the test CLI shards them: one a rank of each batch of `world`; in this
        # process, as the test CLI loads them by default (a test item is a whole tracklet already in memory)
        _, test_loader = build_dataloader(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], batch_size=world, workers=0,
                                          logger=logger, training=False, seed=args.seed, num_shards=world,
                                          shard_id=rank)
        start_epoch, interval = int(with_eval.get("START_EPOCH", 0)), int(with_eval.get("INTERVAL", 1))

        def eval_fn(model, epoch):
            if epoch < start_epoch or epoch % interval:
                return {}
            t0, before = time.perf_counter(), kernel_launches()
            succ, prec, fps = eval_one_epoch_device(cfg, model, test_loader, epoch_id=epoch, logger=logger,
                                                    device=device)
            for key, n in kernel_launches().items():
                evals["launches"][key] += n - before[key]
            evals["seconds"] += time.perf_counter() - t0
            evals["results"][epoch] = {"success": succ, "precision": prec, "frames_per_s": fps}
            return {"succ": succ, "prec": prec, "fps": fps}

    trainer = Trainer(model, cfg["MODEL"], cfg["OPTIMIZATION"], train_loader, output_dir, logger,
                      max_ckpt_save_num=args.max_ckpt_save_num, ckpt_save_interval=args.ckpt_save_interval,
                      tb_writer=tb_writer, eval_fn=eval_fn, device=device)
    if args.pretrained_model:
        load_params_from_file(resolve_checkpoint_path(args.pretrained_model), trainer.model, logger, strict=False)
        logger.info(f"initialized from pretrained model {args.pretrained_model}")
    trainer.resume(resolve_checkpoint_path(args.ckpt) if args.ckpt else None)
    first_epoch, first_iter = trainer.start_epoch, trainer.accumulated_iter

    logger.info("**********************Start training**********************")
    t0, before, built_before = time.perf_counter(), kernel_launches(), build_counts()
    try:
        trainer.train()
    finally:
        train_loader.close()
    seconds = time.perf_counter() - t0
    logger.info("**********************Training done**********************")
    if tb_writer is not None:
        tb_writer.close()
    launches = {key: n - before[key] - evals["launches"][key] for key, n in kernel_launches().items()}
    logger.info(summary_line({
        "epochs": [first_epoch, trainer.total_epochs], "steps": [first_iter, trainer.accumulated_iter],
        "train_seconds": seconds - evals["seconds"], "launches": launches, "eval_launches": evals["launches"],
        **{key: n - built_before[key] for key, n in build_counts().items()},
        "eval": evals["results"], "checkpoints": trainer.ckpt.epochs(), "world_size": world}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
