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
"""

from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

OUTPUT_ROOT = Path(__file__).resolve().parents[2] / "output"
TEST_SEED = 2  # the seed of the reference's test script


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="evaluate PTT tracker checkpoints on one GPU")
    parser.add_argument("--cfg_file", type=str, default="tools/cfgs/kitti_models/ptt.yaml",
                        help="config for eval, by its tools/cfgs/ path")
    parser.add_argument("--batch_size", type=int, default=8, help="tracklets per device dispatch (device tracker)")
    parser.add_argument("--workers", type=int, default=2)
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
    evaluated); give up after ``--max_waiting_mins`` without a new one."""
    from ..train.checkpoint import CheckpointManager

    ckpt_dir = Path(ckpt_dir)
    record_file = Path(result_dir) / "eval_list.txt"
    evaluated = set()
    if record_file.exists():
        evaluated = {int(line.split()[0]) for line in record_file.read_text().splitlines() if line.strip()}
    wait_start = time.time()
    while True:
        epochs = CheckpointManager.epochs_in(ckpt_dir) if ckpt_dir.is_dir() else []
        todo = [e for e in epochs if e not in evaluated and e >= args.start_epoch]
        if not todo:
            if (time.time() - wait_start) / 60 >= args.max_waiting_mins:
                logger.info("max waiting time reached; stopping watcher")
                return
            time.sleep(poll_interval)
            continue
        wait_start = time.time()
        for epoch in todo:
            succ, prec, _ = eval_fn(args, cfg, model, loader, ckpt_dir / f"checkpoint_epoch_{epoch}.pth", logger,
                                    Path(result_dir) / f"epoch_{epoch}", epoch_tag=epoch)
            evaluated.add(epoch)
            with open(record_file, "a") as f:
                f.write(f"{epoch} {succ:.2f} {prec:.2f}\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    from ..config import check_ported, cli_config, log_config_to_file, point_sharding_note

    cfg = cli_config(args.cfg_file, args.set_cfgs)
    check_ported(cfg, training=False)

    from .. import resolve_device
    from ..data.loader import build_dataloader
    from ..nn import build_network
    from ..utils.common import create_logger, set_manual_seed
    from . import describe_device, kernel_launches, summary_line

    device = resolve_device(args.device)
    set_manual_seed(TEST_SEED)
    output_dir = OUTPUT_ROOT / cfg["EXP_GROUP_PATH"] / cfg["TAG"] / args.extra_tag
    result_dir = output_dir / "eval" / args.eval_tag
    result_dir.mkdir(parents=True, exist_ok=True)
    logger = create_logger(result_dir / f"log_eval_{datetime.datetime.now():%Y%m%d-%H%M%S}.txt")
    logger.info(f"device {describe_device(device)}")
    log_config_to_file(cfg, logger=logger)
    if point_sharding_note(cfg):
        logger.info(point_sharding_note(cfg))

    t0 = time.perf_counter()
    _, loader = build_dataloader(cfg["DATA_CONFIG"], cfg["CLASS_NAMES"], batch_size=1, workers=args.workers,
                                 logger=logger, training=False)
    load_seconds = time.perf_counter() - t0
    model = build_network(cfg["MODEL"], device=device)
    before = kernel_launches()
    if args.eval_all:
        repeat_eval_ckpt(args, cfg, model, loader, args.ckpt_dir or output_dir / "ckpt", logger, result_dir)
        record = {}
    else:
        succ, prec, fps = eval_single_ckpt(args, cfg, model, loader, args.ckpt, logger, result_dir)
        record = {"success": succ, "precision": prec, "frames_per_s": fps}
    record.update(dataset_seconds=load_seconds,
                  launches={key: n - before[key] for key, n in kernel_launches().items()})
    logger.info(summary_line(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
