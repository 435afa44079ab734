"""One rank of a data-parallel run of the port on the CPU, for
``tests/test_torch_port_dist.py`` (run as a subprocess, gloo backend):

    RANK=r WORLD_SIZE=w python tests/_torch_port_dist_worker.py JOB.json

The job file names the work and a directory that holds its inputs and
receives ``rank{r}.pt``:

- ``train``: the narrowed model from ``init.pt``, ``steps`` train steps on this
  rank's shard (``[rank::world]``, the loader's rule) of each global batch of
  ``batches.pt``; saves the metrics and the state after each step.
- ``track``: the device tracker (``eval_one_epoch_device``) on this rank's
  shard of the synthetic test tracklets of ``data_cfg``; saves the merged
  Success and Precision and this rank's per-frame overlap and accuracy lists.

Imports torch and the port only.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)


def train(job, rank, world):
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.train.optim import Optimizer
    from ptt_tpu_torch.train.train_step import make_train_step
    from ptt_tpu_torch.utils.dist import broadcast_module

    model = build_network(job["model_cfg"], device="cpu", train=True)
    if rank == 0:  # the other ranks start from their own init and receive rank 0's
        model.load_state_dict(torch.load(os.path.join(job["dir"], "init.pt"), weights_only=True))
    broadcast_module(model)
    opt = Optimizer(model.parameters(), job["optim_cfg"], iters_per_epoch=3)
    step = make_train_step(job["model_cfg"], device="cpu")
    batches = torch.load(os.path.join(job["dir"], "batches.pt"), weights_only=False)
    metrics, states = [], []
    for batch in batches[: job["steps"]]:
        shard = {k: v[rank::world] for k, v in batch.items()}
        metrics.append({k: float(v) for k, v in step(model, opt, shard).items()})
        states.append({k: v.clone() for k, v in model.state_dict().items()})
    return {"metrics": metrics, "states": states}


def track(job, rank, world):
    from ptt_tpu_torch.data.loader import DataLoader, identity_collate
    from ptt_tpu_torch.data.synthetic import make_tracklets
    from ptt_tpu_torch.eval import device_loop
    from ptt_tpu_torch.nn import build_network

    model = build_network(job["cfg"]["MODEL"], device="cpu")
    model.load_state_dict(torch.load(os.path.join(job["dir"], "model.pt"), weights_only=True))
    loader = DataLoader(make_tracklets(job["data_cfg"]), batch_size=world, num_shards=world, shard_id=rank,
                        collate_fn=identity_collate, num_workers=1)
    lists = []
    merged = device_loop.merged_main_metrics

    def recording(evaluator):
        lists.append((list(evaluator.Success_main.overlaps), list(evaluator.Precision_main.accuracies)))
        return merged(evaluator)

    device_loop.merged_main_metrics = recording
    succ, prec, _ = device_loop.eval_one_epoch_device(job["cfg"], model, loader, max_points=1024, batch_size=2,
                                                      result_dir=job["dir"], device="cpu")
    return {"success": succ, "precision": prec, "overlaps": lists[0][0], "accuracies": lists[0][1]}


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    from ptt_tpu_torch.utils.dist import get_dist_info, init_distributed

    rank, world, _ = init_distributed("gloo", job["init_method"], "cpu")
    assert get_dist_info() == (rank, world)
    try:
        out = {"train": train, "track": track}[job["job"]](job, rank, world)
        torch.save(out, os.path.join(job["dir"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
