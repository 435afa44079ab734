"""One rank of a point-sharded run of the port on the CPU, for
``tests/test_torch_port_point_sharding.py`` (run as a subprocess, gloo backend):

    RANK=r WORLD_SIZE=w LOCAL_WORLD_SIZE=w python tests/_torch_port_point_worker.py JOB.json

The job file names a directory that holds ``inputs.pt`` (the clouds, the
model's configuration and state dict, a transformer block's state dict) and
receives ``rank{r}.pt``. Every rank installs its node's point group
(``utils/dist.py`` ``point_groups``) and computes, under it:

- the dispatched ops (``square_distance`` of points and of 'ffps' features,
  ``ball_query``, ``knn``, ``three_nn`` and ``three_interpolate`` on its
  weights) on clouds whose rows clear ``MIN_SHARD_POINTS``, the explicit
  ``parallel/sharded_ops.py`` wrappers on the same clouds, and 'ffps' center
  sampling;
- the narrowed model's eval forward with ``MIN_SHARD_POINTS`` lowered to the
  job's, so that its SA stages and kNN split;
- ``sharded_vector_attention`` with the block's shard computation.

Each result goes into ``rank{r}.pt`` with the gathers it took. Imports torch
and the port only.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
torch.set_num_threads(1)


def block_shard(block):
    """``TransformerBlock.forward`` of one rank's query points against the
    whole cloud: the ``apply_fn`` of ``sharded_vector_attention``."""
    from ptt_tpu_torch.nn.transformer import _attend
    from ptt_tpu_torch.ops.point_ops import group_points

    def apply(xyz_s, feats_s, xyz_f, feats_f, idx):
        x_full = block.fc1(feats_f)
        q = block.w_qs(block.fc1(feats_s))
        k = group_points(block.w_ks(x_full), idx)
        v = group_points(block.w_vs(x_full), idx)
        pos_enc = block.fc_delta(xyz_s[:, :, None] - group_points(xyz_f, idx))
        _, res = _attend(block.fc_gamma(q[:, :, None] - k + pos_enc), v + pos_enc, block.d_model)
        return block.fc2(res) + feats_s

    return apply


def run(job, rank, group):
    from ptt_tpu_torch.nn import build_network
    from ptt_tpu_torch.nn.sa_module import sample_indices
    from ptt_tpu_torch.nn.transformer import TransformerBlock
    from ptt_tpu_torch.ops import mesh_ctx, point_ops
    from ptt_tpu_torch.parallel import sharded_ops
    from ptt_tpu_torch.utils import timer

    inp = torch.load(os.path.join(job["dir"], "inputs.pt"), weights_only=False)
    q, r, feats = inp["query"], inp["ref"], inp["feats"]
    out = {}
    with mesh_ctx.use_point_group(group):
        before = timer.counter("mesh.gathers")
        out["square_distance"] = point_ops.square_distance(q, r)
        out["ball_query"] = point_ops.ball_query(inp["radius"], 16, r, q)
        out["knn"] = point_ops.knn(16, q, r)
        out["three_nn"] = point_ops.three_nn(q, r)
        dist, idx = out["three_nn"]
        weight = 1.0 / (dist + 1e-8)
        weight = weight / weight.sum(-1, keepdim=True)
        out["three_interpolate"] = point_ops.three_interpolate(inp["known_feats"], idx, weight)
        out["ffps_square_distance"] = point_ops.square_distance(feats, feats)
        out["ffps"] = sample_indices("ffps", q, 64, features=feats)
        out["dispatch_gathers"] = timer.counter("mesh.gathers") - before
        out["sharded_square_distance"] = sharded_ops.sharded_square_distance(q, r, group)
        out["sharded_knn"] = sharded_ops.sharded_knn(16, q, r, group)
        out["sharded_ball_query"] = sharded_ops.sharded_ball_query(inp["radius"], 16, r, q, group)
        out["shard_points"] = sharded_ops.shard_points(q, group)
        mine = torch.full((2, 3), float(rank))
        out["replicate"] = sharded_ops.replicate(mine, group)

        block = TransformerBlock(**inp["block_args"])
        block.load_state_dict(inp["block_state"])
        with torch.no_grad():
            out["attention"] = sharded_ops.sharded_vector_attention(block_shard(block), inp["attn_xyz"],
                                                                    inp["attn_feats"], group,
                                                                    k=inp["block_args"]["k"])

        point_ops.MIN_SHARD_POINTS = job["min_shard_points"]
        model = build_network(inp["model_cfg"], device="cpu")
        model.load_state_dict(inp["model_state"], strict=True)
        before = timer.counter("mesh.gathers")
        with torch.no_grad():
            pred = model(inp["batch"])
        out["forward"] = {k: pred[k] for k in ("pred_box_data", "search_inds", "template_inds")}
        out["forward_gathers"] = timer.counter("mesh.gathers") - before
    return out


def main():
    with open(sys.argv[1]) as f:
        job = json.load(f)
    from ptt_tpu_torch.ops.mesh_ctx import PointGroup
    from ptt_tpu_torch.utils.dist import init_distributed, point_groups

    rank, _, _ = init_distributed("gloo", job["init_method"], "cpu")
    try:
        handle, ranks = point_groups()
        out = run(job, rank, PointGroup(handle, tuple(ranks), ranks.index(rank)))
        torch.save(out, os.path.join(job["dir"], f"rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
