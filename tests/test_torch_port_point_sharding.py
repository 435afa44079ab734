"""The port's point-axis sharding (POINT_SHARDING) on the CPU: the ranks of a
node as one point group, against one process and the JAX package.

- ``use_point_group`` scopes the group, a group of one splits nothing;
- on two gloo processes every dispatched op (``square_distance``,
  ``ball_query``, ``knn``, ``three_nn``), the 'ffps' distances and centers,
  and the explicit ``parallel/sharded_ops.py`` wrappers give their unsharded
  results bit for bit; the index ops equal the JAX ops under a 2-device
  ``('point',)`` mesh, the distances within the port op tests' 1e-5;
- rows below ``MIN_SHARD_POINTS`` call no gather; rows that do not divide
  warn once per shape and run replicated;
- ``three_nn`` / ``three_interpolate`` against the JAX package's, sharded and
  not;
- ``ptt_synth_ps.yaml`` at the narrow test widths, ``MIN_SHARD_POINTS``
  lowered: the forward of two ranks bit-equal to one process, and within 2e-4
  of the JAX forward on the same weights with equal seed indices;
- ``sharded_vector_attention`` with a port transformer block;
- the test CLI as two processes (one node) and as four (two nodes of two):
  merged Success, Precision and frame count equal to one process's;
- the train CLI on ``ptt_synth_ps.yaml`` as two processes: data-parallel, the
  same checkpoint bit for bit as ``ptt_synth.yaml`` run the same way.

Ranks meet through a ``file://`` store in the test's temporary directory, and
each child has a time limit (``tests/test_torch_port_dist.py`` ``_spawn``), so
a rank that hangs fails its test.
"""

import json
import sys
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.ops import mesh_ctx as jmesh
from ptt_tpu.ops import point_ops as jops
from ptt_tpu_torch.config import config_by_path
from ptt_tpu_torch.convert import state_dict_from_variables
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.nn.sa_module import sample_indices
from ptt_tpu_torch.nn.transformer import TransformerBlock
from ptt_tpu_torch.ops import mesh_ctx, point_ops
from ptt_tpu_torch.tools import test_tracking
from ptt_tpu_torch.train.checkpoint import save_variables_npz
from ptt_tpu_torch.utils import dist
from tests.test_torch_port_cli import _sets
from tests.test_torch_port_dist import REPO, _spawn
from tests.test_torch_port_train import narrow_model_cfg

torch.set_num_threads(1)

WORKER = REPO / "tests" / "_torch_port_point_worker.py"
DIST_TOL = 1e-5  # port distances against JAX's, as tests/test_torch_port_ops.py holds them
JAX_FORWARD_TOL = 2e-4  # module-level port against flax (docs/PARITY.md section 2.1)
MIN_SHARD = 32  # MIN_SHARD_POINTS at the narrow test widths (tests/test_parallel.py lowers it to 64)
B, NQ, NR = 2, 1024, 2048


def _clouds():
    """Query rows above MIN_SHARD_POINTS with repeated points (ties in every
    tie rule), a reference cloud, 'ffps' features, known features."""
    rng = np.random.default_rng(5)
    ref = rng.standard_normal((B, NR, 3)).astype(np.float32)
    query = np.concatenate([ref[:, :NQ // 2], ref[:, rng.permutation(NR)[:NQ // 2]] + 0.01], 1)
    query[:, -4:] = query[:, :4]
    feats = rng.standard_normal((B, NQ, 16)).astype(np.float32)
    known = rng.standard_normal((B, NR, 8)).astype(np.float32)
    return {"query": query, "ref": ref, "feats": feats, "known_feats": known}


def _ps_model_cfg():
    cfg = narrow_model_cfg()
    cfg["POINT_SHARDING"] = dict(config_by_path("tools/cfgs/synthetic_models/ptt_synth_ps.yaml")["MODEL"]
                                 ["POINT_SHARDING"])
    return cfg


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two ranks of the worker under one point group, and what they were given."""
    tmp = tmp_path_factory.mktemp("point_ranks")
    arrays = _clouds()
    rng = np.random.default_rng(9)
    model_cfg = _ps_model_cfg()
    batch = {"search_points": (rng.standard_normal((2, 256, 3)) * [2.0, 1.0, 0.5]).astype(np.float32),
             "template_points": (rng.standard_normal((2, 128, 3)) * [1.0, 0.5, 0.3]).astype(np.float32)}
    jm = jbuild(model_cfg)
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(2), b, train=False))(
        {k: jnp.asarray(v) for k, v in batch.items()}))
    torch.manual_seed(4)
    block_args = {"d_points": 32, "d_model": 64, "k": 8}
    block = TransformerBlock(**block_args)
    inputs = {k: torch.from_numpy(v) for k, v in arrays.items()}
    inputs.update(radius=0.3, model_cfg=model_cfg, model_state=state_dict_from_variables(variables),
                  batch={k: torch.from_numpy(v) for k, v in batch.items()}, block_args=block_args,
                  block_state=block.state_dict(), attn_xyz=torch.from_numpy(arrays["ref"][:, :1024]),
                  attn_feats=torch.from_numpy(rng.standard_normal((B, 1024, 32)).astype(np.float32)))
    torch.save(inputs, tmp / "inputs.pt")
    job = {"dir": str(tmp), "init_method": f"file://{tmp / 'store'}", "min_shard_points": MIN_SHARD}
    (tmp / "job.json").write_text(json.dumps(job))
    _spawn([sys.executable, str(WORKER), str(tmp / "job.json")], tmp)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"outs": outs, "inputs": inputs, "arrays": arrays, "jmodel": jm, "variables": variables, "batch": batch,
            "block": block}


def _unsharded(inputs):
    q, r = inputs["query"], inputs["ref"]
    return {"square_distance": point_ops.square_distance(q, r), "ball_query": point_ops.ball_query(0.3, 16, r, q),
            "knn": point_ops.knn(16, q, r), "three_nn": point_ops.three_nn(q, r),
            "ffps_square_distance": point_ops.square_distance(inputs["feats"], inputs["feats"]),
            "ffps": sample_indices("ffps", q, 64, features=inputs["feats"])}


def _equal(a, b) -> bool:
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_use_point_group_scopes_the_group():
    """``use_point_group`` installs a group for its block only and nests; a
    group of one and no group both read as None; ``set_point_group`` installs
    until cleared; the rows of a rank are its contiguous slice."""
    two = mesh_ctx.PointGroup(None, (4, 5), 1, "pts")
    one = mesh_ctx.PointGroup(None, (3,), 0)
    assert mesh_ctx.get_point_group() is None and mesh_ctx.leads()
    with mesh_ctx.use_point_group(two):
        assert mesh_ctx.get_point_group() is two and not mesh_ctx.leads()
        with mesh_ctx.use_point_group(one):
            assert mesh_ctx.get_point_group() is None and mesh_ctx.leads()
        assert mesh_ctx.get_point_group() is two
    assert mesh_ctx.get_point_group() is None
    mesh_ctx.set_point_group(two)
    try:
        assert mesh_ctx.get_point_group() is two
    finally:
        mesh_ctx.set_point_group(None)
    assert mesh_ctx.get_point_group() is None
    assert two.rows(1024) == slice(512, 1024) and two.size == 2


@pytest.mark.parametrize("op", ["square_distance", "ball_query", "knn", "three_nn", "ffps_square_distance", "ffps"])
def test_two_ranks_equal_the_unsharded_ops(ranks, op):
    """Each rank's gathered result equals the unsharded op bit for bit
    ('ffps' on the CPU only: its distances are a float32 matrix product, whose
    kernel the GPU may choose by the row count)."""
    ref = _unsharded(ranks["inputs"])[op]
    for out in ranks["outs"]:
        assert _equal(out[op], ref), op
    assert ranks["outs"][0]["dispatch_gathers"] == 7  # one a dispatched op, two for three_nn's pair


@pytest.mark.parametrize("op", ["square_distance", "knn", "ball_query"])
def test_explicit_wrappers_equal_the_unsharded_ops(ranks, op):
    ref = _unsharded(ranks["inputs"])[op]
    for out in ranks["outs"]:
        assert torch.equal(out[f"sharded_{op}"], ref)


def test_shard_points_and_replicate(ranks):
    q = ranks["inputs"]["query"]
    for r, out in enumerate(ranks["outs"]):
        assert torch.equal(out["shard_points"], q[:, r * NQ // 2: (r + 1) * NQ // 2])
        assert torch.equal(out["replicate"], torch.zeros(2, 3))  # rank 0's tensor on both


def test_index_ops_equal_jax_under_a_point_mesh(ranks):
    """The two ranks' index ops equal the JAX ops under a 2-device ('point',)
    mesh of the virtual CPU devices, which split the same rows; distances
    within the port op tests' tolerance."""
    a = {k: jnp.asarray(v) for k, v in ranks["arrays"].items()}
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("point",))
    with jmesh.use_point_mesh(mesh):
        ref = {"ball_query": jops.ball_query(0.3, 16, a["ref"], a["query"]), "knn": jops.knn(16, a["query"], a["ref"]),
               "three_nn": jops.three_nn(a["query"], a["ref"]),
               "square_distance": jops.square_distance(a["query"], a["ref"])}
        assert len(ref["knn"].sharding.device_set) == 2
    out = ranks["outs"][1]
    np.testing.assert_array_equal(out["ball_query"].numpy(), np.asarray(ref["ball_query"]))
    np.testing.assert_array_equal(out["knn"].numpy(), np.asarray(ref["knn"]))
    np.testing.assert_array_equal(out["three_nn"][1].numpy(), np.asarray(ref["three_nn"][1]))
    # three_nn's distances are square roots: hold their squares, the distances both packages compute
    np.testing.assert_allclose(out["three_nn"][0].numpy() ** 2, np.asarray(ref["three_nn"][0]) ** 2, rtol=DIST_TOL,
                               atol=DIST_TOL)
    np.testing.assert_allclose(out["square_distance"].numpy(), np.asarray(ref["square_distance"]), rtol=DIST_TOL,
                               atol=DIST_TOL)


def test_three_nn_and_three_interpolate_match_jax(ranks):
    """``three_nn`` (unknown rows split by the ranks, and not) and
    ``three_interpolate`` on the same weights against
    ``ptt_tpu/ops/point_ops.py`` ``three_nn`` / ``three_interpolate``: equal
    indices, squared distances and interpolated features within 1e-5 (a square
    root near 0 magnifies the float32 rounding of the squared distance)."""
    a = ranks["arrays"]
    jd, ji = jops.three_nn(jnp.asarray(a["query"]), jnp.asarray(a["ref"]))
    d, i = point_ops.three_nn(torch.from_numpy(a["query"]), torch.from_numpy(a["ref"]))
    assert i.dtype == torch.int32 and d.shape == (B, NQ, 3)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy() ** 2, np.asarray(jd) ** 2, rtol=DIST_TOL, atol=DIST_TOL)
    w = 1.0 / (d + 1e-8)
    w = w / w.sum(-1, keepdim=True)
    got = point_ops.three_interpolate(torch.from_numpy(a["known_feats"]), i, w)
    ref = jops.three_interpolate(jnp.asarray(a["known_feats"]), ji, jnp.asarray(w.numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=DIST_TOL, atol=DIST_TOL)
    for out in ranks["outs"]:
        assert torch.equal(out["three_interpolate"], got)


def test_small_rows_call_no_gather_and_odd_rows_warn_once(monkeypatch):
    """Below MIN_SHARD_POINTS no gather is called (counted through a stub
    gather); 513 rows over 2 ranks warn once per shape and run replicated;
    1024 rows split."""
    calls = []

    def stub(x, group):
        calls.append(tuple(x.shape))
        return torch.cat([x, x], dim=1)

    monkeypatch.setattr(dist, "all_gather_rows", stub)
    monkeypatch.setattr(point_ops, "_declined_shapes", set())
    rng = np.random.default_rng(1)
    ref = torch.from_numpy(rng.standard_normal((1, 600, 3)).astype(np.float32))
    with mesh_ctx.use_point_group(mesh_ctx.PointGroup(None, (0, 1), 0)):
        for n in (16, 128, 511):
            point_ops.knn(4, ref[:, :n], ref)
            point_ops.ball_query(0.5, 8, ref, ref[:, :n])
            point_ops.square_distance(ref[:, :n], ref)
            point_ops.three_nn(ref[:, :n], ref)
        assert calls == []
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(2):
                out = point_ops.knn(4, ref[:, :513], ref)
            point_ops.ball_query(0.5, 8, ref, ref[:, :513])
        assert calls == []
        assert torch.equal(out, point_ops.knn(4, ref[:, :513], ref))
        assert len(caught) == 1 and "513 rows not divisible by the 2-rank 'point' group" in str(caught[0].message)
        point_ops.knn(4, torch.cat([ref, ref], 1)[:, :1024], ref)
        assert calls == [(1, 512, 4)]


def test_two_ranks_forward_equals_one_process_and_jax(ranks):
    """ptt_synth_ps.yaml at the narrow widths, MIN_SHARD_POINTS 32: the SA
    stages of 128, 64 and 32 search and 64 and 32 template centers and the
    centroid head's kNN split over the two ranks; the forward equals one
    process's bit for bit, and the JAX forward within 2e-4 with equal seed
    indices (JAX's own sharded forward equals its unsharded one:
    tests/test_parallel.py)."""
    model = build_network(ranks["inputs"]["model_cfg"], device="cpu")
    model.load_state_dict(ranks["inputs"]["model_state"], strict=True)
    with torch.no_grad():
        one = model(ranks["inputs"]["batch"])
    for out in ranks["outs"]:
        assert out["forward_gathers"] >= 6
        for key, value in out["forward"].items():
            assert torch.equal(value, one[key]), key
    jo = ranks["jmodel"].apply(ranks["variables"], {k: jnp.asarray(v) for k, v in ranks["batch"].items()},
                               train=False)
    for key in ("search_inds", "template_inds"):
        np.testing.assert_array_equal(one[key].numpy(), np.asarray(jo[key]))
    np.testing.assert_allclose(one["pred_box_data"].numpy(), np.asarray(jo["pred_box_data"]), rtol=JAX_FORWARD_TOL,
                               atol=JAX_FORWARD_TOL)


def test_sharded_vector_attention_equals_the_block(ranks):
    """A port TransformerBlock through ``sharded_vector_attention`` (each rank
    512 of 1024 query points against the whole cloud) against the block on
    the whole cloud: equal indices of its kNN, features within 1e-6 (its
    linear layers multiply 512 rows instead of 1024)."""
    with torch.no_grad():
        ref, _ = ranks["block"](ranks["inputs"]["attn_xyz"], ranks["inputs"]["attn_feats"])
    for out in ranks["outs"]:
        assert out["attention"].shape == ref.shape
        np.testing.assert_allclose(out["attention"].numpy(), ref.numpy(), rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- CLIs

CLI = ("import pathlib, sys; sys.modules['torch.utils.tensorboard'] = None; import torch; torch.set_num_threads(1); "
       "from ptt_tpu_torch.ops import point_ops; point_ops.MIN_SHARD_POINTS = %d; "
       "from ptt_tpu_torch.tools import {0} as cli; cli.OUTPUT_ROOT = pathlib.Path(sys.argv[1]); "
       "sys.exit(cli.main(sys.argv[2:]))" % MIN_SHARD)
PS = "tools/cfgs/synthetic_models/ptt_synth_ps.yaml"


def _narrow_sets(cfg_file, tracklets):
    base = config_by_path(cfg_file)
    return _sets(base["MODEL"], narrow_model_cfg(), "MODEL.") + [
        "DATA_CONFIG.SEARCH_INPUT_SIZE", "256", "DATA_CONFIG.TEMPLATE_INPUT_SIZE", "128",
        "DATA_CONFIG.NUM_TRACKLETS", str(tracklets), "DATA_CONFIG.FRAMES_PER_TRACKLET", "4",
        "DATA_CONFIG.NUM_CANDIDATES_PERFRAME", "1", "TRAIN.WITH_EVAL.ENABLE", "False"]


def _ranks_flags(tmp_path, store):
    return ["--device", "cpu", "--launcher", "pytorch", "--dist_backend", "gloo", "--init_method",
            f"file://{tmp_path / store}", "--workers", "0"]


def _eval_record(run_dir):
    text = "".join(p.read_text() for p in sorted(Path(run_dir).glob("log_eval_*.txt")))
    records = [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]
    frames = [int(line.split("(", 1)[1].split(" frames")[0]) for line in text.splitlines()
              if "[device eval] epoch" in line]
    assert len(records) == 1 and len(frames) == 1, text[-2000:]
    return records[0], frames[0], text


@pytest.mark.parametrize("world,local", [(2, 2), (4, 2)], ids=["one_node_of_2", "two_nodes_of_2"])
def test_test_cli_point_groups_merge_as_one_process(tmp_path, monkeypatch, world, local):
    """ptt_synth_ps.yaml's test CLI at the narrow size, 3 tracklets, one a
    dispatch: as ``world`` ranks in nodes of ``local`` (a point group a node,
    the tracklets sharded over the nodes), the merged Success, Precision and
    frame count equal one process's; each node's first rank writes its result
    file (one node: equal to one process's file line for line); the group's
    gathers are counted and the graph mode logged."""
    torch.manual_seed(0)
    save_variables_npz(tmp_path / "init.npz", build_network(narrow_model_cfg(), device="cpu"))
    sets = _narrow_sets(PS, 3)
    flags = ["--cfg_file", PS, "--max_points", "1024", "--batch_size", "1", "--ckpt", str(tmp_path / "init.npz")]
    monkeypatch.setattr(test_tracking, "OUTPUT_ROOT", tmp_path / "one")
    assert test_tracking.main(flags + ["--device", "cpu", "--set", *sets]) == 0
    run = Path("synthetic_models") / "ptt_synth_ps" / "default" / "eval" / "default"
    one, one_frames, _ = _eval_record(tmp_path / "one" / run)

    _spawn([sys.executable, "-c", CLI.format("test_tracking"), str(tmp_path / "out"), *flags,
            *_ranks_flags(tmp_path, "store"), "--set", *sets], tmp_path, world, local)
    rec, frames, text = _eval_record(tmp_path / "out" / run)
    assert (rec["success"], rec["precision"], frames) == (one["success"], one["precision"], one_frames)
    assert frames == 12 and rec["world_size"] == world
    assert "POINT_SHARDING on: point axis 'point' sharded over the 2 ranks of a node" in text
    assert "[device eval] graph: off (CPU: the eager loop)" in text
    group = rec["point_group"]
    assert group["ranks"] == local and group["shards"] == world // local and group["gathers"] > 0
    assert rec["graph"] == "off (CPU: the eager loop)"
    data = tmp_path / "out" / run / "final_result" / "data"
    files = sorted(p.name for p in data.iterdir())
    assert files == [f"track_result.rank{r}.txt" for r in range(0, world, local)]
    lines = [(data / name).read_text().splitlines() for name in files]
    assert sum(len(x) for x in lines) == 12
    if world == local:
        assert lines[0] == (tmp_path / "one" / run / "final_result" / "data" / "track_result.txt").read_text() \
            .splitlines()


def test_train_cli_point_sharding_trains_data_parallel(tmp_path):
    """ptt_synth_ps.yaml's train CLI as two gloo ranks (global batch 4, one
    epoch of 3 steps) is accepted, logs that training splits no point axis,
    and saves the checkpoint of ptt_synth.yaml run the same way bit for bit:
    every step, step 0 first, is the data-parallel step."""
    torch.manual_seed(0)
    save_variables_npz(tmp_path / "init.npz", build_network(narrow_model_cfg(), device="cpu"))
    states = {}
    for cfg_file in (PS, "tools/cfgs/synthetic_models/ptt_synth.yaml"):
        tag = Path(cfg_file).stem
        _spawn([sys.executable, "-c", CLI.format("train_tracking"), str(tmp_path / "out"), "--cfg_file", cfg_file,
                "--batch_size", "4", "--epochs", "1", "--pretrained_model", str(tmp_path / "init.npz"),
                *_ranks_flags(tmp_path, f"store_{tag}"), "--set", *_narrow_sets(cfg_file, 3)], tmp_path)
        run = tmp_path / "out" / "synthetic_models" / tag / "default"
        text = "".join(p.read_text() for p in run.glob("log_train_*.txt"))
        assert ("POINT_SHARDING: training splits no point axis" in text) == (cfg_file == PS)
        rec = [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]
        assert rec[-1]["steps"] == [0, 3] and rec[-1]["world_size"] == 2
        states[tag] = torch.load(run / "ckpt" / "checkpoint_epoch_1.pth", weights_only=False)
    model_a, model_b = states["ptt_synth_ps"]["model"], states["ptt_synth"]["model"]
    assert set(model_a) == set(model_b) and all(torch.equal(model_a[k], model_b[k]) for k in model_a)
