"""The port's data parallelism on the CPU: two gloo processes, against one
process on the global batch and against the JAX package.

- ``merge_metric_lists`` keeps NaNs and ragged lengths (the JAX test's cases,
  the gather stubbed), as the JAX function does;
- the loader's shards: their union is the one-process batch, each is the JAX
  loader's ``num_shards`` shard, and their items are the one-process batch's;
- two ranks train at the narrow test size on a global batch of 4 whose shards
  hold different numbers of positives, so per-rank denominators would give
  other losses; they match the one-process port step and the JAX float64 step
  on the global batch, and each other bit for bit;
- two ranks track with the device tracker: a result file each, and Success
  and Precision merged over the concatenated per-rank lists;
- both CLIs as two processes (``--launcher pytorch --dist_backend gloo``).

Ranks meet through a ``file://`` store in the test's temporary directory, not
a TCP port, and each child process has a time limit, so a rank that hangs
fails its test.
"""

import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ptt_tpu.data.loader import DataLoader as JDataLoader
from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.train.optim import build_optimizer_and_schedule
from ptt_tpu.train.train_state import TrainState
from ptt_tpu.train.train_state import make_train_step as jmake_train_step
from ptt_tpu.utils import dist as jdist
from ptt_tpu_torch.config import config_by_path, ptt_config, ptt_synth_config
from ptt_tpu_torch.convert import state_dict_from_variables, variables_from_state_dict
from ptt_tpu_torch.data.loader import DataLoader
from ptt_tpu_torch.data.synthetic import SyntheticTrackingDataset, make_tracklets
from ptt_tpu_torch.eval.device_loop import eval_one_epoch_device
from ptt_tpu_torch.eval.evaluator import result_file_name
from ptt_tpu_torch.eval.metrics import Precision, Success
from ptt_tpu_torch.nn import build_network, compute_losses
from ptt_tpu_torch.train.checkpoint import save_variables_npz
from ptt_tpu_torch.train.optim import Optimizer
from ptt_tpu_torch.train.train_step import make_train_step, to_device
from ptt_tpu_torch.utils import dist
from ptt_tpu_torch.utils.common import create_logger
from tests.test_torch_port_cli import _sets
from tests.test_torch_port_train import _flat, _rel, narrow_model_cfg, small_data_cfg

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_port_dist_worker.py"
RANK_TIMEOUT = 120  # seconds a run of two ranks may take
RANKS_RTOL = 1e-5  # two ranks against one process on the global batch, relative to each tensor's largest entry


def _spawn(argv, tmp_path, world=2, local=None):
    """Start ``world`` ranks of ``argv`` (a file:// store under ``tmp_path``)
    in nodes of ``local`` ranks (default: one node), wait for them within
    RANK_TIMEOUT, kill any left, and fail with a rank's output unless every
    rank exited 0. Returns the ranks' outputs."""
    local = local or world
    env = dict(os.environ, WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(local), OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(argv, cwd=REPO, env=dict(env, RANK=str(r), LOCAL_RANK=str(r % local)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline, outs = time.monotonic() + RANK_TIMEOUT, []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def _run_worker(job: dict, tmp_path, world=2):
    job = dict(job, dir=str(tmp_path), init_method=f"file://{tmp_path / 'store'}")
    (tmp_path / "job.json").write_text(json.dumps(job))
    _spawn([sys.executable, str(WORKER), str(tmp_path / "job.json")], tmp_path, world)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(world)]


# ------------------------------------------------------------------ helpers


def test_dist_info_and_gather_without_a_group(rng):
    x = rng.standard_normal(5)
    assert dist.get_dist_info() == (0, 1)
    np.testing.assert_array_equal(dist.all_gather_array(x), x[None])
    np.testing.assert_allclose(dist.merge_metric_lists([0.5, 0.75, 1.0]), [0.5, 0.75, 1.0])
    dist.barrier()
    assert result_file_name() == "track_result.txt"
    assert result_file_name(0, 1) == "track_result.txt" and result_file_name(1, 2) == "track_result.rank1.txt"


@pytest.mark.parametrize("rank_lists", [
    [[0.5, 0.75, 1.0]],
    [[0.5, np.nan], [1.0], [0.25, 0.75, np.nan]],
    [[], [0.3, 0.4]],
], ids=["one_rank", "nan_ragged", "empty_rank"])
def test_merge_metric_lists_matches_jax(monkeypatch, rank_lists):
    """NaNs survive and ragged per-rank lists slice back to their lengths,
    the gather stubbed as in the JAX test; the port's merge equals the JAX
    package's on the same gathers."""
    def fake_gather(x):
        x = np.asarray(x)
        if x.ndim == 0:  # the lengths
            return np.asarray([len(h) for h in rank_lists], np.int64)
        out = np.zeros((len(rank_lists), x.shape[0]))
        for i, h in enumerate(rank_lists):
            out[i, : len(h)] = h
        return out

    monkeypatch.setattr(dist, "all_gather_array", fake_gather)
    monkeypatch.setattr(jdist, "all_gather_array", fake_gather)
    merged = dist.merge_metric_lists(rank_lists[0])
    flat = np.asarray([v for h in rank_lists for v in h])
    assert merged.shape == flat.shape
    np.testing.assert_array_equal(np.isnan(merged), np.isnan(flat))
    np.testing.assert_array_equal(merged[~np.isnan(merged)], flat[~np.isnan(flat)])
    np.testing.assert_array_equal(merged, jdist.merge_metric_lists(rank_lists[0]))


def test_rank_logger_logs_errors_only(tmp_path):
    for rank in (0, 1):
        logger = create_logger(tmp_path / f"log{rank}.txt", rank=rank)
        logger.info("info line")
        logger.error("error line")
        for h in logger.handlers:
            h.flush()
    assert "info line" in (tmp_path / "log0.txt").read_text()
    text = (tmp_path / "log1.txt").read_text()
    assert "info line" not in text and "error line" in text


def test_nccl_is_refused_on_the_cpu():
    with pytest.raises(RuntimeError, match="the nccl backend runs on CUDA devices"):
        dist.init_distributed("nccl", device="cpu")
    with pytest.raises(ValueError, match="nccl or gloo"):
        dist.init_distributed("mpi", device="cpu")


# ------------------------------------------------------------------- loader


class _Range:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return {"i": np.asarray(i)}


@pytest.mark.parametrize("n,batch,shuffle,drop_last,world", [
    (23, 4, True, True, 2), (23, 6, True, True, 3), (7, 2, False, False, 2), (5, 3, False, False, 3),
], ids=["train_2", "train_3", "test_2", "test_3_short_last"])
def test_loader_shards_are_the_jax_shards(n, batch, shuffle, drop_last, world):
    """Each shard's indices are the JAX loader's ``num_shards`` shard, and the
    shards of a batch together are the one-process batch."""
    one = DataLoader(_Range(n), batch, shuffle=shuffle, drop_last=drop_last, seed=3)
    shards = [DataLoader(_Range(n), batch, shuffle=shuffle, drop_last=drop_last, seed=3, num_shards=world,
                         shard_id=r) for r in range(world)]
    for epoch in (0, 1):
        for loader in [one] + shards:
            loader.set_epoch(epoch)
        for r, loader in enumerate(shards):
            ref = JDataLoader(_Range(n), batch, shuffle=shuffle, drop_last=drop_last, seed=3, num_shards=world,
                              shard_id=r)
            ref.set_epoch(epoch)
            assert [list(b) for b in loader.batch_indices()] == [list(b) for b in ref._batches_of_indices()]
        for k, full in enumerate(one.batch_indices()):
            got = [s.batch_indices()[k] for s in shards if k < len(s.batch_indices())]
            assert sorted(np.concatenate(got).tolist()) == sorted(full.tolist())
            assert all(np.array_equal(g, full[r::world]) for r, g in enumerate(got))


def test_loader_shard_items_equal_the_one_process_batch():
    """Items are seeded by (seed, index): a shard's arrays are rows [rank::2]
    of the one-process batch; a batch the world does not divide is refused."""
    ds = SyntheticTrackingDataset(small_data_cfg())
    one = next(iter(DataLoader(ds, 4, shuffle=True, drop_last=True, num_workers=1)))
    for r in range(2):
        shard = next(iter(DataLoader(ds, 4, shuffle=True, drop_last=True, num_workers=1, num_shards=2, shard_id=r)))
        for key, value in one.items():
            np.testing.assert_array_equal(shard[key], value[r::2], err_msg=key)
    with pytest.raises(ValueError, match="does not split over 2 processes"):
        DataLoader(ds, 5, shuffle=True, drop_last=True, num_shards=2, shard_id=0)


# ----------------------------------------------------------------- training


def _uneven_batch(model, batch):
    """The global batch with labels set so that the two shards (items 0, 2
    and 1, 3) hold different numbers of positives: shard 0's ground-truth
    centres on a proposal that ``model`` predicts (objectness positives);
    shard 1's every other point label cleared, and item 1's centre 0.45 from
    a proposal (one proposal out of the objectness mask)."""
    batch = {k: v.copy() for k, v in batch.items()}
    with torch.no_grad():
        centers = copy.deepcopy(model)(to_device(batch, "cpu"))["pred_box_center"].numpy()
    for i in (0, 2):
        batch["reg_label"][i, :3] = centers[i, 0]
    batch["reg_label"][1, :3] = centers[1, 0] + np.float32([0.45, 0.0, 0.0])
    for i in (1, 3):
        batch["cls_label"][i, 1::2] = 0.0
    return batch


def _shard_counts(out, batch):
    """Per shard: (positive seeds, positive proposals, proposals in the objectness mask)."""
    cls = torch.gather(torch.as_tensor(batch["cls_label"]), 1, out["search_inds"].long())
    gt = torch.as_tensor(batch["reg_label"])[:, None, :3]
    d = torch.sqrt(((out["pred_box_center"] - gt) ** 2).sum(-1) + 1e-6)
    return [(int(cls[r::2].sum()), int((d < 0.3)[r::2].sum()), int(((d < 0.3) | (d > 0.6))[r::2].sum()))
            for r in range(2)]


def _state_err(got, ref) -> float:
    """max |got - ref| over the largest entry of ``ref``, or over 1 where that
    is smaller: a bias that starts at 0 has moved by ~1e-7 after a step."""
    return float((got.float() - ref.float()).abs().max() / max(float(ref.float().abs().max()), 1.0))


@pytest.mark.parametrize("optimizer", ["adam", "sgd"])
def test_two_ranks_train_as_one_process_on_the_global_batch(tmp_path, optimizer):
    """Two gloo ranks, B = 2 each, take 2 steps on the narrowed model from the
    same weights as one process with B = 4 and as the JAX step in float64,
    with ptt_synth.yaml's optimizer (adam) and with sgd.

    The shards hold different numbers of positives: at step 0, 17 and 13
    positive seeds, 2 and 0 positive proposals, 32 and 31 proposals in the
    objectness mask, and at step 1 different numbers again. The mean of
    per-shard ratios is at least ten times the band below from the global
    ratio for each masked loss (checked), so per-rank denominators would fail
    this test.

    Against one process, within 1e-5: the loss terms and gradient norm of
    step 0, the BatchNorm running statistics after it (``_state_err``); with
    sgd also every metric of step 1 and every parameter and statistic after
    both steps. Adam's first update is g / (|g| + eps), which moves a
    parameter whose float32 gradient is rounding noise (|g| ~ eps: a bias
    before a BatchNorm) by up to ~0.4 lr under any change of summation order
    (the one-process float32 step itself is that far from a float64 one here),
    so with adam the parameters are held to the ranks' bit-equality and to
    the JAX bands. Against JAX in float64: ``test_torch_port_train.py``'s
    lockstep bands (step-0 loss 2e-5, step-1 loss 5e-3, step-0 grad_norm
    1e-4, batch_stats after step 0 1e-4). The two ranks: bit-equal."""
    model_cfg = narrow_model_cfg()
    optim_cfg = dict(ptt_synth_config()["OPTIMIZATION"], OPTIMIZER=optimizer)
    loader = DataLoader(SyntheticTrackingDataset(small_data_cfg()), 4, shuffle=True, drop_last=True, num_workers=1)
    raw = list(loader)[:2]
    jm = jbuild(model_cfg)
    sample = {k: jnp.asarray(raw[0][k]) for k in ("search_points", "template_points")}
    variables = jax.device_get(jax.jit(lambda b: jm.init(jax.random.PRNGKey(3), b, train=False))(sample))
    tm = build_network(model_cfg, device="cpu", train=True)
    tm.load_state_dict(state_dict_from_variables(variables), strict=True)
    torch.save(tm.state_dict(), tmp_path / "init.pt")

    # one process on the global batch, each batch's labels set from the model
    # that takes the step; the model's outputs kept for the counts
    outs, batches = [], []
    opt = Optimizer(tm.parameters(), optim_cfg, iters_per_epoch=3)
    step = make_train_step(model_cfg, device="cpu")
    one_metrics, one_states = [], []
    for batch in raw:
        batches.append(_uneven_batch(tm, batch))
        hook = tm.register_forward_hook(lambda m, i, o: outs.append({k: v.detach() for k, v in o.items()}))
        one_metrics.append({k: float(v) for k, v in step(tm, opt, batches[-1]).items()})
        hook.remove()
        one_states.append({k: v.clone() for k, v in tm.state_dict().items()})
    torch.save(batches, tmp_path / "batches.pt")
    counts = [_shard_counts(o, b) for o, b in zip(outs, batches)]
    assert counts[0] == [(17, 2, 32), (13, 0, 31)], counts
    assert all(a != b for a, b in zip(*counts[1])), counts
    _, full = compute_losses(model_cfg, outs[0], to_device(batches[0], "cpu"))
    per_shard = [compute_losses(model_cfg, {k: v[r::2] for k, v in outs[0].items()},
                                to_device({k: v[r::2] for k, v in batches[0].items()}, "cpu"))[1] for r in range(2)]
    for key in ("centroids_reg_loss", "boxes_cls_loss", "boxes_reg_loss"):
        naive = (float(per_shard[0][key]) + float(per_shard[1][key])) / 2
        assert abs(naive - float(full[key])) > 10 * RANKS_RTOL * abs(float(full[key])), key

    ranks = _run_worker({"job": "train", "model_cfg": model_cfg, "optim_cfg": optim_cfg, "steps": 2}, tmp_path)

    for a, b in zip(ranks[0]["states"], ranks[1]["states"]):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    held = 2 if optimizer == "sgd" else 1
    for got, ref in zip(ranks[0]["metrics"][:held], one_metrics):
        assert set(got) == set(ref)
        for key in ref:
            assert got[key] == pytest.approx(ref[key], rel=RANKS_RTOL), key
    for got, ref in zip(ranks[0]["states"][:held], one_states):
        keys = ref if optimizer == "sgd" else [k for k in ref if "running_" in k]
        for key in keys:
            assert _state_err(got[key], ref[key]) <= RANKS_RTOL, (key, _state_err(got[key], ref[key]))

    tx, _ = build_optimizer_and_schedule(optim_cfg, iters_per_epoch=3, total_epochs=1)
    with jax.enable_x64(True):
        f64 = lambda tree: jax.tree_util.tree_map(lambda x: jnp.asarray(np.asarray(x), jnp.float64), tree)  # noqa: E731
        params = f64(variables["params"])
        state = TrainState(step=jnp.zeros((), jnp.int32), params=params, batch_stats=f64(variables["batch_stats"]),
                           opt_state=tx.init(params), tx=tx, apply_fn=jm.apply)
        jstep = jax.jit(jmake_train_step(model_cfg))
        for i, batch in enumerate(batches):
            state, jmet = jstep(state, f64(batch))
            got = ranks[0]["metrics"][i]
            assert abs(got["loss"] - float(jmet["loss"])) <= (2e-5 if i == 0 else 5e-3) * abs(float(jmet["loss"]))
            if i == 0:
                assert got["grad_norm"] == pytest.approx(float(jmet["grad_norm"]), rel=1e-4)
                jstats = _flat(jax.device_get(state.batch_stats))
                tstats = {k[len("batch_stats/"):]: v for k, v in
                          variables_from_state_dict(ranks[0]["states"][0]).items() if k.startswith("batch_stats/")}
                assert set(tstats) == set(jstats)
                assert max(_rel(tstats[k], jstats[k]) for k in jstats) <= 1e-4


# ----------------------------------------------------------------- tracking


def _narrow_cfg():
    cfg = ptt_config()
    cfg["MODEL"] = narrow_model_cfg()
    cfg["DATA_CONFIG"].update(SEARCH_INPUT_SIZE=256, TEMPLATE_INPUT_SIZE=128)
    return cfg


def _lines(path):
    return Path(path).read_text().splitlines()


def test_two_ranks_track_their_shards_and_merge_the_metrics(tmp_path):
    """3 tracklets over 2 ranks (2 and 1): a result file a rank, each equal
    line for line to one process's run on that rank's shard, and Success and
    Precision, the same on both ranks, equal to the metrics over the
    concatenated per-rank lists."""
    cfg, data_cfg = _narrow_cfg(), {"NUM_TRACKLETS": 3, "FRAMES_PER_TRACKLET": 5, "SYNTH_SEED": 4}
    torch.manual_seed(0)
    model = build_network(cfg["MODEL"], device="cpu")
    torch.save(model.state_dict(), tmp_path / "model.pt")
    ranks = _run_worker({"job": "track", "cfg": cfg, "data_cfg": data_cfg}, tmp_path)

    assert ranks[0]["success"] == ranks[1]["success"] and ranks[0]["precision"] == ranks[1]["precision"]
    s, p = Success(), Precision()
    s.overlaps = ranks[0]["overlaps"] + ranks[1]["overlaps"]
    p.accuracies = ranks[0]["accuracies"] + ranks[1]["accuracies"]
    assert (ranks[0]["success"], ranks[0]["precision"]) == (s.average, p.average)
    assert len(s.overlaps) == 15 and len(ranks[0]["overlaps"]) == 10

    tracklets = make_tracklets(data_cfg)
    for r in range(2):
        rank_file = tmp_path / "final_result" / "data" / f"track_result.rank{r}.txt"
        succ, prec, _ = eval_one_epoch_device(cfg, model, [tracklets[r::2]], max_points=1024, batch_size=2,
                                              result_dir=tmp_path / f"one{r}", device="cpu")
        assert _lines(rank_file) == _lines(tmp_path / f"one{r}" / "final_result" / "data" / "track_result.txt")
        assert len(_lines(rank_file)) == 5 * len(tracklets[r::2])
    assert not (tmp_path / "final_result" / "data" / "track_result.txt").exists()


# --------------------------------------------------------------------- CLIs

CLI = ("import pathlib, sys; sys.modules['torch.utils.tensorboard'] = None; import torch; torch.set_num_threads(1); "
       "from ptt_tpu_torch.tools import {0} as cli; cli.OUTPUT_ROOT = pathlib.Path(sys.argv[1]); "
       "sys.exit(cli.main(sys.argv[2:]))")


def _summary(text):
    return [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line]


@pytest.mark.parametrize("module", ["train_tracking", "test_tracking"])
def test_clis_as_two_processes(tmp_path, module):
    """The CLIs as two gloo ranks on the CPU at the narrow size on synthetic
    tracklets: the train CLI (global batch 4, one epoch of 3 steps,
    TRAIN.WITH_EVAL) saves one checkpoint a run, which the test CLI's
    ``--eval_all`` then scores as two ranks; the test CLI writes a result file
    a rank (3 tracklets: 2 and 1). Rank 0 logs the summary, rank 1 nothing."""
    cfg_file = "tools/cfgs/synthetic_models/ptt_synth.yaml"
    base = config_by_path(cfg_file)
    torch.manual_seed(0)
    model = build_network(narrow_model_cfg(), device="cpu")
    save_variables_npz(tmp_path / "init.npz", model)
    sets = _sets(base["MODEL"], narrow_model_cfg(), "MODEL.") + [
        "DATA_CONFIG.SEARCH_INPUT_SIZE", "256", "DATA_CONFIG.TEMPLATE_INPUT_SIZE", "128",
        "DATA_CONFIG.NUM_TRACKLETS", "3", "DATA_CONFIG.FRAMES_PER_TRACKLET", "4",
        "DATA_CONFIG.NUM_CANDIDATES_PERFRAME", "1", "TRAIN.WITH_EVAL.ENABLE", "True",
        "TRAIN.WITH_EVAL.INTERVAL", "1"]
    def ranks(store):
        return ["--cfg_file", cfg_file, "--device", "cpu", "--launcher", "pytorch", "--dist_backend", "gloo",
                "--init_method", f"file://{tmp_path / store}", "--workers", "1"]

    flags = ranks("store")
    if module == "train_tracking":
        flags += ["--batch_size", "4", "--epochs", "1", "--sync_bn", "--pretrained_model", str(tmp_path / "init.npz")]
    else:
        flags += ["--max_points", "1024", "--batch_size", "2", "--ckpt", str(tmp_path / "init.npz")]
    out = tmp_path / "out"
    _spawn([sys.executable, "-c", CLI.format(module), str(out), *flags, "--set", *sets], tmp_path)

    run = out / "synthetic_models" / "ptt_synth" / "default"
    if module == "train_tracking":
        logs = sorted(run.glob("log_train_*.txt"))
        text = "".join(p.read_text() for p in logs)
        rec = _summary(text)
        assert len(rec) == 1 and rec[0]["world_size"] == 2
        assert rec[0]["steps"] == [0, 3] and rec[0]["checkpoints"] == [1]
        assert list(rec[0]["eval"]) == ["1"] and np.isfinite(rec[0]["eval"]["1"]["success"])
        assert "--sync_bn: a no-op" in text and "process 0/2, backend gloo" in text
        assert "process 1/2" not in text  # rank 1 logs errors only
        assert sorted(p.name for p in (run / "ckpt").iterdir()) == ["checkpoint_epoch_1.pth"]
        assert (run / "ckpt_best.npz").exists()
        # --eval_all as two ranks: every rank evaluates what rank 0 found, rank 0 writes the list
        _spawn([sys.executable, "-c", CLI.format("test_tracking"), str(out), *ranks("store_eval"), "--eval_all",
                "--max_waiting_mins", "0", "--max_points", "1024", "--set", *sets], tmp_path)
        evals = run / "eval" / "default"
        assert [line.split()[0] for line in _lines(evals / "eval_list.txt")] == ["1"]
        data = evals / "epoch_1" / "final_result" / "data"
        assert [len(_lines(data / f"track_result.rank{r}.txt")) for r in range(2)] == [8, 4]
    else:
        evals = run / "eval" / "default"
        rec = _summary("".join(p.read_text() for p in evals.glob("log_eval_*.txt")))
        assert len(rec) == 1 and rec[0]["world_size"] == 2 and np.isfinite(rec[0]["success"])
        data = evals / "final_result" / "data"
        assert sorted(p.name for p in data.iterdir()) == ["track_result.rank0.txt", "track_result.rank1.txt"]
        assert [len(_lines(data / f"track_result.rank{r}.txt")) for r in range(2)] == [8, 4]
