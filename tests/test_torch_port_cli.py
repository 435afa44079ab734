"""The port's command-line path on the CPU, against the JAX package: the config
registry against every YAML of ``tools/cfgs/``, ``--set`` overrides, the
checkpoint watcher, ``test_tracking --host_loop`` against the JAX host
evaluator frame for frame, ``train_tracking`` with resume and ``--eval_all``,
checkpoints in the three layouts ``load_params_from_file`` reads, TEST.SAVE_PCD
in both evaluators, what the CLIs refuse at start-up, and the device tracker's
reseed at every dispatch."""

import glob
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from ptt_tpu.config import cfg_from_list as jcfg_from_list
from ptt_tpu.config import cfg_from_yaml_file
from ptt_tpu.data.kitti import KittiTrackingDataset as JKitti
from ptt_tpu.eval import device_loop as jdl
from ptt_tpu.eval.evaluator import TrackingEvaluator as JTrackingEvaluator
from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.train.checkpoint import save_variables_npz as jsave_npz
from ptt_tpu.utils.torch_converter import save_torch_checkpoint
from ptt_tpu_torch.config import (cfg_from_list, check_ported, cli_config, config_by_path, point_sharding_note,
                                  ptt_config, steps_per_dispatch)
from ptt_tpu_torch.convert import reference_state_dict, state_dict_from_npz
from ptt_tpu_torch.data.kitti import KittiTrackingDataset
from ptt_tpu_torch.data.synthetic import make_tracklets
from ptt_tpu_torch.eval import device_loop as tdl
from ptt_tpu_torch.eval.evaluator import TrackingEvaluator
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.tools import test_tracking, train_tracking
from ptt_tpu_torch.train.checkpoint import load_params_from_file, resolve_checkpoint_path
from ptt_tpu_torch.utils.file_io import read_pcd
from tests.test_kitti_data import make_kitti_tree
from tests.test_nuscenes_data import make_nuscenes_tree
from tests.test_torch_port_train import _perturb, narrow_model_cfg

torch.set_num_threads(1)

YAMLS = sorted(glob.glob("tools/cfgs/*/*.yaml"))


def _plain(x):
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _yaml(path):
    ref = _plain(cfg_from_yaml_file(path))
    ref["OPTIMIZATION"]["EPS"] = float(ref["OPTIMIZATION"]["EPS"])  # the YAML loader keeps "1e-06" as a string
    return ref


# ------------------------------------------------------------------- config


@pytest.mark.parametrize("path", YAMLS)
def test_config_by_path_equals_yaml(path):
    assert config_by_path(path) == _yaml(path)
    assert config_by_path(Path.cwd() / path) == config_by_path(path.split("cfgs/")[1])
    # a fresh dict each time
    config_by_path(path)["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] = 9.0
    assert config_by_path(path)["MODEL"]["BACKBONE_3D"]["SA_CONFIG"]["RADIUS"][0] != 9.0


def test_config_by_path_names_the_known_files():
    assert len(YAMLS) == 11
    with pytest.raises(KeyError) as err:
        config_by_path("tools/cfgs/kitti_models/ptt_tiny.yaml")
    assert all(path in str(err.value) for path in YAMLS)


@pytest.mark.parametrize("pairs", [
    ["OPTIMIZATION.LR", "0.01", "OPTIMIZATION.NUM_EPOCHS", "3", "TRAIN.WITH_EVAL.ENABLE", "True"],
    ["DATA_CONFIG.DATA_PATH", "/data/kitti", "TEST.REF_BOX", "previous_gt"],
    ["MODEL.BACKBONE_3D.SA_CONFIG.RADIUS", "0.2,0.4,0.8", "OPTIMIZATION.BETAS", "(0.9,0.99)"],
    ["MODEL.BACKBONE_3D.SA_CONFIG.MLPS", "[[0,16,16,32],[32,32,32,64],[64,32,32,64]]"],
    ["MODEL.BACKBONE_3D.SA_CONFIG.NSAMPLE", "(16,16,16)"],
    ["DATA_CONFIG.DATA_SPLIT", "test:all,train:TRAIN_TINY", "DATA_CONFIG.INFO_PATH", "test:infos_x.pkl"],
])
def test_cfg_from_list_matches_jax(pairs):
    """Scalars, lists, nested lists and sub-dicts, coerced as the JAX package does."""
    path = "tools/cfgs/kitti_models/ptt.yaml"
    ref = jcfg_from_list(list(pairs), cfg_from_yaml_file(path))
    ref = _plain(ref)
    ref["OPTIMIZATION"]["EPS"] = float(ref["OPTIMIZATION"]["EPS"])
    assert cfg_from_list(list(pairs), config_by_path(path)) == ref


@pytest.mark.parametrize("pairs,error", [
    (["OPTIMIZATION.LR"], ValueError),
    (["OPTIMIZATION.NO_SUCH_KEY", "1"], KeyError),
    (["NO_SECTION.LR", "1"], KeyError),
    (["OPTIMIZATION.LR", "fast"], TypeError),
])
def test_cfg_from_list_errors_match_jax(pairs, error):
    with pytest.raises(error):
        jcfg_from_list(list(pairs), cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml"))
    with pytest.raises(error):
        cfg_from_list(list(pairs), ptt_config())


# ------------------------------------------------------------------ watcher


class Args:
    max_waiting_mins = 0  # give up as soon as there is nothing to evaluate
    start_epoch = 2


class Logger:
    def info(self, *a):
        pass


def _ckpt_files(tmp_path, epochs):
    d = tmp_path / "ckpt"
    d.mkdir(exist_ok=True)
    for e in epochs:
        (d / f"checkpoint_epoch_{e}.pth").write_bytes(b"")
    (d / "checkpoint_epoch_9.pth.123.tmp").write_bytes(b"")  # a save in progress
    return d


def test_watcher_evaluates_new_checkpoints_once(tmp_path):
    ckpt_dir = _ckpt_files(tmp_path, [1, 2, 3, 5])
    result_dir = tmp_path / "eval"
    result_dir.mkdir()
    calls = []

    def fake_eval(args, cfg, model, loader, ckpt_path, logger, rdir, epoch_tag):
        calls.append((ckpt_path.name, rdir.name, epoch_tag))
        return 50.0, 60.0, None

    test_tracking.repeat_eval_ckpt(Args(), None, None, None, ckpt_dir, Logger(), result_dir, poll_interval=0,
                                   eval_fn=fake_eval)
    assert calls == [(f"checkpoint_epoch_{e}.pth", f"epoch_{e}", e) for e in (2, 3, 5)]
    assert (result_dir / "eval_list.txt").read_text() == "2 50.00 60.00\n3 50.00 60.00\n5 50.00 60.00\n"
    _ckpt_files(tmp_path, [6])
    calls.clear()
    test_tracking.repeat_eval_ckpt(Args(), None, None, None, ckpt_dir, Logger(), result_dir, poll_interval=0,
                                   eval_fn=fake_eval)
    assert [c[2] for c in calls] == [6]


def test_watcher_times_out_on_empty_dir(tmp_path):
    result_dir = tmp_path / "eval"
    result_dir.mkdir()
    test_tracking.repeat_eval_ckpt(Args(), None, None, None, _ckpt_files(tmp_path, []), Logger(), result_dir,
                                   poll_interval=0, eval_fn=lambda *a, **k: (0.0, 0.0, None))
    assert not (result_dir / "eval_list.txt").exists()


# ------------------------------------------------------------ the CLIs


def _sets(base: dict, new: dict, prefix: str) -> list:
    """--set pairs that turn ``base`` into ``new``."""
    out = []
    for key, value in new.items():
        if isinstance(value, dict):
            out += _sets(base[key], value, prefix + key + ".")
        elif value != base[key]:
            out += [prefix + key, repr(value).replace(" ", "")]
    return out


@pytest.fixture(scope="module")
def narrow(tmp_path_factory):
    """A 6-frame KITTI scene, the --set list of the narrowed model (search 256,
    template 128 points) on it, both packages' configs with it, and perturbed
    JAX-init weights as a JAX-package .npz."""
    tmp = tmp_path_factory.mktemp("cli")
    make_kitti_tree(tmp / "kitti", n_frames=6)
    sets = _sets(ptt_config()["MODEL"], narrow_model_cfg(), "MODEL.") + [
        "DATA_CONFIG.SEARCH_INPUT_SIZE", "256", "DATA_CONFIG.TEMPLATE_INPUT_SIZE", "128",
        "DATA_CONFIG.DATA_PATH", str(tmp / "kitti"), "DATA_CONFIG.DATA_SPLIT", "test:all"]
    jcfg = jcfg_from_list(list(sets), cfg_from_yaml_file("tools/cfgs/kitti_models/ptt.yaml"))
    cfg = cfg_from_list(list(sets), ptt_config())
    assert cfg["MODEL"] == narrow_model_cfg() == _plain(jcfg.MODEL)
    jm = jbuild(jcfg.MODEL)
    sample = {"search_points": jnp.zeros((1, 256, 3)), "template_points": jnp.zeros((1, 128, 3))}
    variables = _perturb(jax.jit(lambda b: jm.init(jax.random.PRNGKey(5), b, train=False))(sample),
                         np.random.default_rng(5))
    jsave_npz(tmp / "init.npz", variables["params"], variables["batch_stats"])
    return {"tmp": tmp, "sets": sets, "cfg": cfg, "jcfg": jcfg, "jmodel": jm, "variables": variables}


@pytest.fixture
def cli_root(tmp_path, monkeypatch):
    """The CLIs' output root in a temporary directory, and no tensorboard (as on
    the GPU machine; importing it here pulls in TensorFlow)."""
    monkeypatch.setattr(train_tracking, "OUTPUT_ROOT", tmp_path)
    monkeypatch.setattr(test_tracking, "OUTPUT_ROOT", tmp_path)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    return tmp_path


def _results(path):
    rows = [line.split() for line in Path(path).read_text().splitlines()]
    return [tuple(r[:3]) for r in rows], np.array([[float(x) for x in r[3:]] for r in rows])


def test_host_loop_cli_matches_jax_evaluator(narrow, cli_root):
    """``test_tracking --host_loop --device cpu`` with the JAX-init weights:
    every frame's box within 1e-4 of the JAX host evaluator's on the same
    KITTI tracklets, and the same result lines."""
    assert test_tracking.main(["--device", "cpu", "--host_loop", "--ckpt", str(narrow["tmp"] / "init.npz"),
                               "--set", *narrow["sets"]]) == 0
    ours = cli_root / "kitti_models" / "ptt" / "default" / "eval" / "default" / "final_result" / "data"

    ds = JKitti(narrow["jcfg"].DATA_CONFIG, "Car", training=False)
    jev = JTrackingEvaluator(narrow["jcfg"], narrow["jmodel"], narrow["variables"], ds,
                             output_dir=cli_root / "jax")
    for i in range(len(ds)):
        jev.test_tracklet(*ds[i])
    jev.close()
    (ids, got), (ref_ids, ref) = _results(ours / "track_result.txt"), _results(cli_root / "jax" / "track_result.txt")
    assert ids == ref_ids and len(ids) == 6
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)
    assert np.abs(ref[1:] - ref[0]).max() > 0.5  # the car moves and the boxes follow it


def test_train_cli_resume_and_eval_all(narrow, cli_root):
    """Two tiny epochs, a resumed third, then ``--eval_all``: the JAX CLI's
    layout of directories, one checkpoint an epoch, the step count going on,
    and eval_list.txt with a line a checkpoint."""
    sets = narrow["sets"] + ["DATA_CONFIG.DATA_SPLIT", "train:all", "DATA_CONFIG.NUM_CANDIDATES_PERFRAME", "2",
                             "TRAIN.WITH_EVAL.ENABLE", "True", "TRAIN.WITH_EVAL.START_EPOCH", "2"]
    flags = ["--device", "cpu", "--batch_size", "4", "--workers", "2", "--pretrained_model",
             str(narrow["tmp"] / "init.npz")]
    assert train_tracking.main(flags + ["--epochs", "2", "--set", *sets]) == 0
    assert train_tracking.main(flags + ["--epochs", "3", "--set", *sets]) == 0
    run = cli_root / "kitti_models" / "ptt" / "default"
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [f"checkpoint_epoch_{e}.pth" for e in (1, 2, 3)]
    assert (run / "ckpt_best.npz").exists() and len(list(run.glob("log_train_*.txt"))) == 2
    logs = sorted(run.glob("log_train_*.txt"))
    summary = [json.loads(line.split("  summary ", 1)[1]) for line in
               (logs[0].read_text() + logs[1].read_text()).splitlines() if "  summary {" in line]
    assert [s["steps"] for s in summary] == [[0, 6], [6, 9]] and [s["epochs"] for s in summary] == [[0, 2], [2, 3]]
    assert list(summary[0]["eval"]) == ["2"] and list(summary[1]["eval"]) == ["3"]  # WITH_EVAL from epoch 2

    assert test_tracking.main(["--device", "cpu", "--eval_all", "--max_waiting_mins", "0", "--max_points", "1024",
                               "--set", *narrow["sets"]]) == 0
    evals = run / "eval" / "default"
    assert [line.split()[0] for line in (evals / "eval_list.txt").read_text().splitlines()] == ["1", "2", "3"]
    for e in (1, 2, 3):
        assert len((evals / f"epoch_{e}" / "final_result" / "data" / "track_result.txt").read_text().splitlines()) == 6


@pytest.mark.parametrize("case", ["point_sharding_over_2_devices", "sync_bn", "fps_beyond_8192"])
def test_clis_refuse_unported_features_at_start(cli_root, case):
    """What the port does not run is refused before a dataset is read: clouds
    beyond the kernels' largest forms, and NCCL ranks on the CPU. POINT_SHARDING
    over more than one GPU is accepted, with its note for the ranks of a node,
    and ``--sync_bn`` is accepted. (Everything else of tools/cfgs/ runs: the
    tests below.)"""
    if case == "point_sharding_over_2_devices":
        cfg = config_by_path("tools/cfgs/synthetic_models/ptt_synth_ps.yaml")
        check_ported(cfg, training=False)
        assert point_sharding_note(cfg, ranks=2) == "POINT_SHARDING on: point axis 'point' sharded over the 2 ranks " \
                                                    "of a node"
    elif case == "sync_bn":
        # --sync_bn is accepted (BatchNorm statistics are always the global batch's): the CLI
        # gets past its checks to the data; NCCL ranks on the CPU are what is refused
        with pytest.raises(FileNotFoundError, match="/no/such/dir"):
            train_tracking.main(["--device", "cpu", "--sync_bn", "--set", "DATA_CONFIG.DATA_PATH", "/no/such/dir"])
        assert "--sync_bn: a no-op" in _log(cli_root / "kitti_models" / "ptt" / "default", "log_train_*.txt")
        with pytest.raises(RuntimeError, match="the nccl backend runs on CUDA devices"):
            train_tracking.main(["--device", "cpu", "--launcher", "pytorch", "--set", "DATA_CONFIG.DATA_PATH",
                                 "/no/such/dir"])
    else:
        with pytest.raises(NotImplementedError, match="the FPS kernel takes at most 8192"):
            test_tracking.main(["--device", "cpu", "--set", "DATA_CONFIG.DATA_PATH", "/no/such/dir",
                                "DATA_CONFIG.SEARCH_INPUT_SIZE", "16384"])


SYNTH_SETS = ["DATA_CONFIG.NUM_TRACKLETS", "2", "DATA_CONFIG.FRAMES_PER_TRACKLET", "4",
              "DATA_CONFIG.NUM_CANDIDATES_PERFRAME", "1", "TRAIN.WITH_EVAL.ENABLE", "False"]


def _log(run_dir, pattern):
    return "".join(p.read_text() for p in sorted(Path(run_dir).glob(pattern)))


def _summary(text):
    return [json.loads(line.split("  summary ", 1)[1]) for line in text.splitlines() if "  summary {" in line][-1]


@pytest.mark.parametrize("k", [4, 0, 2.5])
def test_steps_per_dispatch_runs_as_single_steps_or_is_refused(narrow, cli_root, k):
    """OPTIMIZATION.STEPS_PER_DISPATCH = K > 1 (the JAX trainer's K-step scan)
    runs K steps a dispatch, and the train CLI logs the JAX trainer's line for
    it once, and once how the step runs (on the CPU, eagerly); K < 1 and a K
    that is not an integer are refused before training."""
    if k == 2.5:  # --set keeps a key's type, so a float K comes from a config file
        with pytest.raises(ValueError, match="STEPS_PER_DISPATCH must be an integer >= 1, not 2.5"):
            steps_per_dispatch({"STEPS_PER_DISPATCH": k})
        return
    sets = narrow["sets"] + ["DATA_CONFIG.DATA_SPLIT", "train:all", "OPTIMIZATION.STEPS_PER_DISPATCH", str(k)]
    flags = ["--device", "cpu", "--batch_size", "4", "--workers", "0", "--epochs", "1", "--set", *sets]
    run = cli_root / "kitti_models" / "ptt" / "default"
    if k == 0:
        with pytest.raises(ValueError, match="STEPS_PER_DISPATCH must be an integer >= 1, not 0"):
            train_tracking.main(flags)
        assert not (run / "ckpt").exists() or not list((run / "ckpt").iterdir())
        return
    assert train_tracking.main(flags) == 0
    text = _log(run, "log_train_*.txt")
    lines = [line for line in text.splitlines() if "steps_per_dispatch=" in line]
    assert len(lines) == 1 and lines[0].endswith("steps_per_dispatch=4 (K-step CUDA graph per dispatch)")
    graph = [line for line in text.splitlines() if "graph: " in line]
    assert len(graph) == 1 and graph[0].endswith("graph: off (CPU: the eager step)")
    summary = _summary(text)
    assert summary["steps"] == [0, 6] and summary["checkpoints"] == [1]  # 6 frames x 4 candidates / 4


def test_steps_per_dispatch_over_an_odd_step_count(narrow, cli_root):
    """The train CLI at STEPS_PER_DISPATCH = 2 over 3 steps (one dispatch of 2,
    the tail through the one-step body) counts 3 steps and saves the
    checkpoint of the same run at K = 1 bit for bit."""
    states = {}
    for k in (2, 1):
        sets = narrow["sets"] + ["DATA_CONFIG.DATA_SPLIT", "train:all", "OPTIMIZATION.STEPS_PER_DISPATCH", str(k)]
        assert train_tracking.main(["--device", "cpu", "--batch_size", "8", "--workers", "0", "--epochs", "1",
                                    "--pretrained_model", str(narrow["tmp"] / "init.npz"), "--extra_tag", f"k{k}",
                                    "--set", *sets]) == 0
        run = cli_root / "kitti_models" / "ptt" / f"k{k}"
        summary = _summary(_log(run, "log_train_*.txt"))
        assert summary["steps"] == [0, 3] and summary["checkpoints"] == [1]  # 24 items / 8
        states[k] = torch.load(run / "ckpt" / "checkpoint_epoch_1.pth", weights_only=False)
    assert states[2]["optimizer"]["count"] == states[1]["optimizer"]["count"] == 3
    model_a, model_b = states[2]["model"], states[1]["model"]
    assert set(model_a) == set(model_b) and all(torch.equal(model_a[k], model_b[k]) for k in model_a)


def test_ptt_synth_ps_evaluates_on_one_device(narrow, cli_root):
    """POINT_SHARDING on one device runs the normal path and says so in one line."""
    assert test_tracking.main(["--device", "cpu", "--cfg_file", "tools/cfgs/synthetic_models/ptt_synth_ps.yaml",
                               "--max_points", "1024", "--ckpt", str(narrow["tmp"] / "init.npz"),
                               "--set", *narrow["sets"], *SYNTH_SETS]) == 0
    run = cli_root / "synthetic_models" / "ptt_synth_ps" / "default" / "eval" / "default"
    text = _log(run, "log_eval_*.txt")
    assert "POINT_SHARDING: one device, so the point axis 'point' is not split" in text
    rec = _summary(text)
    assert np.isfinite(rec["success"]) and len((run / "final_result" / "data" / "track_result.txt")
                                               .read_text().splitlines()) == 8
    assert rec["graph_captures"] == 0 and rec["kernel_builds"] in (0, 1)  # the CPU: no graph; the native scorer


def _p2b_sets(narrow):
    """narrow's --set list for p2b_synth_strong.yaml: the narrowed P2B model."""
    model = narrow_model_cfg()
    model["NAME"] = "P2B"
    model["BACKBONE_3D"]["SA_CONFIG"]["SAMPLE_METHOD"] = ["sequence"] * 3
    for head in ("CENTROID_HEAD", "BOX_HEAD"):
        model[head]["TRANSFORMER_BLOCK"]["ENABLE"] = False
    base = config_by_path("tools/cfgs/synthetic_models/p2b_synth_strong.yaml")["MODEL"]
    return _sets(base, model, "MODEL.") + ["DATA_CONFIG.SEARCH_INPUT_SIZE", "256", "DATA_CONFIG.TEMPLATE_INPUT_SIZE",
                                           "128"]


@pytest.mark.parametrize("cfg_file,optimizer,precision", [
    ("synthetic_models/p2b_synth_strong.yaml", None, "bf16"),
    ("synthetic_models/ptt_synth.yaml", "sgd", "f32"),
], ids=["p2b_synth_strong_bf16", "sgd"])
def test_train_cli_steps(narrow, cli_root, cfg_file, optimizer, precision):
    """p2b_synth_strong.yaml trains in bf16 (MIXED_PRECISION from the file), and
    ptt_synth.yaml with OPTIMIZATION.OPTIMIZER sgd: two steps each, finite."""
    sets = (_p2b_sets(narrow) if "p2b" in cfg_file else narrow["sets"]) + SYNTH_SETS
    if optimizer:
        sets += ["OPTIMIZATION.OPTIMIZER", optimizer]
    assert train_tracking.main(["--device", "cpu", "--cfg_file", f"tools/cfgs/{cfg_file}", "--batch_size", "4",
                                "--epochs", "1", "--workers", "2", "--set", *sets]) == 0
    run = cli_root / cfg_file.replace(".yaml", "") / "default"
    text = _log(run, "log_train_*.txt")
    source = "from config" if precision == "bf16" else "default"
    assert f"mixed_precision={precision} ({source};" in text
    assert f"optimizer={optimizer or 'adam'} with the step lr schedule" in text
    rec = _summary(text)
    assert rec["steps"] == [0, 2] and rec["checkpoints"] == [1]
    assert rec["graph_captures"] == rec["kernel_builds"] == 0  # the CPU: the eager step, no kernel
    assert np.isfinite(float(text.split("  loss ")[-1].split()[0]))


@pytest.mark.parametrize("job", ["p2b_synth_strong"] + list(chip_smoke.OPTIMIZER_RUNS))
def test_chip_smoke_phase15_cli_jobs_parse(job):
    """chip_smoke.py phase 15's train CLI arguments make a configuration the
    port runs: --set keeps each key's type."""
    args, sets = chip_smoke.phase15_cli_jobs()[job]
    cfg = cli_config(args[args.index("--cfg_file") + 1], list(sets))
    check_ported(cfg, training=True)
    assert cfg["OPTIMIZATION"]["OPTIMIZER"] == ("adam" if job == "p2b_synth_strong" else job)
    assert cfg["OPTIMIZATION"].get("MIXED_PRECISION", False) == (job == "p2b_synth_strong")


def test_ptt_waymo_is_accepted(cli_root):
    """ptt_waymo.yaml passes check_ported for both CLIs on one device; its
    POINT_SHARDING is the one-device note, its 8192-point clouds the kernels'
    largest forms (tests/test_torch_port_waymo.py runs its forward)."""
    for training in (False, True):
        check_ported(config_by_path("tools/cfgs/kitti_models/ptt_waymo.yaml"), training=training)
    assert "not split" in point_sharding_note(config_by_path("tools/cfgs/kitti_models/ptt_waymo.yaml"))
    assert point_sharding_note(ptt_config()) is None


def test_nuscenes_evaluates_on_a_fixture_tree(narrow, cli_root, tmp_path):
    """nuscenes_models/ptt.yaml through the test CLI on the JAX tests' fixture
    release, device and host paths: a result line a frame, finite scores."""
    make_nuscenes_tree(tmp_path / "nus", n_frames=4)
    sets = narrow["sets"] + ["DATA_CONFIG.DATA_PATH", str(tmp_path / "nus"), "CLASS_NAMES", "car",
                             "DATA_CONFIG.DATA_SPLIT", "test:train_track"]
    for flags in ([], ["--host_loop", "--eval_tag", "host"]):
        assert test_tracking.main(["--device", "cpu", "--cfg_file", "tools/cfgs/nuscenes_models/ptt.yaml",
                                   "--max_points", "1024", "--ckpt", str(narrow["tmp"] / "init.npz"), *flags,
                                   "--set", *sets]) == 0
    run = cli_root / "nuscenes_models" / "ptt" / "default" / "eval"
    for tag in ("default", "host"):
        rows = (run / tag / "final_result" / "data" / "track_result.txt").read_text().splitlines()
        assert len(rows) == 4 and np.isfinite(_summary(_log(run / tag, "log_eval_*.txt"))["success"])


def test_clis_default_to_cuda(cli_root, narrow):
    if torch.cuda.is_available():
        pytest.skip("the default device is present here")
    for cli in (train_tracking, test_tracking):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--set", *narrow["sets"]])


# -------------------------------------------------------------- checkpoints


def test_reference_pth_loads_strict_and_matches_flax(narrow, tmp_path, rng):
    """A .pth in the reference layout, written by the JAX package's
    save_torch_checkpoint, loads strict; the forward matches flax within 2e-4."""
    path = tmp_path / "reference.pth"
    save_torch_checkpoint(path, narrow["variables"]["params"], narrow["variables"]["batch_stats"], epoch=7)
    model = build_network(narrow_model_cfg(), device="cpu")
    load_params_from_file(path, model, strict=True)
    search = rng.uniform(-1, 1, (2, 256, 3)).astype(np.float32)
    template = rng.uniform(-1, 1, (2, 128, 3)).astype(np.float32)
    with torch.no_grad():
        ours = model({"search_points": torch.from_numpy(search),
                      "template_points": torch.from_numpy(template)})["pred_box_data"].numpy()
    ref = jax.jit(lambda v, b: narrow["jmodel"].apply(v, b, train=False))(
        narrow["variables"], {"search_points": jnp.asarray(search), "template_points": jnp.asarray(template)})
    np.testing.assert_allclose(ours, np.asarray(ref["pred_box_data"]), rtol=0, atol=2e-4)
    # the port's own export writes what the JAX package writes
    exported = reference_state_dict(model.state_dict())
    written = torch.load(path, weights_only=True)["model_state"]
    assert exported.keys() == written.keys()
    assert all(torch.equal(exported[k], written[k]) for k in written)


def test_checkpoint_files_and_partial_load(narrow, tmp_path):
    """The three layouts load the same weights; strict refuses a model of other
    widths, the partial load takes the tensors whose shapes match."""
    npz = narrow["tmp"] / "init.npz"
    ref_sd = state_dict_from_npz(npz)
    model = build_network(narrow_model_cfg(), device="cpu")
    torch.save({"model": ref_sd, "optimizer": {}, "step": 3, "epoch": 1}, tmp_path / "checkpoint_epoch_1.pth")
    torch.save(reference_state_dict(ref_sd), tmp_path / "bare.pth")
    for path in (npz, tmp_path / "checkpoint_epoch_1.pth", tmp_path / "bare.pth"):
        load_params_from_file(path, model, strict=True)
        assert all(torch.equal(model.state_dict()[k], v) for k, v in ref_sd.items() if "num_batches" not in k)
    assert resolve_checkpoint_path(tmp_path) == tmp_path / "checkpoint_epoch_1.pth"
    with pytest.raises(FileNotFoundError):
        resolve_checkpoint_path(tmp_path, epoch=4)

    wide_cfg = narrow_model_cfg()
    wide_cfg["BOX_HEAD"]["FC"] = [64, 64, 32, 5]
    wide = build_network(wide_cfg, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        load_params_from_file(npz, wide, strict=True)
    before = {k: v.clone() for k, v in wide.state_dict().items()}
    load_params_from_file(npz, wide, strict=False)
    after = wide.state_dict()
    assert torch.equal(after["backbone_3d.sa_stages.0.mlp.linears.0.weight"],
                       ref_sd["backbone_3d.sa_stages.0.mlp.linears.0.weight"])
    assert torch.equal(after["box_voting_head.fc.linears.2.weight"], before["box_voting_head.fc.linears.2.weight"])


# ----------------------------------------------------------------- SAVE_PCD


def test_save_pcd_matches_jax(narrow, tmp_path):
    """TEST.SAVE_PCD: the host evaluators write the same files with the same
    world-frame points; the device evaluator writes, for its own boxes, what
    the JAX device evaluator's dump writes for them."""
    jcfg, cfg = narrow["jcfg"], narrow["cfg"]
    jcfg.TEST.SAVE_PCD = True
    cfg["TEST"]["SAVE_PCD"] = True
    model = build_network(narrow_model_cfg(), device="cpu")
    load_params_from_file(narrow["tmp"] / "init.npz", model)
    tracklets = [KittiTrackingDataset(cfg["DATA_CONFIG"], "Car", training=False)[0]]

    tev = TrackingEvaluator(cfg, model, output_dir=tmp_path / "host", device="cpu")
    jev = JTrackingEvaluator(jcfg, narrow["jmodel"], narrow["variables"], None, output_dir=tmp_path / "jhost")
    for trk in tracklets:
        tev.test_tracklet(*trk)
        jev.test_tracklet(*trk)
    _same_pcds(tmp_path / "host" / "pcd", tmp_path / "jhost" / "pcd", 5)

    dev = tdl.DeviceTrackingEvaluator(cfg, model, max_points=1024, batch_size=1, device="cpu",
                                      output_dir=tmp_path / "dev")
    results = dev.track_batch(tracklets)
    jdev = jdl.DeviceTrackingEvaluator(jcfg, narrow["jmodel"], narrow["variables"], batch_size=1,
                                       output_dir=tmp_path / "jdev")
    jdev._tracklet_num = 1
    jdev._save_pcds(tracklets[0][0], tracklets[0][1], results[0], tracklets[0][2])
    _same_pcds(tmp_path / "dev" / "pcd", tmp_path / "jdev" / "pcd", 5)


def _same_pcds(ours, ref, n):
    names = sorted(p.name for p in ours.iterdir())
    assert names == sorted(p.name for p in ref.iterdir()) and len(names) == n
    assert names[0] == "0000_1_candidatePC_1.pcd"
    for name in names:
        np.testing.assert_allclose(read_pcd(ours / name), read_pcd(ref / name), rtol=0, atol=1e-4)


# ------------------------------------------------------------------- reseed


class PointModel(torch.nn.Module):
    """An offset that follows the mean resampled search and template points."""

    def forward(self, batch):
        s, t = batch["search_points"].mean(1), batch["template_points"].mean(1)
        off = torch.stack([0.1 + 0.05 * s[:, 0] - 0.03 * t[:, 0], -0.05 + 0.05 * s[:, 1] + 0.02 * t[:, 1],
                           0.01 * t[:, 2], 3.0 + 2.0 * s[:, 0]], -1)
        data = torch.zeros(off.shape[0], 64, 5)
        data[:, :, :4] = off[:, None]
        data[:, 0, 4] = 5.0
        return {"pred_box_data": data}


@pytest.fixture(scope="module")
def two_batches():
    tracklets = make_tracklets({"NUM_TRACKLETS": 4, "FRAMES_PER_TRACKLET": 6})
    return tracklets[:2], tracklets[2:]


def _centers(results):
    return np.array([[b.center for b in trk] for trk in results])


def test_device_tracker_same_batch_twice_is_bit_equal(two_batches):
    ev = tdl.DeviceTrackingEvaluator(ptt_config(), PointModel(), max_points=1024, batch_size=2, device="cpu")
    a, b = _centers(ev.track_batch(two_batches[0])), _centers(ev.track_batch(two_batches[0]))
    np.testing.assert_array_equal(a, b)


def test_device_tracker_batch_does_not_depend_on_earlier_batches(two_batches):
    """A batch's boxes are the same dispatched first or after another batch,
    also with the other batch still in flight (two deep)."""
    first = tdl.DeviceTrackingEvaluator(ptt_config(), PointModel(), max_points=1024, batch_size=2, device="cpu")
    alone = _centers(first.track_batch(two_batches[1]))
    ev = tdl.DeviceTrackingEvaluator(ptt_config(), PointModel(), max_points=1024, batch_size=2, device="cpu")
    h0 = ev.dispatch_batch(two_batches[0])
    h1 = ev.dispatch_batch(two_batches[1])
    ev.finish_batch(h0)
    np.testing.assert_array_equal(_centers(ev.finish_batch(h1)), alone)
    moved = np.abs(alone - np.array([[b.center for b in trk[1]] for trk in two_batches[1]])).max()
    assert moved > 0.05
