"""The port's profiling (``ptt_tpu_torch/utils/profiling.py``) against the JAX
package's (``ptt_tpu/utils/profiling.py``) on the narrowed configuration, its
profiler window (the CUPTI setting in place before a session starts, the
refusal after a teardown, the only place that imports ``torch.profiler``), and
the port's ``train_bench`` and ``demo_tracking`` end to end on the CPU.

``per_layer_flops`` rows are held against the JAX rows after the key mapping of
``ptt_tpu_torch/convert.py``, in params, out_shape, flops and calls. One row
differs by design: the similarity module's layer 0 runs decomposed in both
packages (its weight is used, the layer is not called), and flax still calls
the JAX ``Dense_0`` once on a (1, C_in) row of zeros to create its parameters;
the JAX walk records that call, the port's records none."""

import ast
import contextlib
import pathlib

import jax
import numpy as np
import pytest
import torch
import torch.profiler
from torch import nn

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.utils import profiling as jprofiling
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.convert import torch_key
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.tools import demo_tracking, train_bench
from ptt_tpu_torch.utils import cuda_graph, profiling
from tests.test_torch_port_cli import _sets
from tests.test_torch_port_train import narrow_model_cfg

torch.set_num_threads(1)

BIND_ROW = "similarity_module.mlp.linears.0"  # the decomposed layer 0 (module docstring)
TINY_SETS = _sets(ptt_config()["MODEL"], narrow_model_cfg(), "MODEL.") + [
    "DATA_CONFIG.SEARCH_INPUT_SIZE", "256", "DATA_CONFIG.TEMPLATE_INPUT_SIZE", "128"]


@pytest.fixture(scope="module")
def pair():
    """The narrowed model in both packages, the JAX init's weights in both, and
    one eval batch."""
    cfg = narrow_model_cfg()
    rng = np.random.default_rng(0)
    batch = {"search_points": rng.standard_normal((2, 256, 3)).astype(np.float32),
             "template_points": rng.standard_normal((2, 128, 3)).astype(np.float32)}
    jmodel = jbuild(cfg)
    variables = jax.jit(lambda b: jmodel.init(jax.random.PRNGKey(0), b, train=False))(batch)
    model = build_network(cfg, device="cpu")
    return {"jmodel": jmodel, "variables": variables, "model": model, "batch": batch,
            "tbatch": {k: torch.from_numpy(v) for k, v in batch.items()}}


def test_count_parameters_equals_jax(pair):
    ours = profiling.count_parameters(pair["model"])
    ref = jprofiling.count_parameters(pair["variables"]["params"])
    assert ours == ref and list(ours["per_module"]) == ["backbone_3d", "similarity_module",
                                                        "centroid_voting_head", "box_voting_head"]


def test_per_layer_flops_rows_equal_jax(pair):
    ours = dict(profiling.per_layer_flops(pair["model"], pair["tbatch"]))
    ref = {}
    for path, info in jprofiling.per_layer_flops(pair["jmodel"], pair["variables"], pair["batch"]):
        leaf = "kernel" if info["kind"] == "Dense" else "scale"
        ref[torch_key(f"params/{path}/{leaf}").rsplit(".", 1)[0]] = info
    assert ours.keys() == ref.keys() and len(ours) == 67
    fields = ("params", "out_shape", "flops", "calls")
    for name, row in ours.items():
        got, want = tuple(row[f] for f in fields), tuple(ref[name][f] for f in fields)
        if name == BIND_ROW:
            assert got == (want[0], None, 0.0, 0) and want[1:] == ((1, 64), 2.0 * 260 * 64, 1)
            continue
        assert got == want, name
    sa = [r for name, r in ours.items() if name.startswith("backbone_3d.sa_stages")]
    assert sa and all(r["calls"] == 2 for r in sa)  # the Siamese branches share the backbone's layers
    # the walk runs on a copy: the model keeps its mode and its kernels
    assert not pair["model"].training and all(getattr(m, "use_kernels", True) for m in pair["model"].modules())


def test_layer_params_sum_to_the_total(pair):
    rows = profiling.per_layer_flops(pair["model"], pair["tbatch"])
    assert sum(r["params"] for _, r in rows) == profiling.count_parameters(pair["model"])["total"]
    table = profiling.format_layer_table(rows)
    assert "TOTAL" in table and "backbone_3d.cov_final" in table


class _LinearStage(nn.Module):
    """One stage of a tracker-like model: a batch dict in, a batch dict out."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(5, 7)

    def forward(self, batch):
        return {"x": self.lin(batch["x"])}


class _OneStage(nn.Module):
    def __init__(self):
        super().__init__()
        self.stage = _LinearStage()

    def forward(self, batch):
        return self.stage(batch)


def test_a_linear_layer_counts_2mkn():
    """(3, 4, 5) -> (3, 4, 7): M = 12 positions, K = 5, N = 7, by the hook walk
    and by FlopCounterMode."""
    model, batch = _OneStage(), {"x": torch.randn(3, 4, 5)}
    [(name, row)] = profiling.per_layer_flops(model, batch)
    assert (name, row["flops"], row["params"], row["out_shape"], row["calls"]) == ("stage.lin", 2.0 * 12 * 5 * 7,
                                                                                  42, (3, 4, 7), 1)
    [(name, row)] = profiling.per_module_flops(model, batch)
    assert (name, row["flops"], row["params"]) == ("stage", 2.0 * 12 * 5 * 7, 42)


def test_per_module_flops_by_stage(pair):
    rows = profiling.per_module_flops(pair["model"], pair["tbatch"])
    counts = profiling.count_parameters(pair["model"])["per_module"]
    assert [name for name, _ in rows] == list(counts)
    assert all(r["params"] == counts[name] and r["flops"] > 0 for name, r in rows)
    assert "TOTAL" in profiling.format_cost_table(rows)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(tmp_path / "trace") as prof:
        torch.ones(4) @ torch.ones(4)
    assert prof is not None and (tmp_path / "trace" / "trace.json").stat().st_size > 0


REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def seen_env(monkeypatch):
    """``torch.profiler.profile`` replaced by one that records the CUPTI
    settings in the environment when it is made, then profiles as before;
    TEARDOWN_CUPTI starts unset."""
    seen, real = [], torch.profiler.profile

    def recording(*args, **kwargs):
        seen.append({key: profiling.os.environ.get(key) for key in profiling.CUPTI_SETTINGS})
        return real(*args, **kwargs)

    for key in profiling.CUPTI_SETTINGS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(torch.profiler, "profile", recording)
    return seen


def test_the_cupti_setting_is_in_place_before_a_session_starts(seen_env, tmp_path):
    with profiling.device_window():
        torch.ones(2, 2) @ torch.ones(2, 2)
    with profiling.trace(tmp_path / "trace"):
        torch.ones(2, 2) @ torch.ones(2, 2)
    assert seen_env == [profiling.CUPTI_SETTINGS] * 2 == [{"TEARDOWN_CUPTI": "0"}] * 2


def test_a_value_the_user_set_stands(seen_env, monkeypatch):
    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    assert profiling.profiler_setup() == {"TEARDOWN_CUPTI": "1"}
    with profiling.device_window():
        torch.ones(2, 2) @ torch.ones(2, 2)
    assert seen_env == [{"TEARDOWN_CUPTI": "1"}] and profiling.os.environ["TEARDOWN_CUPTI"] == "1"


def test_device_window_has_no_device_events_on_the_cpu():
    with profiling.device_window() as window:
        torch.ones(3, 4) @ torch.ones(4, 5)
    assert window.events == []
    mm = [r for r in window.operators() if r.key == "aten::mm"]
    assert len(mm) == 1 and mm[0].count == 1 and mm[0].self_device_us == 0
    with profiling.device_window(cpu=False, record_shapes=True) as window:  # no CUDA: the host's activity all the same
        torch.ones(3, 4) @ torch.ones(4, 5)
    assert window.events == [] and ((3, 4), (4, 5)) in {tuple(r.input_shapes) for r in
                                                       window.operators(group_by_input_shape=True)}


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA stood in for: ``is_available`` true, ``torch.profiler.profile``
    a session that records its arguments, the port's trace state and graph
    history fresh. Yields the sessions started."""
    sessions = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: sessions.append(kw) or contextlib.nullcontext())
    monkeypatch.setattr(profiling, "_traces", {"cupti_since": None, "torn_down": None})
    monkeypatch.setattr(cuda_graph, "history", cuda_graph._History())
    return sessions


def test_a_cuda_trace_after_a_teardown_is_refused(fake_cuda, monkeypatch):
    """A window that ends with TEARDOWN_CUPTI other than 0 is recorded, and
    the next CUDA window raises before it starts a session; with 0 (the
    port's value) windows follow one another."""
    monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    for _ in range(2):
        with profiling.device_window():
            pass
    assert len(fake_cuda) == 2 and profiling._traces["torn_down"] is None
    monkeypatch.setenv("TEARDOWN_CUPTI", "1")
    with profiling.device_window():
        pass
    assert profiling._traces["torn_down"] == "1"
    with pytest.raises(profiling.TraceRefused, match="TEARDOWN_CUPTI=1"):
        with profiling.device_window():
            pass
    assert len(fake_cuda) == 3


def release(history):
    history.released = history.tick()


def shared_capture(history):
    history.shared_after = history.released


def test_a_trace_after_a_release_and_a_shared_capture_is_refused(fake_cuda, monkeypatch):
    """Releases and shared-pool captures before the first trace (a fresh
    process's history) refuse nothing; a release after it alone, or a shared
    capture with no release after it, neither; a release then a shared
    capture after it, every later CUDA trace."""
    monkeypatch.setenv("TEARDOWN_CUPTI", "0")
    history = cuda_graph.history
    release(history)
    shared_capture(history)
    with profiling.device_window():
        pass
    shared_capture(history)  # after no release since the first trace
    with profiling.device_window():
        pass
    release(history)
    with profiling.device_window():
        pass
    assert profiling.refusal(True) is None and len(fake_cuda) == 3
    shared_capture(history)
    assert "captured into a shared pool" in profiling.refusal(True) and profiling.refusal(False) is None
    with pytest.raises(profiling.TraceRefused, match="cudaGraphLaunch"):
        with profiling.device_window():
            pass
    assert len(fake_cuda) == 3


def profiler_imports(path) -> list:
    """The lines of ``path`` that import ``torch.profiler`` (or
    ``torch.autograd.profiler``) or reach it as an attribute."""
    found = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [f"{node.module}.{a.name}" for a in node.names]
        elif isinstance(node, ast.Attribute) and node.attr == "profiler":
            names = [ast.unparse(node)]
        else:
            continue
        if any(n.startswith(("torch.profiler", "torch.autograd.profiler")) for n in names):
            found.append(node.lineno)
    return found


def test_only_the_profiling_module_imports_torch_profiler():
    paths = [REPO / "chip_smoke.py", REPO / "chip_probe21.py", *sorted((REPO / "ptt_tpu_torch").rglob("*.py"))]
    found = {str(p.relative_to(REPO)): lines for p in paths if (lines := profiler_imports(p))}
    assert found == {"ptt_tpu_torch/utils/profiling.py": found.get("ptt_tpu_torch/utils/profiling.py")}
    assert found["ptt_tpu_torch/utils/profiling.py"]


def test_train_bench_and_demo_run_on_the_cpu(capsys):
    """Both tools end to end on the CPU at the narrowed width: the JAX tool's
    table with its K-dispatch column (host ms at K = 4), no device metric."""
    assert train_bench.main(["--device", "cpu", "--iters", "2", "--batch_size", "4", "--workers", "1",
                             "--tracklets", "2", "--frames", "2", "--configs", "tools/cfgs/kitti_models/ptt.yaml",
                             "--set", *TINY_SETS]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu") and out[-2].startswith("|---")
    row = out[-1].split(" | ")
    assert row[0] == "| ptt" and float(row[6]) > 0 and row[-1] == "n/a (cpu) |" and "K=4" in out[-3]
    assert float(row[3]) > 0 and row[4].startswith("n/a (cpu")

    assert demo_tracking.main(["--device", "cpu", "--batch_size", "2", "--workers", "1", "--set", *TINY_SETS]) == 0
    out = capsys.readouterr().out
    for text in ("dataset: 64 samples", "parameters: 335,865", "backbone_3d", "GFLOP", "| TOTAL",
                 "one train step", "steady train step"):
        assert text in out, text
