"""The port's profiling (``ptt_tpu_torch/utils/profiling.py``) against the JAX
package's (``ptt_tpu/utils/profiling.py``) on the narrowed configuration, and
the port's ``train_bench`` and ``demo_tracking`` end to end on the CPU.

``per_layer_flops`` rows are held against the JAX rows after the key mapping of
``ptt_tpu_torch/convert.py``, in params, out_shape, flops and calls. One row
differs by design: the similarity module's layer 0 runs decomposed in both
packages (its weight is used, the layer is not called), and flax still calls
the JAX ``Dense_0`` once on a (1, C_in) row of zeros to create its parameters;
the JAX walk records that call, the port's records none."""

import jax
import numpy as np
import pytest
import torch
from torch import nn

from ptt_tpu.nn import build_network as jbuild
from ptt_tpu.utils import profiling as jprofiling
from ptt_tpu_torch.config import ptt_config
from ptt_tpu_torch.convert import torch_key
from ptt_tpu_torch.nn import build_network
from ptt_tpu_torch.tools import demo_tracking, train_bench
from ptt_tpu_torch.utils import profiling
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
