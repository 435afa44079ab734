"""Each traffic kind end to end on the CPU at a tiny size, through
``run_cell`` (the run without its look for a card): a result line the
contract accepts, ``correct`` true; and the command without a card exits
non-zero and prints no result."""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

from benchmark.tests._tiny import tiny

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_cpu(cell):
    spec = tiny(run.load_cell(cell))
    result = run.run_cell(spec, 2**31 + 77, 0.5, False, device="cpu")
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    expected = {m["name"] for m in spec.end_to_end}
    assert "setup_s" in expected and set(line["metrics"]) == expected
    for m in line["metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0 and m["unit"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(spec.traffic["limits"])


def test_command_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
