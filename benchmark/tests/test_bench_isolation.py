"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole; the port's name begins with the JAX package's), and the
reference and the generators load nothing of the port."""

import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _modules():
    names = []
    for path in sorted(BENCH.rglob("*.py")):
        rel = path.relative_to(ROOT)
        if "tests" in rel.parts or "metrics" in rel.parts or path.name == "__init__.py":
            continue
        names.append(".".join(rel.with_suffix("").parts))
    return names


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_every_module_without_jax():
    metrics = sorted(str(p) for p in (BENCH / "metrics").glob("*.py"))
    code = ("import importlib, importlib.util, sys\n"
            f"for m in {_modules()!r}: importlib.import_module(m)\n"
            f"for i, p in enumerate({metrics!r}):\n"
            "    s = importlib.util.spec_from_file_location(f'metric{i}', p)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "import ptt_tpu_torch.eval.device_loop, ptt_tpu_torch.train.trainer\n"
            "from benchmark.run import forbidden_modules\n"
            "print(*forbidden_modules(), 'top:', *sorted({n.split('.')[0] for n in sys.modules}))")
    loaded = _loaded(code)
    assert "top:" in loaded
    assert loaded & {"jax", "jaxlib", "flax", "optax", "orbax", "ptt_tpu"} == set()
    assert "ptt_tpu_torch" in loaded


@pytest.mark.parametrize("package", ["benchmark.reference", "benchmark.gen"])
def test_reference_and_generators_without_the_port(package):
    mods = [m for m in _modules() if m.startswith(package + ".")]
    assert mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print(*sorted({n.split('.')[0] for n in sys.modules}))")
    loaded = _loaded(code)
    assert "ptt_tpu_torch" not in loaded and "ptt_tpu" not in loaded and "jax" not in loaded


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "ptt_tpu_torch_lookalike", sys)
    assert "ptt_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ptt_tpu.fake", sys)
    assert "ptt_tpu" in run.forbidden_modules()
