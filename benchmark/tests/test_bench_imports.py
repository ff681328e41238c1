"""What the benchmark runs on the card imports neither JAX nor the JAX
package, and the scene generator and the reference import nothing of the
program either. Module names are compared by their whole top-level name:
``velocity_tpu_torch`` begins with ``velocity_tpu``."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
JAX = {"jax", "jaxlib", "flax", "velocity_tpu"}
PORT = "velocity_tpu_torch"
# imported by the renderer and the reference: neither JAX nor the program
STANDALONE = ["benchmark.scene", "benchmark.stats", "benchmark.reference.judge",
              "benchmark.reference.control", "benchmark.reference.geo"]


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                         for p in BENCH.rglob("*.py")
                                         if "tests" not in p.parts))
def test_no_source_imports_jax(path):
    tops = _imported_tops(ROOT / path)
    assert not tops & JAX, tops & JAX
    if path.startswith(("benchmark/scene", "benchmark/reference/", "benchmark/stats")):
        assert PORT not in tops


def _loaded(modules):
    code = ("import importlib, json, sys; sys.path.insert(0, %r)\n"
            "for m in %r: importlib.import_module(m)\n"
            "print(json.dumps(sorted({n.split('.')[0] for n in sys.modules})))" % (str(ROOT), modules))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         cwd=ROOT, timeout=300)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_what_runs_on_the_card_loads_no_jax():
    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    modules = ["benchmark.harness", "benchmark.trace", "benchmark.drivers._port",
               "velocity_tpu_torch.pipeline.step_graph", "velocity_tpu_torch.ops.launches"]
    for w in spec["workloads"]:
        _wl, _config, traffic, _spec = harness.cell(w["name"], spec)
        modules.append(f"benchmark.drivers.{traffic['driver']}")
    modules += [f"benchmark.metrics.{m['name']}" for m in spec["per_layer"]]
    loaded = _loaded(modules)
    assert not loaded & JAX, loaded & JAX
    assert PORT in loaded


def test_renderer_and_reference_load_nothing_of_the_program():
    loaded = _loaded(STANDALONE)
    assert not loaded & (JAX | {PORT}), loaded & (JAX | {PORT})


def test_the_result_refuses_jax_by_top_level_name(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "velocity_tpu_torch_like", sys)
    assert "velocity_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "velocity_tpu.ops", sys)
    assert "velocity_tpu.ops" in harness.forbidden_modules()
