"""What the harness runs imports neither JAX nor the JAX package, and reads
nothing of the old benchmark folder."""
from __future__ import annotations

import ast
import json
import subprocess
import sys

import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
BENCH = harness.ROOT / "bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def test_sources_import_no_jax_and_the_reference_nothing_of_the_port():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, path
        assert "benchmarks" not in tops, path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, then every loaded module's
    top-level name, compared whole."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r},
                {str(harness.ROOT / 'src')!r}]
import run, control, harness
from conftest import tiny_spec
out = harness.run(tiny_spec("edge_5120-16x16.replay"), 1, 0.0, False, "cpu",
                  time.perf_counter(), log=lambda m: None)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=harness.ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    loaded = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_run_refuses_a_checkout_without_the_port(tmp_path):
    (tmp_path / "bench").symlink_to(BENCH)
    (tmp_path / "BENCHMARK.json").write_text(
        (harness.ROOT / "BENCHMARK.json").read_text())
    res = subprocess.run(
        [sys.executable, str(tmp_path / "bench" / "run.py"), "--workload",
         "edge_5120-16x16.map", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert res.returncode != 0 and not res.stdout.strip()
