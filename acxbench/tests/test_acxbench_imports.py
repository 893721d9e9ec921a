"""Nothing the benchmark runs loads JAX, Flax or the JAX package (top-level
module names compared whole), and the references import nothing of the
program."""

import ast
import subprocess
import sys

from conftest import BENCH, REPO

from acxbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "mpi_acx_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & FORBIDDEN, path


def test_references_import_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert "mpi_acx_torch" not in tops, path


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process, every module of the benchmark
    and the port it touches loaded, then ``sys.modules`` read."""
    code = f"""
import sys, tempfile
from pathlib import Path
sys.path[:0] = [{str(REPO)!r}, {str(BENCH / 'tests')!r}]
from conftest import make_tiny_bench
from acxbench import harness, control, run
bench = make_tiny_bench(Path(tempfile.mkdtemp()))
for cell in ("tiny-gpt2.serve", "tiny-gpt2.train"):
    harness.run_cell(bench, cell, 9, 0.3, False, "cpu")
for m in bench.spec["per_layer"]:
    bench.metric(m["name"])
print("loaded:" + ",".join(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxish_lookalike", sys)
    assert "jaxish_lookalike" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "mpi_acx_tpu.models", sys)
    assert "mpi_acx_tpu.models" in harness.forbidden_modules()
