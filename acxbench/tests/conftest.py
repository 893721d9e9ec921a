"""Settings of the benchmark's own tests (``python -m pytest
acxbench/tests``). Tests that need a CUDA device carry the ``chip``
marker and take the ``cuda`` fixture, which decides at run time and
skips on a machine without one; on the chip they run with
``python -m pytest acxbench/tests -m chip``."""

import json
import os
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "acxbench"
DATA = Path(__file__).resolve().parent / "data"
TINY_CELLS = ("tiny-gpt2.serve", "tiny-llama.serve", "tiny-gpt2.train")

sys.path.insert(0, str(REPO))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as ``run.py`` sets: the tiny runs time their
    windows on the host, and several test workers share its cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA device (the H100); skips without one")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def make_tiny_bench(dst: Path):
    """A copy of the benchmark's files under ``dst`` with the tiny test
    configurations and cells added as files and entered in a
    ``BENCHMARK.json`` of its own: the way a later change adds them."""
    from acxbench import harness
    root = dst / "acxbench"
    for sub in ("configs", "workloads", "drivers", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    for f in DATA.glob("tiny-*.json"):
        kind = "workloads" if f.stem.count(".") else "configs"
        shutil.copy(f, root / kind / f.name)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            train = m["name"].startswith("train") or m["name"].endswith(
                ".train")
            m["workloads"] += [c for c in TINY_CELLS
                               if c.endswith(".train") == train]
    (dst / "BENCHMARK.json").write_text(json.dumps(spec))
    return harness.Bench(root)


@pytest.fixture
def tiny_bench(tmp_path):
    from mpi_acx_torch import reqlog
    reqlog._reset_for_tests()
    yield make_tiny_bench(tmp_path)
    reqlog._reset_for_tests()
    os.environ.pop("ACX_REQLOG", None)
