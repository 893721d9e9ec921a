"""The harness: finds a cell's files by name, runs its driver, reads its
metrics and judges its outputs.

Everything of one configuration, cell, kind of traffic or per-layer
metric is a file of its own under the benchmark's folder:

* ``configs/<config>.json``: the configuration (its ``family`` names an
  adapter in ``families/``);
* ``workloads/<cell>.json``: the cell (its ``config``, its ``driver``, the
  traffic's parameters, the limits of its correctness check);
* ``drivers/<driver>.py``: one per kind of traffic;
* ``metrics/<metric>.py``: one per per-layer metric, a reader over the
  traced run's artifacts.

``BENCHMARK.json`` at the checkout's root says which end-to-end and
per-layer metrics each cell reports. A new cell, configuration or metric
is therefore new files plus new entries there, with no edit to a file
that exists.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import List, Optional

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "mpi_acx_tpu")


class Bench:
    """The benchmark's files under ``root`` (this folder unless a test
    gives another) and the ``BENCHMARK.json`` at ``spec_path``."""

    def __init__(self, root: Path = HERE, spec_path: Optional[Path] = None):
        self.root = Path(root)
        self.spec = json.loads(Path(
            spec_path or self.root.parent / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        return _load_json(self.root / "workloads" / f"{name}.json")

    def config(self, name: str) -> dict:
        return _load_json(self.root / "configs" / f"{name}.json")

    def driver(self, name: str) -> ModuleType:
        return _load_module(self.root / "drivers" / f"{name}.py",
                            f"acxbench_driver_{name}")

    def family(self, name: str) -> ModuleType:
        return importlib.import_module(f"acxbench.families.{name}")

    def metric(self, name: str) -> ModuleType:
        return _load_module(self.root / "metrics" / f"{name}.py",
                            "acxbench_metric_" + name.replace(".", "_")
                            .replace("-", "_"))

    def end_to_end(self, cell: str) -> List[dict]:
        """The end-to-end metrics ``cell`` reports."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics ``cell`` reports: those that list it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", [cell] if m["moves"] in e2e
                                 else [])]


def _load_json(path: Path) -> dict:
    if not path.exists():
        raise FileNotFoundError(f"no file {path}")
    return json.loads(path.read_text())


def _load_module(path: Path, modname: str) -> ModuleType:
    if not path.exists():
        raise FileNotFoundError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (names compared whole)."""
    return sorted({n for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device: str) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, the check.
    Returns the result line's fields but ``device``, the window's start
    (``t_window``, perf_counter), the peak memory and the traced run's
    artifacts."""
    wl = bench.workload(cell)
    cfg = bench.config(wl["config"])
    run = SimpleNamespace(cell=cell, workload=wl, config=cfg, seed=seed,
                          device=device, trace=trace,
                          family=bench.family(cfg["family"]))
    drv = bench.driver(wl["driver"]).Driver(run)
    drv.setup()
    t_window = time.perf_counter()
    drv.window(seconds)
    peak = drv.memory_peak()
    e2e = drv.end_to_end(seconds)
    art = drv.artifacts() if trace else None
    drv.release()
    readings = drv.check()
    checks = {k: {"value": readings[k], "limit": lim}
              for k, lim in wl["limits"].items()}
    correct = all(c["value"] is not None and c["value"] <= c["limit"]
                  for c in checks.values())
    if trace:
        metrics = {}
        for m in bench.per_layer(cell):
            v = bench.metric(m["name"]).read(art)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.end_to_end(cell) if m["name"] != "setup_s"}
    return dict(t_window=t_window, correct=correct,
                attempted=e2e["attempted"], failed=e2e["failed"],
                metrics=metrics, checks=checks, peak=peak, art=art)
