"""The benchmark is driven by its files: BENCHMARK.json agrees with them,
and a configuration, a cell and a per-layer metric added as files are
found and run by the harness."""

import json
import re

import pytest
from conftest import BENCH, REPO

from acxbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["acxbench"]
    names = [c["name"] for c in SPEC["configs"]] + [
        w["name"] for w in SPEC["workloads"]] + [
        m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    path = REPO / cfg["file"]
    data = json.loads(path.read_text())
    assert path.name == f"{cfg['name']}.json"
    assert data["source"] == cfg["source"]
    assert data["reduced"] == cfg["reduced"]


@pytest.mark.parametrize("wl", SPEC["workloads"], ids=lambda w: w["name"])
def test_workload_files(wl):
    data = json.loads((BENCH / "workloads" / f"{wl['name']}.json")
                      .read_text())
    assert data["config"] == wl["config"]
    assert data["chips"] == wl["chips"] == 1
    assert data["why"] == wl["why"] and len(wl["why"]) <= 200
    assert wl["name"] == f"{wl['config']}.{wl['traffic']}"
    assert (BENCH / "drivers" / f"{data['driver']}.py").exists()
    bench = harness.Bench()
    reported = {m["name"] for m in bench.end_to_end(wl["name"])}
    assert "setup_s" in reported and len(reported) >= 2
    assert bench.per_layer(wl["name"])


@pytest.mark.parametrize("m", SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_files_agree(m):
    mod = harness.Bench().metric(m["name"])
    assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.SOURCE) == (
        m["unit"], m["layer"], m["moves"], m["source"])
    e2e = {x["name"]: x for x in SPEC["end_to_end"]}
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_added_files_are_run(tiny_bench):
    """A new configuration, cell and per-layer metric, each a file of its
    own plus entries in BENCHMARK.json, with no edit to any file there."""
    root = tiny_bench.root
    (root / "metrics" / "requests_seen.serve.py").write_text(
        'UNIT, LAYER, MOVES, SOURCE = "1", "serve loop: '
        'models/serving.py", "serve_tokens_per_s", "program_counter"\n\n'
        'def read(art):\n    return float(len(art.requests))\n')
    spec = tiny_bench.spec
    spec["per_layer"].append({
        "name": "requests_seen.serve", "unit": "1", "better": "higher",
        "source": "program_counter", "layer": "serve loop: "
        "models/serving.py", "moves": "serve_tokens_per_s",
        "workloads": ["tiny-llama.serve"]})
    res = harness.run_cell(tiny_bench, "tiny-llama.serve", 5, 4.0, True,
                           "cpu")
    assert res["correct"]
    assert res["metrics"]["requests_seen.serve"]["value"] > 0
    assert "slot_occupancy.serve" in res["metrics"]
    res = harness.run_cell(tiny_bench, "tiny-gpt2.serve", 6, 2.0, False,
                           "cpu")
    assert set(res["metrics"]) == {"serve_tokens_per_s", "ttft_p95_ms"}
    assert res["attempted"] > 0 and res["failed"] == 0


def test_missing_files_raise(tiny_bench):
    with pytest.raises(FileNotFoundError):
        tiny_bench.workload("no-such.cell")
    with pytest.raises(FileNotFoundError):
        tiny_bench.metric("no_such.metric")
