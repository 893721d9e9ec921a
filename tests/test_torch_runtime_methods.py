"""The rest of the port's ``Runtime`` (mpi_acx_torch/runtime.py): the
resilience, fleet, metrics, telemetry, tracing and flight-recorder calls,
held to the JAX package's binding on a fresh loopback runtime. The two
bindings load the same library, so the JAX side runs in a subprocess (one
process holds one runtime) and prints what this process compares. Then the
serving hooks over a loaded library: a flight dump written, a span opened,
the fleet view read."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The calls whose values a fresh loopback runtime fixes, and the key sets of
# the others; each side prints the same JSON.
PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
from {pkg} import runtime as R
rt = R.Runtime()
rt.set_deadline(2500.0)
out = {{
    "deadline": rt.get_deadline(),
    "fleet_view": rt.fleet_view(),
    "fleet_epoch": rt.fleet_epoch(),
    "fleet_stats": rt.fleet_stats(),
    "resilience_stats": rt.resilience_stats(),
    "recovery_stats": rt.recovery_stats(),
    "flight_keys": sorted(rt.flight_stats()),
    "proxy_keys": sorted(rt.proxy_stats()),
    "metrics_enabled": rt.metrics_enabled(),
    "metrics_keys": sorted(rt.metrics()),
    "tseries_enabled": rt.tseries_enabled(),
    "live_metrics": rt.live_metrics(),
    "drain": rt.drain(10.0),
    "fleet_state_names": list(R.FLEET_STATE_NAMES),
    "queues": [R.QUEUE_STREAM, R.QUEUE_GRAPH],
    "prom_has_counters": "# TYPE acx_" in rt.metrics_prom(),
}}
rt.set_deadline(0.0)
out["deadline_off"] = rt.get_deadline()
rt.stream_sync()
rt.finalize()
print("PROBE " + json.dumps(out))
"""


def _probe(pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for knob in ("ACX_METRICS", "ACX_TSERIES", "ACX_FLIGHT", "ACX_TRACE"):
        env.pop(knob, None)
    res = subprocess.run([sys.executable, "-c",
                          PROBE.format(repo=REPO, pkg=pkg)],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    line = [x for x in res.stdout.splitlines() if x.startswith("PROBE ")]
    return json.loads(line[-1][len("PROBE "):])


@pytest.fixture(scope="module")
def lib_built():
    subprocess.run(["make", "-C", REPO, "lib", "tools"], check=True,
                   capture_output=True, timeout=600)


def test_fresh_loopback_equals_jax(lib_built):
    got = _probe("mpi_acx_torch")
    want = _probe("mpi_acx_tpu")
    assert got == want
    assert got["fleet_view"] == ["active"] and got["deadline"] == 2500.0
    assert got["fleet_stats"]["active"] == 1 and got["drain"] == 0


def test_signatures_equal_jax():
    """Every public method of JAX's Runtime exists on the port's, with
    JAX's parameters (the flag bridge's table is a tensor or an array in
    the port, so its parameter keeps the port's name)."""
    import inspect

    from mpi_acx_tpu import runtime as jrt
    from mpi_acx_torch import runtime as trt
    for name, fn in inspect.getmembers(jrt.Runtime, inspect.isfunction):
        if name.startswith("_") and name != "__init__":
            continue
        want = list(inspect.signature(fn).parameters)
        got = list(inspect.signature(getattr(trt.Runtime, name)).parameters)
        if name == "publish_partition_flags":
            want[-1] = "flags"
        assert got == want, name
    assert trt.FLEET_STATE_NAMES == jrt.FLEET_STATE_NAMES
    assert (trt.QUEUE_STREAM, trt.QUEUE_GRAPH) == (jrt.QUEUE_STREAM,
                                                   jrt.QUEUE_GRAPH)


def test_hooks_over_a_loaded_library(lib_built, tmp_path):
    """With the library loaded (a runtime made in a subprocess of this
    test, so no runtime outlives it here) the serving hooks act: a failed
    step's flight dump lands at $ACX_FLIGHT's prefix, a span opens, the
    fleet view reads one ACTIVE slot, and a serve with a peer loss
    counts its dump."""
    code = f"""
import dataclasses, os, sys
sys.path.insert(0, {REPO!r})
import numpy as np, torch
from mpi_acx_torch import runtime
from mpi_acx_torch.models import serving as ts, transformer as tt
rt = runtime.Runtime()
assert ts._fleet_active() == 1
assert ts._span_app_begin_best_effort(4)
ts._span_app_end_best_effort()
assert ts._tseries_annotate_best_effort(ts.RollingSLO()) is False  # unarmed
cfg = dataclasses.replace(tt.tiny_config(), dtype=torch.float32)
params = tt.init_params(cfg, seed=0, device="cpu")
pf, step, sc, ch, k8, sm = ts.make_server_fns(params, cfg, tt)
n = [0]
def lossy(*a):
    n[0] += 1
    if n[0] == 2:
        raise runtime.AcxPeerDeadError("peer dead", runtime.ERR_PEER_DEAD,
                                       1, 0)
    return step(*a)
prompts = [np.arange(5, dtype=np.int32), np.arange(7, dtype=np.int32)]
got = ts.serve_greedy(params, cfg, prompts, 4, n_slots=2, max_len=32,
                      max_request_retries=0,
                      server_fns=(pf, lossy, sc, ch, k8, sm), device="cpu")
m = got.metrics
assert m.hang_dumps == 1 and m.peer_requeues == 2 and m.slots_shed == 1, m
rt.finalize()
print("HOOKS OK")
"""
    prefix = str(tmp_path / "serve")
    env = dict(os.environ, ACX_FLIGHT=prefix,
               ACX_TRACE=str(tmp_path / "trace"))
    env.pop("ACX_TSERIES", None)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0 and "HOOKS OK" in res.stdout, res.stderr
    dump = json.loads((tmp_path / "serve.rank0.flight.json").read_text())
    assert dump


def test_serving_metrics_carry_the_hook_counters():
    from mpi_acx_torch.models.serving import ServingMetrics
    names = [f.name for f in dataclasses.fields(ServingMetrics)]
    for name in ("peer_requeues", "slots_shed", "slots_revived",
                 "hang_dumps"):
        assert name in names
