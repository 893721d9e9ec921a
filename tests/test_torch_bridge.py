"""The port's device-triggered exchange between two acxrun ranks, on the
CPU (the flag kernels' plain versions run because the tensors lie there):

* the partitioned exchange of tests/torch_bridge_worker.py in every publish
  mode (B5; plain producer + B1; plain producer + B2), over several rounds;
* the in-program twin, whose overlap is proved by order (the sender holds
  its last partition until the receiver reports a partly filled table),
  with the wire pushes spread over the sender's round in the native trace;
* the stream-ordered triggers and the triggered ping-pong;
* mixed legs each way, the JAX package's tests/device_bridge_worker.py on
  one rank and the torch worker on the other: the flag words and the wire
  are the contract the packages share.
"""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
ACXRUN_TIMEOUT_S = 90


def _run(worker, *args, extra_env=None):
    subprocess.run(["make", "-C", REPO, "lib", "tools"], check=True,
                   capture_output=True, timeout=600)
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra_env or {})
    r = subprocess.run(
        [os.path.join(REPO, "build", "acxrun"), "-np", "2", "-timeout",
         str(ACXRUN_TIMEOUT_S), sys.executable, os.path.join(TESTS, worker),
         *map(str, args)],
        env=env, capture_output=True, text=True,
        timeout=ACXRUN_TIMEOUT_S + 30)
    assert r.returncode == 0, r.stdout + r.stderr
    # The ranks share one pipe, so one rank's line may run into another's.
    return r.stdout


def test_torch_bridge_every_publish_mode():
    out = _run("torch_bridge_worker.py", "--device", "cpu", "--modes",
               "produce_and_pready", "pready", "pready_many", "--sets", "2",
               "--rounds", "2")
    assert out.count("BRIDGE_OK 4") == 2, out
    modes = re.findall(r"BRIDGE_BW mode=(\w+) gbps=", out)
    assert modes == ["produce_and_pready", "pready", "pready_many"], out
    # CPU tensors run the plain versions: no kernel launch is counted.
    launches = re.findall(r"LAUNCHES (\{[^}]*\})", out)
    assert len(launches) == 2, out
    for js in launches:
        assert set(json.loads(js).values()) == {0}, js


def test_torch_bridge_in_program_overlap(tmp_path):
    stagger_s = 0.02
    tr = str(tmp_path / "ip")
    out = _run("torch_bridge_inprogram_worker.py", "--device", "cpu",
               "--stagger-s", stagger_s, extra_env={"ACX_TRACE": tr})
    oks = re.findall(r"INPROGRAM_OK (\d+) (\d+)", out)
    assert len(oks) == 2, out
    assert all(p == "4" and 0 < int(c) < 4 for p, c in oks), out
    # One wire push per partition, spread over the sender's round: the
    # host slept the stagger before each partition after the first, so the
    # pushes span about three staggers (only a proxy stalled for two could
    # bring them within one).
    d = json.loads((tmp_path / "ip.rank0.trace.json").read_text())
    wires = sorted(float(e["ts"]) for e in d["traceEvents"]
                   if e["name"] == "pready_wire")
    assert len(wires) == 4, d["traceEvents"]
    assert wires[-1] - wires[0] > stagger_s * 1e6, wires


def test_torch_triggers_and_pingpong():
    out = _run("torch_triggers_worker.py", "--device", "cpu", "--pingpong",
               "20")
    assert out.count("TRIG_OK 8128.0") == 2, out
    assert len(re.findall(r"PINGPONG p50_us=[\d.]+ p99_us=[\d.]+ "
                          r"iters=20 msg_bytes=8", out)) == 1, out


@pytest.mark.parametrize("jax_rank", [0, 1], ids=["jax_sends",
                                                  "torch_sends"])
def test_mixed_jax_torch_bridge(jax_rank):
    out = _run("torch_mixed_worker.py", "--jax-rank", jax_rank, "--device",
               "cpu")
    assert out.count("BRIDGE_OK 4") == 2, out
    assert out.count("LAUNCHES ") == 1, out      # one rank was torch's
