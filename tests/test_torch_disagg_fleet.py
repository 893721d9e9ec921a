"""Disaggregated serving across processes: two ranks under
``build/acxrun -transport socket`` running tests/torch_disagg_worker.py on
the CPU, a prefill rank shipping per-layer KV handoffs to a decode rank,
which holds its outputs bit for bit to its own monolithic
``serve_greedy(kv_int8=True)``. The decode rank seats handoffs in fixed
slots and in the paged pool; in the mixed leg the prefill rank is the JAX
package's, so both packages meet on one wire."""

import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_disagg_worker.py")


@pytest.fixture(scope="module")
def acxrun():
    subprocess.run(["make", "-C", REPO, "lib", "tools"], check=True,
                   capture_output=True, timeout=600)
    return os.path.join(REPO, "build", "acxrun")


def _fleet(acxrun, *args):
    # Two ranks share the host: one intra-op thread each.
    env = dict(os.environ, ACX_ROLE="prefill,decode", JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    res = subprocess.run(
        [acxrun, "-np", "2", "-transport", "socket", "-timeout", "100",
         sys.executable, WORKER, "--device", "cpu", "--requests", "4",
         *args],
        capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    # The ranks share one pipe: a record need not start a line.
    rows = [json.loads(m) for m in re.findall(r"DISAGG_ROW (\{[^}]*\})",
                                              res.stdout)]
    assert len(rows) == 2, res.stdout
    return res.stdout, {r["role"]: r for r in rows}


@pytest.mark.parametrize("leg", [[], ["--page-tokens", "16"]],
                         ids=["fixed", "paged"])
def test_port_fleet(acxrun, leg):
    out, rows = _fleet(acxrun, *leg)
    assert "DISAGG_OK rank=1 rids=[0, 1, 2, 3]" in out
    assert "DISAGG_SHIPPED rank=0 n=4 package=torch" in out
    dec = rows["decode"]
    assert dec["requests"] == 4 and dec["requeues"] == 0
    # Buckets 8, 16, 8, 32 at the tiny configuration's 4 layers of 288 B
    # a bucket position.
    assert dec["handoff_wire_bytes"] == 4 * 288 * (8 + 16 + 8 + 32)
    # CPU tensors: every wrapper ran its plain version.
    for js in re.findall(r"LAUNCHES (\{[^}]*\})", out):
        assert not any(json.loads(js).values()), js


def test_jax_prefill_rank_ships_to_the_port(acxrun):
    """Rank 0 is the JAX package's prefill worker on the same weights (the
    JAX tiny init crossed by params_from_jax): the port's decode rank
    serves its monolithic outputs from JAX's handoffs."""
    out, rows = _fleet(acxrun, "--jax-rank", "0")
    assert "DISAGG_SHIPPED rank=0 n=4 package=jax" in out
    assert "DISAGG_OK rank=1 rids=[0, 1, 2, 3]" in out
    assert rows["prefill"]["package"] == "jax"
    assert rows["decode"]["package"] == "torch"
