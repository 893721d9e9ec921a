"""The port's multi-process runtime (mpi_acx_torch/parallel/multihost.py),
after tests/test_multihost.py: two processes on this host join through a
``file://`` rendezvous from ACX_COORDINATOR / ACX_NPROCS / ACX_PROC_ID;
the hybrid mesh, a host-local block as the process's part of the global
array, a cross-process reduction (52 = 0+1+2+3 + 10+11+12+13), process
0's pytree broadcast, the barrier, an idempotent second
``initialize()``, and two SGD steps of the train step on a dp = 2 mesh,
one sequence a process, equal to JAX's ``make_train_step`` on the
whole batch on one device (loss rtol 1e-5; parameters atol 1e-5, rtol 1e-4; both processes
bit-equal). In this process: the no-op without a coordinator, the
errors, and the budgets equal to JAX's.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel import multihost as jmh
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.parallel import multihost as mh
from tests import torch_rank_worker as worker


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    return worker.launch("multihost", 2, tmp_path_factory.mktemp("mh"))


def test_two_processes(procs):
    for rank, rec in enumerate(procs):
        assert rec["sum"] == 52.0
        np.testing.assert_array_equal(rec["broadcast"]["a"], [42.0])
        assert torch.equal(rec["broadcast"]["b"][0], torch.tensor([1.0]))
        np.testing.assert_array_equal(rec["back"].numpy(),
                                      np.arange(4.0) + 10 * rank)
        assert rec["replicated"] == ()


def test_dp_train_step_equals_one_process(procs):
    """Two SGD steps at dp = 2, one sequence a process, equal JAX's
    ``make_train_step`` on the whole batch on one device (the same seed-0
    parameters and tokens, dense ring blocks on the JAX side)."""
    make, sizes = worker.TRAIN_SIZES["gpt2"]
    jcfg = dataclasses.replace(getattr(jtfm, make)(**sizes),
                               dtype=jnp.float32, use_flash=False)
    init = worker.train_init("gpt2", worker.train_config("gpt2"))
    jp = jtfm.stage_slice(jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                                       init), 1)
    step, _ = jtrain.make_train_step(jcfg, jmesh({"dp": 1, "pp": 1,
                                                  "tp": 1}),
                                     worker.TRAIN_M, lr=0.1)
    tokens, targets = (jnp.asarray(t.astype(np.int32))
                       for t in worker.train_batch())
    losses = []
    for _ in range(2):
        loss, jp = step(jp, tokens, targets)
        losses.append(float(loss))
    jp = jax.device_get(jp)
    want = [jp[k] for k in jp if k != "layers"] + list(jp["layers"].values())
    for rec in procs:
        np.testing.assert_allclose(rec["losses"], losses, rtol=1e-5)
        got = rec["params"]
        got = [got[k] for k in jp if k != "layers"] + [
            got["layers"][k] for k in jp["layers"]]
        for a, b in zip(got, want, strict=True):
            np.testing.assert_allclose(a.detach().numpy(), b, atol=1e-5,
                                       rtol=1e-4)
    for a, b in zip(*(ttrain.param_leaves(r["params"]) for r in procs)):
        assert torch.equal(a, b)


def test_no_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("ACX_COORDINATOR", raising=False)
    mh.initialize()
    assert mh.process_count() == 1 and mh.process_index() == 0
    mh.sync()
    x = {"a": np.ones(2)}
    assert mh.broadcast_from_host0(x) is x
    assert mh.global_mesh({"dp": 1}).shape == {"dp": 1}
    with pytest.raises(ValueError, match="needs 2 ranks, the job has 1"):
        mh.global_mesh({"dp": 2})
    with pytest.raises(ValueError, match="need 2 local devices"):
        mh.hybrid_mesh({"ici": 2})


@pytest.mark.parametrize("missing", ["count", "id"])
def test_coordinator_without_count_or_id_raises(monkeypatch, missing):
    monkeypatch.setenv("ACX_COORDINATOR", "file:///nonexistent/rdv")
    for k in ("ACX_NPROCS", "ACX_SIZE", "ACX_PROC_ID", "ACX_RANK"):
        monkeypatch.delenv(k, raising=False)
    if missing == "id":
        monkeypatch.setenv("ACX_SIZE", "2")
    with pytest.raises(ValueError, match=f"the process {missing}"):
        mh.initialize()


def test_a_peer_that_never_joins_raises_naming_the_triple(tmp_path):
    """Rank 0 of 2 alone: the rendezvous gives up after
    ACX_INIT_TIMEOUT_S and the error names coordinator, nprocs, proc."""
    rdv = tmp_path / "rdv"
    env = dict(os.environ, ACX_COORDINATOR=f"file://{rdv}", ACX_SIZE="2",
               ACX_RANK="0", ACX_INIT_TIMEOUT_S="2")
    for k in ("ACX_NPROCS", "ACX_PROC_ID"):
        env.pop(k, None)
    res = subprocess.run(
        [sys.executable, "-c", "from mpi_acx_torch.parallel import "
         "multihost as m; m.initialize()"], env=env, cwd=worker.REPO,
        capture_output=True, text=True, timeout=60)
    assert res.returncode != 0
    assert (f"multihost initialize failed (coordinator=file://{rdv}, "
            f"nprocs=2, proc=0, backend=gloo)") in res.stderr


@pytest.mark.parametrize("attempts,backoff", [(None, None), (1, 50.0),
                                              (8, 300.0), (3, 5.0)])
def test_budgets_equal_jax(attempts, backoff):
    assert mh.recovery_budget_s(attempts, backoff) == \
        jmh.recovery_budget_s(attempts, backoff)
    assert mh.fleet_join_budget_s(backoff) == \
        jmh.fleet_join_budget_s(backoff)


def test_fleet_snapshot_reads_the_runtime():
    class _Rt:
        def fleet_epoch(self):
            return 3

        def fleet_view(self):
            return [2, 2]

        def fleet_stats(self):
            return {"joins": 1}
    assert mh.fleet_snapshot(_Rt()) == jmh.fleet_snapshot(_Rt())


@pytest.mark.parametrize("module", ["parallel/multihost", "parallel/quantized",
                                    "parallel/collective", "parallel/mesh",
                                    "parallel/ring_attention"])
def test_parallel_modules_keep_the_jax_names(module):
    """Every public function of the JAX module is in the port, its
    parameters JAX's (the port may add some after them: ``initialize``'s
    ``backend``)."""
    import ast
    import importlib
    import inspect
    tree = ast.parse((worker.REPO / "mpi_acx_tpu" / f"{module}.py")
                     .read_text())
    port = importlib.import_module("mpi_acx_torch." + module.replace(
        "/", "."))
    checked = 0
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith("_"):
            a = node.args
            want = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
            got = list(inspect.signature(getattr(port, node.name))
                       .parameters)
            assert got[:len(want)] == want, node.name
            checked += 1
    assert checked
