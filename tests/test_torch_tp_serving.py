"""Tensor-parallel continuous batching across ranks
(``make_tp_server_fns`` of mpi_acx_torch/parallel/tp_inference.py under
the port's ``serve_greedy``): two gloo ranks on a {"tp": 2} mesh, every
rank running the same serve call, held against the JAX package's
``make_tp_server_fns`` under its ``serve_greedy`` on a 2-device CPU mesh,
f32, on tests/test_tp_inference.py's tiny configurations.

GPT-2, Llama (slots split by KV group) and the MoE transformer (auto
dispatch: the two-slot decode steps route sharded through all_to_all),
f32 and int8 KV slot caches (GPT-2 and Llama), at chunk 1 and 4:
five prompts of 3 to 8 tokens (one JAX prefill bucket) over two slots, so
slots retire and refill. Every rank's tokens equal JAX's exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_acx_tpu.models import serving as jserving
from mpi_acx_tpu.parallel import tp_inference as jtp
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker
from tests.test_torch_tp_inference import JAX_MODULES, jax_model

N = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.start("tp_serve", N, tmp_path_factory.mktemp("tp_serve"))


@functools.lru_cache(maxsize=None)
def jax_served(family, chunk, int8):
    jcfg, params = jax_model(family)
    params = jax.tree.map(jnp.asarray, params)
    mesh = jmesh({"tp": N}, jax.devices()[:N])
    fns = jtp.make_tp_server_fns(params, jcfg, mesh, chunk=chunk,
                                 family=family, kv_int8=int8)
    prompts, n_new = worker.tp_serve_requests()
    res = jserving.serve_greedy(
        params, jcfg, prompts, n_new, worker.TP_SERVE_SLOTS,
        worker.TP_SERVE_MAX_LEN, family=JAX_MODULES[family], chunk=chunk,
        server_fns=fns, kv_int8=int8)
    return [np.asarray(o) for o in res]


@pytest.mark.parametrize("family,chunk,int8", worker.TP_SERVES,
                         ids=[f"{f}-chunk{c}-{'int8' if q else 'f32'}"
                              for f, c, q in worker.TP_SERVES])
def test_served_tokens_equal_jax_on_every_rank(ranks, family, chunk, int8):
    want = jax_served(family, chunk, int8)
    got = ranks.result()
    prompts, n_new = worker.tp_serve_requests()
    for r in range(N):
        outs = got[r][(family, chunk, int8)]
        assert len(outs) == len(want)
        for rid, (g, w) in enumerate(zip(outs, want)):
            assert len(g) == len(prompts[rid]) + n_new[rid]
            np.testing.assert_array_equal(g, w,
                                          err_msg=f"request {rid} rank {r}")
