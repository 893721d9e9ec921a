"""Tensor-parallel speculative decoding across ranks
(``make_tp_speculative_generate`` of mpi_acx_torch/parallel/tp_inference.py,
through ``models.speculative._make_run``'s ``ops``): two gloo ranks on a
{"tp": 2} mesh, greedy, a 2-layer target with a 1-layer draft of its own
family (seed 7), k = 4, 14 new tokens, GPT-2 and Llama (split by KV
group), one row and two rows. Every rank's tokens, rounds and accepted
counts equal the JAX package's ``make_tp_speculative_generate`` on a
2-device CPU mesh, f32 (its B = 2 form is a vmap of the one-row loop; the
port runs the rows together, each row's run its own).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_acx_tpu.parallel import tp_inference as jtp
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker
from tests.test_torch_tp_inference import JAX_MODULES, np_tree

N = 2


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.start("tp_spec", N, tmp_path_factory.mktemp("tp_spec"))


def jax_side(family, seed, **kw):
    cfg, params = worker.tp_model(family, seed=seed, **kw)
    make, sizes = worker.TP_SIZES[family]
    jcfg = getattr(JAX_MODULES[family], make)(**{**sizes, **kw})
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.float32})
    return jcfg, jax.tree.map(jnp.asarray, np_tree(params))


@functools.lru_cache(maxsize=None)
def jax_generate(family):
    jcfg, params = jax_side(family, 0)
    dcfg, dparams = jax_side(family, 7, n_layers=1)
    gen = jtp.make_tp_speculative_generate(
        dcfg, jcfg, jmesh({"tp": N}, jax.devices()[:N]), worker.TP_SPEC_NEW,
        k=worker.TP_SPEC_K)
    return lambda prompt: gen(dparams, params, prompt, jax.random.key(0))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_tokens_and_stats_equal_jax_on_every_rank(ranks, family, rows):
    prompt = jnp.asarray(worker.tp_prompt(rows).numpy().astype(np.int32))
    toks, stats = jax_generate(family)(prompt)
    got = ranks.result()
    for r in range(N):
        mine = got[r][(family, rows)]
        np.testing.assert_array_equal(mine["tokens"].numpy(),
                                      np.asarray(toks), err_msg=f"rank {r}")
        np.testing.assert_array_equal(
            np.atleast_1d(mine["rounds"].numpy()),
            np.atleast_1d(np.asarray(stats["rounds"])))
        np.testing.assert_array_equal(
            np.atleast_1d(mine["accepted"].numpy()),
            np.atleast_1d(np.asarray(stats["drafted_accepted"])))
