"""The partitioned exchange across ranks
(mpi_acx_torch/parallel/partitioned.py): tests/test_partitioned.py's
cases on a ring of four gloo ranks, held exactly against the JAX
package's ``partitioned_ring_exchange`` and ``partitioned_pipeline`` under
``shard_map`` on a 4-device CPU mesh: a 48-row arange in 4 partitions
(each rank receives its left neighbour's block), ones in 2 partitions
with a consumer that triples them, and the pipeline of 5 partitions whose
rank r produces r * 100 + k.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.parallel import (make_mesh, partitioned_pipeline,
                                  partitioned_ring_exchange)
from tests import torch_rank_worker as worker

N = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.start("partitioned", N,
                        tmp_path_factory.mktemp("partitioned"))


@functools.lru_cache(maxsize=None)
def jax_results():
    mesh = make_mesh(N)

    def run(body, x):
        return np.asarray(shard_map(body, mesh=mesh, in_specs=(P("x"),),
                                    out_specs=P("x"))(x))

    ident = run(lambda s: partitioned_ring_exchange(s, "x", partitions=4),
                jnp.arange(12 * N, dtype=jnp.float32).reshape(12 * N, 1))
    cons = run(lambda s: partitioned_ring_exchange(
        s, "x", partitions=2, consume=lambda c: c * 3.0),
        jnp.ones((4 * N, 2), jnp.float32))

    def pipe(dummy):
        r = lax.axis_index("x").astype(jnp.float32)
        acc = partitioned_pipeline(lambda k: jnp.full((3,), r * 100.0 + k),
                                   lambda a, p: a + p,
                                   jnp.zeros((3,), jnp.float32), 5, "x")
        return acc[None] + 0.0 * dummy

    return {"identity": ident.reshape(N, 12, 1),
            "consumer": cons.reshape(N, 4, 2),
            "pipeline": run(pipe, jnp.zeros((N, 3), jnp.float32))}


@pytest.mark.parametrize("name", ["identity", "consumer", "pipeline"])
def test_each_rank_equals_jax(ranks, name):
    want = jax_results()[name]
    got = ranks.result()
    for r in range(N):
        np.testing.assert_array_equal(got[r][name].numpy(), want[r],
                                      err_msg=f"rank {r}")
    if name == "identity":
        xs = np.arange(12 * N, dtype=np.float32).reshape(N, 12, 1)
        np.testing.assert_array_equal(want, np.roll(xs, 1, axis=0))
