"""Ulysses sequence parallelism across ranks
(mpi_acx_torch/parallel/ulysses.py): four gloo ranks, on meshes {"b": 2,
"x": 2} and {"x": 4} of the same ranks (each "b" row its own 2-ring),
``ulysses_attention_sharded`` on each rank's sequence block of [S 64, H 8,
D 16] q/k/v, causal and not, held against the JAX package's
``ulysses_attention_sharded`` on 2- and 4-device CPU meshes (f32, 1e-5:
the local attention is K1's plain version here, JAX's auto policy there).
Heads not divisible by the axis raise JAX's assertion.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_tpu.parallel.ulysses import ulysses_attention_sharded
from tests import torch_rank_worker as worker

N = 4
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.start("ulysses", N, tmp_path_factory.mktemp("ulysses"))


@functools.lru_cache(maxsize=None)
def jax_out(ring, causal):
    mesh = jmesh({"x": ring}, jax.devices()[:ring])
    q, k, v = (jnp.asarray(t) for t in worker.ulysses_qkv(ring))
    return np.asarray(ulysses_attention_sharded(q, k, v, mesh, "x",
                                                causal=causal))


@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
@pytest.mark.parametrize("ring", sorted(worker.ULYSSES_MESHES))
def test_each_rank_block_equals_jax(ranks, ring, causal):
    want = jax_out(ring, causal)
    got = ranks.result()
    sq = worker.ULYSSES_SHAPE[0] // ring
    for r in range(N):
        c = r % ring
        np.testing.assert_allclose(got[r][(ring, causal)].numpy(),
                                   want[c * sq:(c + 1) * sq], **TOL,
                                   err_msg=f"rank {r}")


def test_heads_not_divisible_raise_jax_assertion(ranks):
    mesh = jmesh({"x": 4}, jax.devices()[:4])
    x = jnp.zeros((16, 2, 16))
    with pytest.raises(AssertionError) as info:
        ulysses_attention_sharded(x, x, x, mesh, "x")
    for r in range(N):
        assert ranks.result()[r]["refusal"] == \
            f"AssertionError: {info.value}"
