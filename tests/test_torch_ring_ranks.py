"""Ring attention across ranks (mpi_acx_torch/parallel/ring_attention.py):
``ring_attention_batched`` over a ring of 2 and of 4 gloo ranks, causal
and not, through the flash branch (B10's plain version on the CPU, whose
blockwise backward takes the nonzero lse cotangent of the merge) and the
dense blocks: the output and dq, dk, dv under a random cotangent, held
against the JAX package's ring (dense blocks) inside
``shard_map(check_vma=False)`` on the 8-device CPU mesh.

The two rings run on meshes {"b": 4, "x": 2} and {"b": 2, "x": 4} of the
same eight ranks, each "b" row an independent ring. In the causal rings
every rank but the last skips a block, and its tie keeps the K/V
ppermute's backward running there. K and V travel stacked in one message
a step; a K cotangent taken for V's would fail dk and dv here. Tolerances
of tests/test_torch_parallel.py: 1e-5 on values, 2e-5 on gradients.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker

# The JAX package's parallel/__init__ exports a function of this name.
jring = importlib.import_module("mpi_acx_tpu.parallel.ring_attention")
N = 8
TOL, GTOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch("ring", N, tmp_path_factory.mktemp("ring"))


@functools.lru_cache(maxsize=None)
def jax_ring(ring, causal):
    """Output and (dq, dk, dv) of the JAX ring, per rank."""
    shape = worker.RING_MESHES[ring]
    spec = P(tuple(shape))
    f = functools.partial(jring.ring_attention_batched, axis_name="x",
                          causal=causal, use_flash=False)
    fn = jax.jit(shard_map(lambda q, k, v: f(q[0], k[0], v[0])[None],
                           mesh=jmesh(shape), in_specs=(spec,) * 3,
                           out_specs=spec, check_vma=False))
    qkv = [jnp.asarray(worker.rng_array(400 + ring * 10 + j,
                                        (N,) + worker.RING_SHAPE))
           for j in range(3)]
    ct = jnp.asarray(worker.rng_array(500 + ring, (N,) + worker.RING_SHAPE))
    y, vjp = jax.vjp(fn, *qkv)
    return np.asarray(y), [np.asarray(g) for g in vjp(ct)]


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("causal", [True, False],
                         ids=["causal", "noncausal"])
@pytest.mark.parametrize("ring", sorted(worker.RING_MESHES))
def test_ring_attention_across_ranks_matches_jax(ranks, ring, causal,
                                                 flash):
    y, grads = jax_ring(ring, causal)
    for r in range(N):
        got = ranks[r][(ring, causal, flash)]
        np.testing.assert_allclose(got["y"].numpy(), y[r], atol=TOL,
                                   rtol=TOL, err_msg=f"rank {r}")
        for name, g, want in zip("qkv", got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), want[r], atol=GTOL,
                                       rtol=GTOL,
                                       err_msg=f"d{name} rank {r}")


def test_dk_and_dv_are_told_apart(ranks):
    """The held gradients distinguish K's from V's: swapped, they miss."""
    _, grads = jax_ring(2, False)
    got = ranks[1][(2, False, True)]["grads"]
    assert not np.allclose(got[1].numpy(), grads[2][1], atol=GTOL)
    assert not np.allclose(got[2].numpy(), grads[1][1], atol=GTOL)


@pytest.mark.parametrize("ring", sorted(worker.RING_MESHES))
def test_ring_attention_sharded_is_the_per_rank_block(ranks, ring):
    """``ring_attention_sharded`` on a rank's [S / n, H, D] blocks gives
    that rank's block of JAX's ring output."""
    y, _ = jax_ring(ring, True)
    for r in range(N):
        np.testing.assert_allclose(ranks[r][("sharded", ring)].numpy(),
                                   y[r][0], atol=TOL, rtol=TOL)
