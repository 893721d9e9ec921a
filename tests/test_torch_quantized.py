"""The int8 quantized all-reduce (mpi_acx_torch/parallel/quantized.py)
against the JAX package's ``parallel/quantized.py``.

The block quantizer: codes and scales bit-equal to JAX's ``_quant`` under
``jit`` (where XLA multiplies the block max by the f32 reciprocal of 127)
on the same inputs. Across ranks: one job of eight gloo ranks computes
``quantized_psum`` over dp (a ring of 2 on the 2x2x2 mesh) and over an
8-ring at tests/test_quantized.py's shapes, leaves small enough for the
exact fallback, zeros, ``quantized_pmean`` and ``ring_psum`` with raw f32
hops; each held to JAX's under ``shard_map`` on the 8-device CPU mesh
within 1e-6, absolute and relative (gloo's exact sum and XLA's add in
other orders), with every rank's result bit-identical to its ring peers',
and within the JAX package's own
error bounds of the exact sum (max < 2.5%, mean < 0.4% of the max-norm).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.parallel import quantized as jq
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch.parallel import quantized as tq
from tests import torch_rank_worker as worker

N = 8
MESHES = {"dp": (worker.MESH3, "dp"), "x8": ({"x": N}, "x")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch("quantized", N, tmp_path_factory.mktemp("quant"))


@pytest.mark.parametrize("scale", [1.0, 1e-3, 0.0])
@pytest.mark.parametrize("c", [128, 1024])
def test_block_codes_and_scales_equal_jitted_jax(c, scale):
    x = worker.rng_array(7 + c, (c,))
    x[:5] = [0.5, -0.5, 1.5, 127.0, -126.5]      # halfway cases, the max
    x *= np.float32(scale)
    q, s = tq._quant(torch.from_numpy(x))
    jqc, js = jax.jit(lambda v: jq._quant(v, 127.0))(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jqc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q.dtype == torch.int8 and s.dtype == torch.float32


def jax_per_rank(fn, label):
    shape, _ = MESHES[label]
    spec = P(tuple(shape))
    return jax.jit(shard_map(lambda x: fn(x[0])[None], mesh=jmesh(shape),
                             in_specs=spec, out_specs=spec,
                             check_vma=False))


def _check(ranks, key, want):
    """Each rank's result within 1e-6 of JAX's (absolute and relative:
    an 8-way sum reaches 9, where one f32 ulp is 1e-6), and bit-equal to
    its ring peers' (dp: rank r and r ^ 4; the 8-ring: all)."""
    got = np.stack([r[key].numpy() for r in ranks])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6,
                               rtol=1e-6, err_msg=str(key))
    for r in range(N):
        np.testing.assert_array_equal(got[r], got[r ^ 4 if key[0] == "dp"
                                                 else 0])
    return got


@pytest.mark.parametrize("shape", worker.QUANT_SHAPES, ids=str)
@pytest.mark.parametrize("label", sorted(MESHES))
def test_quantized_psum_across_ranks_matches_jax(ranks, label, shape):
    _, axis = MESHES[label]
    i = worker.QUANT_SHAPES.index(shape)
    x = worker.rng_array(600 + i, (N,) + shape)
    want = jax_per_rank(lambda v: jq.quantized_psum(v, axis), label)(
        jnp.asarray(x))
    got = _check(ranks, (label, shape), want)
    # Each rank's exact sum over its ring (dp: ranks r and r ^ 4).
    ring_sum = (x[[r ^ 4 for r in range(N)]] + x if label == "dp"
                else np.broadcast_to(x.sum(0), x.shape))
    scale = np.abs(ring_sum).max() + 1e-6
    diff = np.abs(got - ring_sum)
    assert diff.max() / scale < 0.025
    assert diff.mean() / scale < 0.004


@pytest.mark.parametrize("label", sorted(MESHES))
def test_exact_ring_pmean_and_zeros_match_jax(ranks, label):
    _, axis = MESHES[label]
    x = jnp.asarray(worker.rng_array(600, (N,) + worker.QUANT_SHAPES[0]))
    _check(ranks, (label, "exact_ring"), jax_per_rank(
        lambda v: jq.ring_psum(v, axis, quantize=False), label)(x))
    _check(ranks, (label, "pmean"), jax_per_rank(
        lambda v: jq.quantized_pmean(v, axis), label)(x))
    got = np.stack([r[(label, "zeros")].numpy() for r in ranks])
    np.testing.assert_array_equal(got, np.zeros((N, 2048), np.float32))
    # The exact ring is the psum up to summation order.
    np.testing.assert_allclose(
        np.stack([r[(label, "exact_ring")].numpy() for r in ranks]),
        np.asarray(jax_per_rank(lambda v: lax.psum(v, axis), label)(x)),
        atol=1e-5, rtol=1e-6)
