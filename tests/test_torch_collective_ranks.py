"""The port's axis collectives on eight gloo ranks (mpi_acx_torch/parallel/
collective.py), each and its vjp held against ``jax.vjp`` of the JAX
collective inside ``shard_map(check_vma=False)`` on the 8-device CPU mesh
(the transposes the JAX train step differentiates with): psum over one,
two and three axes, pmean, all_gather tiled and stacked, ppermute with and
without wrap-around, and ``parallel/collective.py``'s ring shift,
neighbour exchange, 1-D and 2-D halo exchange and ``all_to_all_seq``.

One job of eight ranks (tests/torch_rank_worker.py) computes every case;
rank r holds block r of each numpy-seeded input and cotangent, device r of
the JAX mesh the same block. Both sides in f32: atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax, shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.parallel import collective as jcol
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker

N = 8
ATOL = 1e-6

JAX = {
    "psum_tp": lambda x: lax.psum(x, "tp"),
    "psum_pp_tp": lambda x: lax.psum(x, ("pp", "tp")),
    "psum_dp_pp_tp": lambda x: lax.psum(x, ("dp", "pp", "tp")),
    "pmean_dp": lambda x: lax.pmean(x, "dp"),
    "all_gather_tiled_tp": lambda x: lax.all_gather(x, "tp", axis=1,
                                                    tiled=True),
    "all_gather_stacked_pp": lambda x: lax.all_gather(x, "pp", axis=0),
    "all_gather_stacked_dp_axis1": lambda x: lax.all_gather(x, "dp", axis=1),
    "ppermute_tp_ring": lambda x: lax.ppermute(x, "tp", [(0, 1), (1, 0)]),
    "ppermute_pp_forward": lambda x: lax.ppermute(x, "pp", [(0, 1)]),
    "ring_shift_1": lambda x: jcol.ring_shift(x, "x"),
    "ring_shift_-1": lambda x: jcol.ring_shift(x, "x", shift=-1),
    "ring_shift_3": lambda x: jcol.ring_shift(x, "x", shift=3),
    "neighbor_exchange": lambda x: jnp.concatenate(
        jcol.neighbor_exchange(x, 2 * x, "x")),
    "halo_exchange_1d": lambda x: jcol.halo_exchange_1d(x, "x", 2),
    "halo_exchange_2d": lambda x: jcol.halo_exchange_2d(x, "r", "c", 1),
    "all_to_all_seq": lambda x: jcol.all_to_all_seq(x, "x", split_axis=1,
                                                    concat_axis=0),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch("collectives", N,
                         tmp_path_factory.mktemp("collectives"))


def per_rank(fn, shape):
    """``fn`` on each device's block of a [N, ...] array (the mesh's
    devices in rank order), under shard_map with check_vma=False."""
    axes = tuple(shape)
    spec = P(axes)
    return jax.jit(shard_map(lambda x: fn(x[0])[None], mesh=jmesh(shape),
                             in_specs=spec, out_specs=spec,
                             check_vma=False))


def test_every_collective_has_a_jax_counterpart():
    assert sorted(JAX) == sorted(worker.COLLECTIVES)


@pytest.mark.parametrize("name", sorted(worker.COLLECTIVES))
def test_collective_and_its_vjp_match_jax(ranks, name):
    shape, xshape, _ = worker.COLLECTIVES[name]
    i = list(worker.COLLECTIVES).index(name)
    x = worker.rng_array(100 + i, (N,) + xshape)
    ct = np.stack([r[name]["ct"].numpy() for r in ranks])
    y, vjp = jax.vjp(per_rank(JAX[name], shape), jnp.asarray(x))
    (g,) = vjp(jnp.asarray(ct))
    for r in range(N):
        np.testing.assert_allclose(ranks[r][name]["y"].numpy(),
                                   np.asarray(y[r]), atol=ATOL, rtol=0,
                                   err_msg=f"{name} rank {r}")
        np.testing.assert_allclose(ranks[r][name]["grad"].numpy(),
                                   np.asarray(g[r]), atol=ATOL, rtol=0,
                                   err_msg=f"{name} vjp rank {r}")


def test_ppermute_vjp_routes_each_cotangent_home(ranks):
    """The pipeline's forward hop (0 -> 1, nothing back): stage 0 gets
    zeros, and the cotangent of stage 1's arrival lands on stage 0's
    input, stage 1's own input getting none."""
    rec = [r["ppermute_pp_forward"] for r in ranks]
    x = worker.rng_array(
        100 + list(worker.COLLECTIVES).index("ppermute_pp_forward"),
        (N, 2, 3))
    for r in range(N):
        pp = (r // 2) % 2
        if pp == 0:
            assert not rec[r]["y"].any()
            np.testing.assert_array_equal(rec[r]["grad"].numpy(),
                                          rec[r + 2]["ct"].numpy())
        else:
            np.testing.assert_array_equal(rec[r]["y"].numpy(), x[r - 2])
            assert not rec[r]["grad"].any()


def test_all_to_all_seq_round_trip(ranks):
    """tests/test_collective.py's case: sequence-sharded to head-sharded
    and back is the identity; the head-sharded block equals JAX's."""
    x = np.arange(N * 2 * 8 * 4, dtype=np.float32).reshape(N, 2, 8, 4)
    heads = per_rank(JAX["all_to_all_seq"], {"x": N})(jnp.asarray(x))
    for r in range(N):
        rec = ranks[r]["all_to_all_round_trip"]
        np.testing.assert_array_equal(rec["back"].numpy(), x[r])
        np.testing.assert_array_equal(rec["heads"].numpy(),
                                      np.asarray(heads[r]))


def test_sharded_wrappers_give_each_rank_its_block(ranks):
    x = worker.rng_array(300, (N, 6, 3))
    for r in range(N):
        np.testing.assert_array_equal(ranks[r]["ring_shift_sharded"].numpy(),
                                      x[(r - 1) % N])
        padded = ranks[r]["halo_exchange_1d_sharded"].numpy()
        assert padded.shape == (1, 10, 3)
        np.testing.assert_array_equal(padded[0, 2:-2], x[r])
        np.testing.assert_array_equal(padded[0, :2], x[(r - 1) % N][-2:])
        np.testing.assert_array_equal(padded[0, -2:], x[(r + 1) % N][:2])
