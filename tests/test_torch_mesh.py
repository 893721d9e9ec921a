"""The port's mesh over ranks (mpi_acx_torch/parallel/mesh.py) and the
train step's layout on it (``train.param_specs`` and its kin,
``shard_params``, ``shard_batch``, ``unshard_params``), against the JAX
package's device mesh and ``NamedSharding``.

One job of eight gloo ranks (tests/torch_rank_worker.py ``mesh``) builds
the 2x2x2 ('dp', 'pp', 'tp') mesh, the 8-ring of ``make_mesh()`` and a
2x4 mesh: each rank's coordinates must be its device's position in the
JAX mesh of the same axes (row-major over the sizes), each line group
the ranks of that line, a psum over all axes the sum of the ranks; an
all-ones mesh is the identity, and a mesh of 4 over a world of 8 is
refused naming both. In this process: the specs equal JAX's, and each
rank's shard of the parameters and of the batch equals the block JAX
places on that device; ``unshard_params`` inverts ``shard_params``.
"""

import itertools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel.mesh import Mesh, PartitionSpec, make_mesh
from tests import torch_rank_worker as worker

N = 8
MESHES = {"dp_pp_tp": worker.MESH3, "ring": {"x": N}, "rc": worker.MESH_RC}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.launch("mesh", N, tmp_path_factory.mktemp("mesh"))


def jax_position(shape, rank):
    devices = np.vectorize(lambda d: d.id)(jmesh(shape).devices)
    return dict(zip(shape, (int(i) for i in np.argwhere(devices == rank)[0])))


@pytest.mark.parametrize("label", sorted(MESHES))
def test_rank_coordinates_and_lines_follow_the_jax_mesh(ranks, label):
    shape = MESHES[label]
    names = list(shape)
    for r in range(N):
        rec = ranks[r][label]
        assert rec["coords"] == jax_position(shape, r)
        assert rec["index"] == rec["coords"]
        assert rec["sizes"] == shape
        assert rec["rank_sum"] == sum(range(N))
        for k in range(1, len(names) + 1):
            for axes in itertools.combinations(names, k):
                want = [q for q in range(N) if all(
                    jax_position(shape, q)[a] == rec["coords"][a]
                    for a in names if a not in axes)]
                assert rec["lines"]["/".join(axes)] == want


def test_all_ones_mesh_and_refusal(ranks):
    for r in range(N):
        assert ranks[r]["ones"]["rank_sum"] == r
        assert ranks[r]["ones"]["lines"] == {}
        assert ranks[r]["refusal"] == ("mesh {'x': 4} spans 4 ranks but the "
                                       "torch.distributed world has 8")


def test_one_process_meshes():
    assert make_mesh().shape == {"x": 1}
    assert Mesh({"a": 1, "b": 1}).coords == {"a": 0, "b": 0}
    with pytest.raises(ValueError, match="size 0"):
        Mesh({"x": 0})
    spec = PartitionSpec("pp", None, "tp")
    assert spec == ("pp", None, "tp") and repr(spec) == \
        "PartitionSpec('pp', None, 'tp')"


@pytest.mark.parametrize("fam", ["param_specs", "llama_param_specs",
                                 "moe_param_specs"])
def test_specs_equal_jax(fam):
    for stage in (True, False):
        want = getattr(jtrain, fam)(stage)
        got = getattr(ttrain, fam)(stage)
        assert jax.tree.map(tuple, want,
                            is_leaf=lambda x: isinstance(x, P)) == \
            jax.tree.map(tuple, got, is_leaf=lambda x: isinstance(
                x, PartitionSpec))


def fake_mesh(shape, rank):
    """A stand-in carrying what sharding reads: the shape and rank
    ``rank``'s coordinates."""
    return types.SimpleNamespace(shape=shape,
                                 coords=jax_position(shape, rank))


@pytest.mark.parametrize("n_virtual", [1, 2])
def test_shards_are_the_jax_device_blocks(n_virtual):
    cfg = worker.train_config("gpt2")
    glob = worker.staged(worker.train_init("gpt2", cfg), 2, n_virtual)
    specs = ttrain.step_specs(cfg, n_virtual)
    jm = jmesh(worker.MESH3)
    shards = {r: ttrain.shard_params(glob, specs, fake_mesh(worker.MESH3, r))
              for r in range(N)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(glob):
        keys = [p.key for p in path]
        spec = specs
        for k in keys:
            spec = spec[k]
        placed = jax.device_put(jnp.asarray(leaf.numpy()),
                                NamedSharding(jm, P(*spec)))
        for s in placed.addressable_shards:
            got = shards[s.device.id]
            for k in keys:
                got = got[k]
            np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))
    back = ttrain.unshard_params(shards, specs, worker.MESH3)
    for a, b in zip(ttrain.param_leaves(back), ttrain.param_leaves(glob)):
        assert torch.equal(a, b)
    # Only the reading copies are needed.
    needed = {0, 1, 2, 3}
    back = ttrain.unshard_params({r: shards[r] for r in needed}, specs,
                                 worker.MESH3)
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.param_leaves(back), ttrain.param_leaves(glob)))


def test_batch_shard_is_the_jax_dp_block():
    tokens, _ = worker.train_batch()
    jm = jmesh(worker.MESH3)
    placed = jax.device_put(jnp.asarray(tokens.astype(np.int32)),
                            NamedSharding(jm, P(None, "dp")))
    for s in placed.addressable_shards:
        got = ttrain.shard_batch(tokens, fake_mesh(worker.MESH3,
                                                   s.device.id))
        np.testing.assert_array_equal(got.numpy(), np.asarray(s.data))


def test_one_rank_shards_are_the_whole():
    cfg = worker.train_config("llama")
    glob = ttfm.stage_slice(worker.train_init("llama", cfg), 1)
    mesh = Mesh({"dp": 1, "pp": 1, "tp": 1})
    got = ttrain.shard_params(glob, ttrain.step_specs(cfg), mesh)
    assert all(torch.equal(a, b) for a, b in zip(
        ttrain.param_leaves(got), ttrain.param_leaves(glob)))
