"""The port's parallel layer (mpi_acx_torch/parallel) on a one-rank
mesh, held against the JAX package under ``shard_map`` on a mesh of size
1: the mesh, the axis collectives, ring attention and the GPipe pipeline.

Inputs are made from a seed with numpy. On the flash branch the JAX ring
runs ``flash_attention_lse`` in Pallas interpret mode and the port B10's
plain version; on the dense branch both run dense blocks. Tolerance: both
sides in float32, differing in summation order: 1e-5 on values, 2e-5 on
gradients.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.parallel import collective as jcol
from mpi_acx_tpu.parallel import pipeline as jpipe
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch.parallel import collective as tcol
from mpi_acx_torch.parallel import pipeline as tpipe
from mpi_acx_torch.parallel import ring_attention as tring
from mpi_acx_torch.parallel.mesh import Mesh, mesh_from_devices as tmesh

# The JAX package's parallel/__init__ exports a function of this name.
jring = importlib.import_module("mpi_acx_tpu.parallel.ring_attention")
TOL = 1e-5
GTOL = 2e-5


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=tol, rtol=tol)


def test_mesh_of_size_one_axes():
    mesh = tmesh({"dp": 1, "pp": 1, "tp": 1})
    assert dict(mesh.shape) == {"dp": 1, "pp": 1, "tp": 1}
    assert tmesh({"x": 1}, devices=[torch.device("cpu")]).shape == {"x": 1}
    with pytest.raises(ValueError, match="need 1 devices"):
        tmesh({"x": 1}, devices=[])


@pytest.mark.parametrize("axis", ["dp", "pp", "tp"])
def test_mesh_axis_above_one_raises(axis):
    """An axis of 2 needs a torch.distributed world of 2 ranks; this
    process has none, and the error names both numbers
    (tests/test_torch_mesh.py runs such meshes over gloo ranks)."""
    sizes = {"dp": 1, "pp": 1, "tp": 1, axis: 2}
    with pytest.raises(ValueError, match="spans 2 ranks but the "
                       "torch.distributed world has 1"):
        tmesh(sizes)


def test_collectives_are_the_identity_on_size_one_axes():
    x = torch.arange(6.0).reshape(2, 3)
    with tmesh({"dp": 1, "pp": 1, "tp": 1}):
        assert tcol.axis_size("tp") == 1 and tcol.axis_index("pp") == 0
        assert tcol.psum(x, "tp") is x and tcol.psum(x, ("pp", "tp")) is x
        assert tcol.pmean(x, "dp") is x
        assert tcol.all_gather(x, "tp", axis=1, tiled=True) is x
        assert tcol.all_gather(x, "tp", axis=1).shape == (2, 1, 3)
        assert tcol.ppermute(x, "tp", tcol._ring_perm(1, 1)) is x
        assert torch.equal(tcol.ppermute(x, "pp", []), torch.zeros_like(x))
    assert tcol._ACTIVE == []


COLLECTIVES = {
    "axis_size": lambda x: tcol.axis_size("tp"),
    "axis_index": lambda x: tcol.axis_index("tp"),
    "psum": lambda x: tcol.psum(x, ("pp", "tp")),
    "pmean": lambda x: tcol.pmean(x, "tp"),
    "all_gather": lambda x: tcol.all_gather(x, "tp", tiled=True),
    "ppermute": lambda x: tcol.ppermute(x, "tp", tcol._ring_perm(2, 1)),
}


@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_raise_above_size_one(name):
    """A mesh built by hand with an axis of 2 and no world of 2 ranks
    under it: refused before any collective could pretend to reduce or
    exchange."""
    with pytest.raises(ValueError, match="world has 1"):
        with Mesh({"pp": 1, "tp": 2}):
            COLLECTIVES[name](torch.zeros(3))


def test_collectives_need_an_active_mesh_and_a_known_axis():
    with pytest.raises(RuntimeError, match="no active mesh"):
        tcol.psum(torch.zeros(1), "tp")
    with tmesh({"tp": 1}), pytest.raises(NameError, match="'pp'"):
        tcol.axis_index("pp")


@pytest.mark.parametrize("n,shift", [(1, 1), (4, 1), (4, -1), (3, 2)])
def test_ring_perm_matches_jax(n, shift):
    assert tcol._ring_perm(n, shift) == jcol._ring_perm(n, shift)


def _jax_ring(q, k, v, causal, use_flash, kv_repeat=1):
    f = functools.partial(jring.ring_attention_batched, axis_name="x",
                          causal=causal, use_flash=use_flash,
                          kv_repeat=kv_repeat)
    return jax.jit(shard_map(f, mesh=jmesh({"x": 1}),
                             in_specs=(P(), P(), P()), out_specs=P(),
                             check_vma=False))


def _qkv(seed, S=32, H=2, Hkv=2, D=16, mb=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((mb, S, H, D), dtype=np.float32),
            rng.standard_normal((mb, S, Hkv, D), dtype=np.float32),
            rng.standard_normal((mb, S, Hkv, D), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("use_flash", [True, False])
def test_ring_attention_batched_matches_jax(use_flash, causal):
    """Values and gradients (random cotangent) of the size-1 ring, flash
    branch (B10's plain version / the JAX kernel) and dense blocks."""
    q, k, v = _qkv(1)
    do = np.random.default_rng(2).standard_normal(q.shape, dtype=np.float32)
    out_j, vjp = jax.vjp(_jax_ring(q, k, v, causal, use_flash),
                         *map(jnp.asarray, (q, k, v)))
    g_j = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with tmesh({"x": 1}):
        out_t = tring.ring_attention_batched(*xs, "x", causal=causal,
                                             use_flash=use_flash)
    out_t.backward(torch.from_numpy(do))
    assert out_t.dtype == torch.float32
    _close(out_t, out_j)
    for x, g in zip(xs, g_j):
        _close(x.grad, g, GTOL)


@pytest.mark.parametrize("use_flash", [True, False])
def test_ring_attention_grouped_kv_matches_jax(use_flash):
    q, k, v = _qkv(3, H=4, Hkv=2)
    want = _jax_ring(q, k, v, True, use_flash, kv_repeat=2)(
        *map(jnp.asarray, (q, k, v)))
    with tmesh({"x": 1}):
        got = tring.ring_attention_batched(
            *map(torch.from_numpy, (q, k, v)), "x", use_flash=use_flash,
            kv_repeat=2)
    _close(got, want)


def test_ring_attention_none_takes_dense_blocks_on_the_cpu(monkeypatch):
    """use_flash=None on a CPU tensor runs the dense blocks (the kernel is
    for a CUDA tensor); q in bf16 comes back in bf16."""
    called = []
    monkeypatch.setattr(tring, "flash_attention_lse",
                        lambda *a, **kw: called.append(1))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in _qkv(4))
    with tmesh({"x": 1}):
        out = tring.ring_attention_batched(q, k, v, "x")
    assert not called and out.dtype == torch.bfloat16


def test_ring_attention_3d_and_reference_match_jax():
    q, k, v = (x[0] for x in _qkv(5))
    f = shard_map(functools.partial(jring.ring_attention, axis_name="x",
                                    use_flash=True),
                  mesh=jmesh({"x": 1}), in_specs=(P(), P(), P()),
                  out_specs=P(), check_vma=False)
    want = f(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    with tmesh({"x": 1}):
        got = tring.ring_attention(tq, tk, tv, "x", use_flash=True)
    _close(got, want)
    for causal in (True, False):
        _close(tring.blockwise_attention_reference(tq, tk, tv, causal),
               jring.blockwise_attention_reference(
                   *map(jnp.asarray, (q, k, v)), causal))


def test_dense_block_matches_jax_with_fully_masked_rows():
    """Rows whose keys are all masked get zero output and the finfo.min
    lse sentinel, as in the JAX package."""
    q, k, v = _qkv(6, S=8)
    mask = np.tril(np.ones((8, 8), bool), k=-3)[None, None]   # rows 0-2 empty
    o_j, l_j = jring._dense_block(*map(jnp.asarray, (q, k, v)),
                                  jnp.asarray(mask))
    o_t, l_t = tring._dense_block(*map(torch.from_numpy, (q, k, v)),
                                  torch.from_numpy(mask))
    _close(o_t, o_j)
    _close(l_t, l_j)
    assert (l_t[:, :, :3] == tring._NEG).all()


@pytest.mark.parametrize("n_micro", [1, 3])
def test_pipeline_forward_matches_jax(n_micro):
    """pipeline_forward on a size-1 'pp' axis (one stage of two tanh
    layers) against the JAX schedule under shard_map: values and
    gradients of the stage parameters and the inputs."""
    rng = np.random.default_rng(n_micro)
    w = rng.standard_normal((1, 2, 8, 8), dtype=np.float32) * 0.3
    xs = rng.standard_normal((n_micro, 2, 5, 8), dtype=np.float32)
    ct = rng.standard_normal(xs.shape, dtype=np.float32)

    def jstage(p, x):
        for i in range(2):
            x = jnp.tanh(x @ p["w"][i])
        return x

    def tstage(p, x):
        for i in range(2):
            x = torch.tanh(x @ p["w"][i])
        return x

    f = jax.jit(shard_map(
        lambda p, x: jpipe.pipeline_forward(jstage, p, x, "pp"),
        mesh=jmesh({"pp": 1}), in_specs=({"w": P("pp")}, P()),
        out_specs=P(), check_vma=False))
    out_j, vjp = jax.vjp(f, {"w": jnp.asarray(w)}, jnp.asarray(xs))
    gp_j, gx_j = vjp(jnp.asarray(ct))
    tw, txs = (torch.from_numpy(a).requires_grad_() for a in (w, xs))
    with tmesh({"pp": 1}):
        out_t = tpipe.pipeline_forward(tstage, {"w": tw}, txs, "pp")
    out_t.backward(torch.from_numpy(ct))
    assert out_t.shape == xs.shape
    _close(out_t, out_j)
    _close(tw.grad, gp_j["w"], GTOL)
    _close(txs.grad, gx_j, GTOL)
