"""Expert parallelism with all_to_all across ranks
(mpi_acx_torch/models/moe.py and moe_transformer.py): four gloo ranks, on
meshes {"b": 2, "ep": 2} and {"ep": 4} of the same ranks, held against
the JAX package under ``shard_map`` on the 8-device CPU mesh, f32.

At ep = 2 and 4, top-1 and top-2, capacity factors 2.0 (tokens drop per
rank group) and 8.0: ``moe_layer`` and ``moe_layer_and_aux`` with
``ep_axis`` on each rank's token shard, ``moe_layer_sharded_dispatch`` on
tokens every rank holds, and one ``make_moe_train_step`` step; then
``param_specs`` and one ``make_moe_transformer_train_step`` step of the
tiny MoE transformer (top-2, capacity factor 2.0) at ep = 2 and 4. The
layer outputs agree within 1e-6, the router auxiliaries, losses and
gradients (read from each step's SGD update) within 1e-5; every rank
holds its own block.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.models import moe as jm
from mpi_acx_tpu.models import moe_transformer as jmt
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from tests import torch_rank_worker as worker
from tests.test_torch_tp_inference import np_tree

N = 4
YTOL = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)
LSPECS = {"gate": P(), "w1": P("ep"), "w2": P("ep")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return worker.start("ep", N, tmp_path_factory.mktemp("ep"))


def coord(r, ep):
    return r % ep


@functools.lru_cache(maxsize=None)
def jax_layer(ep, k, cf):
    """JAX's per-device y and aux (token shards), the sharded dispatch's
    output, and one train step's loss and gradients."""
    cfg, params = worker.ep_layer(k, cf)
    jcfg = jm.MoeConfig(d_model=16, d_ff=32, n_experts=8,
                        capacity_factor=cf, top_k=k)
    params = jax.tree.map(jnp.asarray, np_tree(params))
    mesh = jmesh({"ep": ep}, jax.devices()[:ep])
    x = jnp.asarray(worker.ep_tokens(11))
    tgt = jnp.asarray(worker.ep_tokens(12))

    def body(p, xs, xfull):
        y, aux = jm.moe_layer_and_aux(p, xs, jcfg, ep_axis="ep")
        ys = jm.moe_layer_sharded_dispatch(p, xfull, jcfg, "ep")
        return y, jnp.stack([aux["load_balance"], aux["router_z"]])[None], ys

    fwd = jax.jit(shard_map(body, mesh=mesh,
                            in_specs=(LSPECS, P("ep"), P()),
                            out_specs=(P("ep"), P("ep"), P()),
                            check_vma=False))
    y, aux, ys = fwd(params, x, x)
    loss, new = jm.make_moe_train_step(jcfg, mesh, "ep", lr=worker.EP_LR)(
        params, x, tgt)
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                         / worker.EP_LR, params, new)
    return np.asarray(y), np.asarray(aux), np.asarray(ys), float(loss), grads


def block(a, r, ep, dim=0):
    size = a.shape[dim] // ep
    return np.take(a, np.arange(r * size, (r + 1) * size), axis=dim)


@pytest.mark.parametrize("ep,k,cf", worker.EP_CASES)
def test_layer_and_step_equal_jax(ranks, ep, k, cf):
    y, aux, ys, loss, grads = jax_layer(ep, k, cf)
    got = ranks.result()
    for r in range(N):
        c = coord(r, ep)
        mine = got[r][("layer", ep, k, cf)]
        np.testing.assert_allclose(mine["y"].numpy(), block(y, c, ep),
                                   **YTOL, err_msg=f"rank {r}")
        np.testing.assert_array_equal(mine["y2"].numpy(), mine["y"].numpy())
        np.testing.assert_allclose(
            [mine["aux"]["load_balance"].item(),
             mine["aux"]["router_z"].item()], aux[c], **TOL)
        np.testing.assert_allclose(mine["sharded"].numpy(), ys, **YTOL)
        np.testing.assert_allclose(mine["loss"], loss, **TOL)
        np.testing.assert_allclose(mine["grads"]["gate"].numpy(),
                                   grads["gate"], **TOL)
        for key in ("w1", "w2"):
            np.testing.assert_allclose(mine["grads"][key].numpy(),
                                       block(grads[key], c, ep), **TOL,
                                       err_msg=f"{key} rank {r}")


def test_capacity_two_drops_tokens_per_group():
    """The tight cases are tight: at capacity factor 2.0 some rank group
    seats fewer tokens than routing asks for."""
    gates = worker.ep_tokens(11) @ np_tree(worker.ep_layer(2, 2.0)[1])[
        "gate"]
    T = worker.EP_T // 4
    cap = int(2.0 * T / 8 + 1)
    counts = [np.bincount(np.argsort(-g, axis=1)[:, :2].ravel(),
                          minlength=8).max()
              for g in np.split(gates, 4)]
    assert max(counts) > cap


@functools.lru_cache(maxsize=None)
def jax_model_step(ep):
    cfg, params = worker.ep_model()
    make, sizes = worker.TP_SIZES["moe"]
    jcfg = jmt.tiny_moe_config(**{**sizes, "top_k": 2,
                                  "capacity_factor": 2.0, "max_seq": 16})
    jcfg = type(jcfg)(**{**jcfg.__dict__, "dtype": jnp.float32})
    params = jax.tree.map(jnp.asarray, np_tree(params))
    tokens, targets = (jnp.asarray(t.numpy().astype(np.int32))
                       for t in worker.ep_batch(cfg))
    mesh = jmesh({"ep": ep}, jax.devices()[:ep])
    step = jmt.make_moe_transformer_train_step(jcfg, mesh, axis="ep",
                                               lr=worker.EP_LR)
    loss, new = step(params, tokens, targets)
    grads = jax.tree.map(lambda a, b: (np.asarray(a) - np.asarray(b))
                         / worker.EP_LR, params, new)
    return float(loss), grads


@pytest.mark.parametrize("ep", [2, 4])
def test_moe_transformer_train_step_equals_jax(ranks, ep):
    loss, grads = jax_model_step(ep)
    got = ranks.result()
    for r in range(N):
        mine = got[r][("model", ep)]
        np.testing.assert_allclose(mine["loss"], loss, **TOL)
        c = coord(r, ep)
        for key in ("embed", "pos", "lnf_g", "lnf_b"):
            np.testing.assert_allclose(mine["grads"][key].numpy(),
                                       grads[key], **TOL, err_msg=key)
        for key, g in mine["grads"]["layers"].items():
            want = grads["layers"][key]
            if key in ("w1", "w2"):
                want = block(want, c, ep, dim=1)
            np.testing.assert_allclose(g.numpy(), want, **TOL,
                                       err_msg=f"{key} rank {r}")


def test_param_specs_equal_jax(ranks):
    want = jmt.param_specs("dp")
    mine = ranks.result()[0]["specs"]
    assert set(mine) == set(want)
    for key in ("embed", "pos", "lnf_g", "lnf_b"):
        assert tuple(mine[key]) == tuple(want[key])
    assert {k: tuple(v) for k, v in mine["layers"].items()} == \
        {k: tuple(v) for k, v in want["layers"].items()}
