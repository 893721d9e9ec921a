"""The port's MoE layer (mpi_acx_torch/models/moe.py) held against the JAX
package's (mpi_acx_tpu/models/moe.py) on the CPU.

Router logits and tokens come from numpy seeds, the layer's weights from
``jax.random`` crossed as numpy. Routing is held exactly: the dispatch
tensor bit for bit, for top-1 and top-2 at capacity factors 1.0 and 2.0
(where tokens past an expert's capacity are dropped, which ``F.one_hot``
would refuse) and at the drop-free factor E; ties between two gate
columns go to the lower expert, as ``lax.top_k`` sends them. Values agree
within 1e-6 (combine) and 1e-5 (the layer, its auxiliaries): f32, the
same math in another summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import moe as jm
from mpi_acx_torch.models import moe as tm
from mpi_acx_torch.models import moe_transformer as tmt
from mpi_acx_torch.parallel.mesh import mesh_from_devices

TOL = dict(rtol=1e-5, atol=1e-5)
T, E = 48, 8


def _gates(seed, skew=True):
    """[T, E] router logits; ``skew`` favours expert 3, so capacity
    bites."""
    g = np.random.default_rng(seed).standard_normal((T, E)).astype(
        np.float32)
    if skew:
        g[:, 3] += 1.0
    return g


def _np(x):
    return x.detach().numpy()


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 2.0, float(E)])
def test_dispatch_and_combine_match_jax(k, cf):
    gates = _gates(k)
    cap = int(cf * T / E + 1)
    jd, jc = jm._dispatch_tensors(jnp.asarray(gates), cap, k)
    td, tc = tm._dispatch_tensors(torch.from_numpy(gates), cap, k)
    assert td.shape == (T, E, cap) and td.dtype == torch.float32
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    seated = int(td.sum())
    if cf < E:
        assert seated < T * k            # tokens were dropped
    else:
        assert seated == T * k           # none was
    # Every seat holds at most one token.
    assert td.sum(0).max() <= 1


def test_token_past_capacity_gets_zero_rows():
    """Every token prefers expert 0; capacity 3 seats the first three in
    row order and drops the rest (zero dispatch and combine rows)."""
    gates = np.zeros((6, 4), np.float32)
    gates[:, 0] = 2.0
    jd, jc = jm._dispatch_tensors(jnp.asarray(gates), 3, 1)
    td, tc = tm._dispatch_tensors(torch.from_numpy(gates), 3, 1)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    np.testing.assert_allclose(_np(tc), np.asarray(jc), rtol=0, atol=1e-6)
    assert td[:3, 0].tolist() == torch.eye(3).tolist()
    assert not td[3:].any() and not tc[3:].any()


@pytest.mark.parametrize("k", [1, 2])
def test_exact_tie_goes_to_the_lower_expert(k):
    """Gate columns 2 and 5 equal and largest in every row: top-1 picks 2,
    top-2 picks 2 then 5, as lax.top_k orders them."""
    gates = _gates(7, skew=False)
    gates[:, 5] = gates[:, 2] = np.abs(gates).max() + 1.0
    cap = int(2.0 * T / E + 1)
    jd, _ = jm._dispatch_tensors(jnp.asarray(gates), cap, k)
    td, _ = tm._dispatch_tensors(torch.from_numpy(gates), cap, k)
    np.testing.assert_array_equal(_np(td), np.asarray(jd))
    per_expert = _np(td.sum((0, 2)))
    assert per_expert[2] == min(T, cap)
    assert per_expert[5] == (min(T, cap) if k == 2 else 0)
    np.testing.assert_allclose(
        _np(tm.load_balance_loss(torch.from_numpy(gates), k)),
        np.asarray(jm.load_balance_loss(jnp.asarray(gates), k)), **TOL)


def test_tied_gate_columns_route_as_jax_in_the_layer():
    """Two identical columns of the gate weights: values exact in f32 (so
    the two logits tie bit for bit whatever the summation order), and the
    whole layer routes as JAX's."""
    rng = np.random.default_rng(3)
    cfg = jm.MoeConfig(d_model=16, d_ff=32, n_experts=4, capacity_factor=2.0)
    x = (rng.integers(-8, 8, (T, 16)) / 8).astype(np.float32)
    gate = rng.integers(-2, 3, (16, 4)).astype(np.float32)
    gate[:, 3] = gate[:, 1]
    x += np.sign(gate[:, 1]) / 2                 # lean towards 1 and 3
    p = jax.device_get(jm.init_moe_params(jax.random.key(0), cfg))
    p = dict(p, gate=gate)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    g = torch.from_numpy(x) @ tp["gate"]
    assert torch.equal(g[:, 1], g[:, 3])
    assert (g.argmax(-1) == 1).sum() > 0           # the tie decides rows
    tcfg = tm.MoeConfig(**dataclasses.asdict(cfg))
    y, aux = tm.moe_layer_and_aux(tp, torch.from_numpy(x), tcfg)
    jy, jaux = jm.moe_layer_and_aux(p, jnp.asarray(x), cfg)
    np.testing.assert_allclose(_np(y), np.asarray(jy), **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **TOL)


@pytest.mark.parametrize("k", [1, 2])
def test_router_losses_match_jax(k):
    gates = _gates(10 + k) * 3
    np.testing.assert_allclose(
        float(tm.load_balance_loss(torch.from_numpy(gates), k)),
        float(jm.load_balance_loss(jnp.asarray(gates), k)), **TOL)
    np.testing.assert_allclose(
        float(tm.router_z_loss(torch.from_numpy(gates))),
        float(jm.router_z_loss(jnp.asarray(gates))), **TOL)


def _layer(seed, k, cf, dtype=jnp.float32):
    cfg = jm.MoeConfig(d_model=32, d_ff=64, n_experts=E, capacity_factor=cf,
                       top_k=k)
    p = jax.tree.map(lambda a: a.astype(dtype),
                     jm.init_moe_params(jax.random.key(seed), cfg))
    x = np.random.default_rng(seed).standard_normal((T, 32)).astype(
        np.float32)
    tp = tmt.params_from_jax(jax.device_get(p), device="cpu")
    return cfg, tm.MoeConfig(**dataclasses.asdict(cfg)), p, tp, x


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 2.0, float(E)])
def test_moe_layer_and_aux_match_jax(k, cf):
    jcfg, tcfg, jp, tp, x = _layer(k, k, cf)
    y = tm.moe_layer(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(y), np.asarray(jm.moe_layer(
        jp, jnp.asarray(x), jcfg)), **TOL)
    y2, aux = tm.moe_layer_and_aux(tp, torch.from_numpy(x), tcfg)
    jy, jaux = jm.moe_layer_and_aux(jp, jnp.asarray(x), jcfg)
    assert torch.equal(y, y2)
    np.testing.assert_allclose(_np(y2), np.asarray(jy), **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **TOL)


def test_bf16_weights_run_the_experts_in_f32_as_jax_promotes():
    """bf16 parameters and tokens: the router and the experts run in f32
    (JAX promotes bf16 against the f32 queues), the output is bf16 and
    within one bf16 rounding of JAX's."""
    jcfg, tcfg, jp, tp, x = _layer(5, 1, 2.0, jnp.bfloat16)
    assert tp["w1"].dtype == torch.bfloat16
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y = tm.moe_layer(tp, xb, tcfg)
    jy = jm.moe_layer(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    np.testing.assert_allclose(_np(y.float()),
                               np.asarray(jy.astype(jnp.float32)),
                               rtol=8e-3, atol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_replicated_ep_forms_on_a_size_one_mesh_equal_moe_layer(k):
    jcfg, tcfg, jp, tp, x = _layer(20 + k, k, 1.0)
    xt = torch.from_numpy(x)
    want = tm.moe_layer_and_aux(tp, xt, tcfg)
    with mesh_from_devices({"tp": 1}):
        y = tm.moe_layer_replicated_ep(tp, xt, tcfg, "tp")
        y2, aux = tm.moe_layer_replicated_ep_and_aux(tp, xt, tcfg, "tp")
    torch.testing.assert_close(y, want[0], rtol=0, atol=0)
    torch.testing.assert_close(y2, want[0], rtol=0, atol=0)
    for key in ("load_balance", "router_z"):
        torch.testing.assert_close(aux[key], want[1][key], rtol=0, atol=0)
    np.testing.assert_allclose(_np(y), np.asarray(jm.moe_layer(
        jp, jnp.asarray(x), jcfg)), **TOL)


def test_init_moe_params_draws_the_jax_layout():
    cfg = tm.MoeConfig(d_model=16, d_ff=24, n_experts=4)
    want = jax.eval_shape(lambda: jm.init_moe_params(
        jax.random.key(0), jm.MoeConfig(d_model=16, d_ff=24, n_experts=4)))
    got = tm.init_moe_params(cfg, seed=2, device="cpu")
    again = tm.init_moe_params(cfg, seed=2, device="cpu")
    assert sorted(got) == sorted(want)
    for key in want:
        assert tuple(got[key].shape) == want[key].shape
        assert got[key].dtype == torch.float32
        assert torch.equal(got[key], again[key])
    assert abs(got["w1"].std().item() - 0.02) < 2e-3

