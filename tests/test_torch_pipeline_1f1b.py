"""The port's interleaved and 1F1B pipeline schedules
(mpi_acx_torch/parallel/pipeline.py) and ``stage_slice_interleaved``,
held against the JAX package's.

The timetable is numpy and Python on both sides, so
``_sched_1f1b_tables`` is held **equal** to JAX's, every array, for
P in {1, 2, 4}, M in 1..8 and V in {1, 2}, and refuses with the same
``ValueError`` where JAX does (V > 1 with M % P != 0). The executors run
on a 'pp' axis of size 1 against JAX's under ``shard_map``, on seeded
numpy inputs in float32: values 1e-5, gradients 2e-5 (summation order).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel import pipeline as jpipe
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel import pipeline as tpipe
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh

TOL, GTOL = 1e-5, 2e-5
TABLES = ("f_m", "f_j", "f_cell", "a_cell", "b_m", "b_j", "b_cell",
          "d_arr", "d_use")


@pytest.mark.parametrize("V", [1, 2])
@pytest.mark.parametrize("M", range(1, 9))
@pytest.mark.parametrize("P_", [1, 2, 4])
def test_tables_equal_jax(P_, M, V):
    try:
        want = jpipe._sched_1f1b_tables(P_, M, V)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tpipe._sched_1f1b_tables(P_, M, V)
        assert str(got.value) == str(e)
        assert V > 1 and M % P_
        return
    got = tpipe._sched_1f1b_tables(P_, M, V)
    assert (got.P, got.V, got.T, got.K, got.D) == \
        (want.P, want.V, want.T, want.K, want.D)
    for name in TABLES:
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


def test_the_same_ten_cases_are_refused():
    """Over the grid above, V = 2 with M % P != 0 is refused: P = 2 at
    odd M, P = 4 at M of 1-3 and 5-7."""
    def refused(mod):
        out = []
        for P_ in (1, 2, 4):
            for M in range(1, 9):
                try:
                    mod._sched_1f1b_tables(P_, M, 2)
                except ValueError:
                    out.append((P_, M))
        return out
    assert refused(tpipe) == refused(jpipe)
    assert len(refused(tpipe)) == 10


@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("P_", [1, 2, 4])
def test_closed_form_equals_jax(P_, M):
    for g, w in zip(tpipe._schedule_1f1b(P_, M), jpipe._schedule_1f1b(P_, M)):
        np.testing.assert_array_equal(g, w)


def test_one_stage_alternates_forward_and_backward():
    """At P = 1 each slot runs one op and F and B alternate, so each
    microbatch is forwarded once and re-run once for its backward (the
    launch count chip_smoke pins), and the banked inputs stay K deep
    whatever M is (the flat peak it measures)."""
    sc = tpipe._sched_1f1b_tables(1, 4, 1)
    assert (sc.T, sc.K) == (8, 1)
    np.testing.assert_array_equal(sc.f_m[0], [0, -1, 1, -1, 2, -1, 3, -1])
    np.testing.assert_array_equal(sc.b_m[0], [-1, 0, -1, 1, -1, 2, -1, 3])
    sc = tpipe._sched_1f1b_tables(1, 4, 2)
    assert (sc.T, sc.K) == (16, 3)
    assert ((sc.f_m[0] >= 0) != (sc.b_m[0] >= 0)).all()
    for V in (1, 2):
        assert {tpipe._sched_1f1b_tables(1, M, V).K for M in (2, 8, 32)} \
            == {1 if V == 1 else 3}


def _layers(seed, L=4, d=8):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((L, d, d), dtype=np.float32) * 0.3,
            "b": rng.standard_normal((L, d), dtype=np.float32) * 0.1}


@pytest.mark.parametrize("pp,v", [(1, 2), (2, 2), (1, 4), (2, 1)])
def test_stage_slice_interleaved_equals_jax(pp, v):
    layers = _layers(0, L=8)
    got = ttfm.stage_slice_interleaved(
        {"layers": {k: torch.from_numpy(a) for k, a in layers.items()}},
        pp, v)
    want = jtfm.stage_slice_interleaved(
        {"layers": {k: jnp.asarray(a) for k, a in layers.items()}}, pp, v)
    for k in layers:
        np.testing.assert_array_equal(got["layers"][k].numpy(),
                                      np.asarray(want["layers"][k]))
    # Views: an in-place update of the sliced tensor reaches the stack.
    src = torch.from_numpy(layers["w"].copy())
    view = ttfm.stage_slice_interleaved({"layers": {"w": src}}, pp, v)
    view["layers"]["w"].add_(1.0)
    np.testing.assert_array_equal(src.numpy(), layers["w"] + 1.0)
    with pytest.raises(ValueError, match="do not split"):
        ttfm.stage_slice_interleaved({"layers": {"w": src}}, 3, v)


def _jstage(p, x):
    for i in range(p["w"].shape[0]):
        x = jnp.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _tstage(p, x):
    for i in range(p["w"].shape[0]):
        x = torch.tanh(x @ p["w"][i] + p["b"][i])
    return x


def _jstage_aux(p, x):
    y = _jstage(p, x)
    return y, (jnp.mean(y ** 2), jnp.sum(p["b"] ** 2))


def _tstage_aux(p, x):
    y = _tstage(p, x)
    return y, ((y ** 2).mean(), (p["b"] ** 2).sum())


def _inputs(seed, n_micro, d=8):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((n_micro, 3, 5, d), dtype=np.float32)
    tg = rng.standard_normal(xs.shape, dtype=np.float32)
    return xs, tg


def _interleaved(layers, v, lib):
    tree = {"layers": {k: lib(a) for k, a in layers.items()}}
    mod = ttfm if lib is torch.from_numpy else jtfm
    return mod.stage_slice_interleaved(tree, 1, v)["layers"]


@pytest.mark.parametrize("with_aux", [False, True])
@pytest.mark.parametrize("v,n_micro", [(2, 3), (4, 2)])
def test_pipeline_forward_interleaved_matches_jax(v, n_micro, with_aux):
    """Values and gradients (stage parameters and inputs) of the
    interleaved forward on a size-1 'pp' axis."""
    layers = _layers(v)
    xs, ct = _inputs(1, n_micro)
    jfn = _jstage_aux if with_aux else _jstage
    tfn = _tstage_aux if with_aux else _tstage

    def jloss(p, x):
        out = jpipe.pipeline_forward_interleaved(jfn, p, x, "pp", v,
                                                 with_aux=with_aux)
        ys, aux = out if with_aux else (out, (0.0, 0.0))
        return jnp.sum(ys * ct) + aux[0] + 0.5 * aux[1], ys

    f = jax.jit(shard_map(
        jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True),
        mesh=jmesh({"pp": 1}), in_specs=(P("pp"), P()),
        out_specs=((P(), P()), (P("pp"), P())), check_vma=False))
    (jl, jys), (jgp, jgx) = f(_interleaved(layers, v, jnp.asarray),
                              jnp.asarray(xs))
    tp = {k: a.detach().requires_grad_()
          for k, a in _interleaved(layers, v, torch.from_numpy).items()}
    txs = torch.from_numpy(xs).requires_grad_()
    with tmesh({"pp": 1}):
        out = tpipe.pipeline_forward_interleaved(tfn, tp, txs, "pp", v,
                                                 with_aux=with_aux)
    ys, aux = out if with_aux else (out, (0.0, 0.0))
    loss = (ys * torch.from_numpy(ct)).sum() + aux[0] + 0.5 * aux[1]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=TOL)
    np.testing.assert_allclose(ys.detach().numpy(), np.asarray(jys),
                               atol=TOL, rtol=TOL)
    for k in layers:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(jgp[k]),
                                   atol=GTOL, rtol=GTOL, err_msg=k)
    np.testing.assert_allclose(txs.grad.numpy(), np.asarray(jgx),
                               atol=GTOL, rtol=GTOL)


def _per_micro_j(y, tgt):
    return jnp.mean((y - tgt) ** 2)


def _per_micro_t(y, tgt):
    return ((y - tgt) ** 2).mean()


@pytest.mark.parametrize("v,n_micro", [(1, 1), (1, 4), (2, 3), (4, 2)])
def test_pipeline_1f1b_loss_and_grads_matches_jax(v, n_micro):
    layers = _layers(10 + v)
    xs, tg = _inputs(2, n_micro)
    if v == 1:
        jp = {k: jnp.asarray(a)[None] for k, a in layers.items()}
        tp = {k: torch.from_numpy(a)[None] for k, a in layers.items()}
    else:
        jp = _interleaved(layers, v, jnp.asarray)
        tp = _interleaved(layers, v, torch.from_numpy)
    f = jax.jit(shard_map(
        functools.partial(jpipe.pipeline_1f1b_loss_and_grads, _jstage,
                          _per_micro_j, axis_name="pp", n_virtual=v),
        mesh=jmesh({"pp": 1}), in_specs=(P("pp"), P(), P()),
        out_specs=(P(), P("pp")), check_vma=False))
    jl, jg = f(jp, jnp.asarray(xs), jnp.asarray(tg))
    with tmesh({"pp": 1}):
        tl, tgr = tpipe.pipeline_1f1b_loss_and_grads(
            _tstage, _per_micro_t, tp, torch.from_numpy(xs),
            torch.from_numpy(tg), "pp", n_virtual=v)
    np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
    for k in layers:
        assert tgr[k].shape == tp[k].shape
        np.testing.assert_allclose(tgr[k].numpy(), np.asarray(jg[k]),
                                   atol=GTOL, rtol=GTOL, err_msg=k)
    # The same function as autograd through the GPipe loss.
    live = {k: a.detach().requires_grad_() for k, a in tp.items()}
    with tmesh({"pp": 1}):
        if v == 1:
            ys = tpipe.pipeline_forward(_tstage, live, torch.from_numpy(xs),
                                        "pp")
        else:
            ys = tpipe.pipeline_forward_interleaved(
                _tstage, live, torch.from_numpy(xs), "pp", v)
    want = torch.stack([_per_micro_t(y, t) for y, t in
                        zip(ys, torch.from_numpy(tg))]).mean()
    want.backward()
    np.testing.assert_allclose(float(tl), want.item(), rtol=TOL)
    for k in layers:
        np.testing.assert_allclose(tgr[k].numpy(), live[k].grad.numpy(),
                                   atol=GTOL, rtol=GTOL, err_msg=k)


def test_pipeline_1f1b_keeps_no_graph_between_slots():
    """The forward slot runs without autograd: the engine's result holds
    no graph, and the caller's tensors gain no .grad."""
    layers = _layers(3)
    xs, tg = _inputs(4, 3)
    tp = {k: torch.from_numpy(a)[None].requires_grad_()
          for k, a in layers.items()}
    with tmesh({"pp": 1}):
        loss, grads = tpipe.pipeline_1f1b_loss_and_grads(
            _tstage, _per_micro_t, tp, torch.from_numpy(xs),
            torch.from_numpy(tg), "pp")
    assert loss.grad_fn is None and not loss.requires_grad
    assert all(g.grad_fn is None for g in grads.values())
    assert all(p.grad is None for p in tp.values())


def test_pipeline_loss_and_run_pipeline_match_jax():
    layers = {k: a[None] for k, a in _layers(5).items()}
    xs, tg = _inputs(6, 2)
    jys = jax.jit(lambda p, x: jpipe.run_pipeline(
        jmesh({"pp": 1}), _jstage, p, x))(
            {k: jnp.asarray(a) for k, a in layers.items()}, jnp.asarray(xs))
    tys = tpipe.run_pipeline(tmesh({"pp": 1}), _tstage,
                             {k: torch.from_numpy(a)
                              for k, a in layers.items()},
                             torch.from_numpy(xs))
    np.testing.assert_allclose(tys.numpy(), np.asarray(jys), atol=TOL,
                               rtol=TOL)
    with tmesh({"pp": 1}):
        tl = tpipe.pipeline_loss(
            _tstage, lambda ys, t: ((ys - t) ** 2).mean(),
            {k: torch.from_numpy(a) for k, a in layers.items()},
            torch.from_numpy(xs), torch.from_numpy(tg), "pp")
    np.testing.assert_allclose(float(tl), float(np.mean(
        (np.asarray(jys) - tg) ** 2)), rtol=TOL)
