"""The slice as a whole: the port's train step (mpi_acx_torch/train.py)
held against the JAX package's ``make_train_step`` on a 1x1x1
('dp', 'pp', 'tp') mesh.

The same seed-0 parameters (drawn by JAX, crossed as numpy) and the same
numpy tokens go through both steps for three SGD steps in float32, with
the ring's flash blocks (the JAX kernel in interpret mode; B10's plain
version in the port) and with its dense blocks. Tolerances, tighter than
tests/test_train.py's own (loss rtol 2e-4; params atol 5e-4, rtol 5e-3)
because both sides run the same f32 math and differ only in summation
order: loss rtol 1e-5, params atol 1e-5 and rtol 1e-4.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh

MESH = {"dp": 1, "pp": 1, "tp": 1}
SIZES = dict(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             max_seq=32)
M, MB, S, LR = 2, 2, 16, 0.1


def _configs(use_flash):
    jcfg = dataclasses.replace(jtfm.tiny_config(**SIZES), dtype=jnp.float32,
                               use_flash=use_flash)
    tcfg = dataclasses.replace(ttfm.tiny_config(**SIZES),
                               dtype=torch.float32, use_flash=use_flash)
    return jcfg, tcfg


def _data(seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SIZES["vocab"], (M, MB, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


def _staged_params(jcfg):
    p = jtfm.stage_slice(jtfm.init_params(jax.random.key(0), jcfg), 1)
    return p, ttfm.params_from_jax(jax.device_get(p), device="cpu")


def _assert_params_close(tp, jp, atol=1e-5, rtol=1e-4):
    jp = jax.device_get(jp)
    for key in jp:
        if isinstance(jp[key], dict):
            _assert_params_close(tp[key], jp[key], atol, rtol)
        else:
            np.testing.assert_allclose(tp[key].detach().numpy(), jp[key],
                                       atol=atol, rtol=rtol, err_msg=key)


@pytest.mark.parametrize("use_flash", [True, False])
def test_sgd_steps_match_jax(use_flash):
    """Three SGD steps: the loss of each step and the final parameters,
    with flash and with dense ring blocks."""
    run_sgd_case(use_flash, None)


def run_sgd_case(use_flash, xent_chunk):
    jcfg, tcfg = _configs(use_flash)
    jp, tp = _staged_params(jcfg)
    tokens, targets = _data()
    jstep, n_stages = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=LR,
                                             xent_chunk=xent_chunk)
    tstep, t_stages = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=LR,
                                             xent_chunk=xent_chunk,
                                             device="cpu")
    assert n_stages == t_stages == 1
    for _ in range(3):
        jl, jp = jstep(jp, jnp.asarray(tokens), jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        assert tl.dtype == torch.float32 and tl.shape == ()
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tp, jp)


def test_train_step_equals_the_sequential_loss():
    """The step's loss and gradients on the one-device mesh equal autograd
    through the port's own transformer.loss_fn on the flattened batch (the
    JAX package's sequential check, tests/test_train.py)."""
    _, tcfg = _configs(True)
    params = ttfm.init_params(tcfg, seed=3, device="cpu")
    staged = ttfm.stage_slice(params, 1)
    tokens, targets = _data(1)
    grad_fn, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M,
                                            device="cpu")
    loss, grads = grad_fn(staged, tokens, targets)
    live = {k: ({n: a.detach().requires_grad_() for n, a in v.items()}
                if isinstance(v, dict) else v.detach().requires_grad_())
            for k, v in params.items()}
    want = ttfm.loss_fn(live, tcfg,
                        torch.from_numpy(tokens).long().reshape(M * MB, S),
                        torch.from_numpy(targets).long().reshape(M * MB, S))
    want.backward()
    torch.testing.assert_close(loss, want.detach(), atol=1e-6, rtol=1e-6)
    for name, g in grads["layers"].items():
        torch.testing.assert_close(g[0], live["layers"][name].grad,
                                   atol=1e-6, rtol=1e-5)
    for name in ("embed", "pos", "lnf_g", "lnf_b"):
        torch.testing.assert_close(grads[name], live[name].grad, atol=1e-6,
                                   rtol=1e-5)


def test_step_updates_the_given_params_in_place():
    _, tcfg = _configs(True)
    params = ttfm.stage_slice(ttfm.init_params(tcfg, seed=1, device="cpu"),
                              1)
    before = {k: v.clone() for k, v in params["layers"].items()}
    ptrs = [p.data_ptr() for p in ttrain.param_leaves(params)]
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=LR,
                                     device="cpu")
    loss, out = step(params, *_data())
    assert out is params and torch.isfinite(loss)
    assert ptrs == [p.data_ptr() for p in ttrain.param_leaves(params)]
    assert not torch.equal(before["wqkv"], params["layers"]["wqkv"])
    assert not any(p.requires_grad for p in ttrain.param_leaves(params))


def test_cpu_training_launches_no_kernel():
    tattn.flash_attention_lse.launches = 0
    tattn.flash_attention.launches = 0
    _, tcfg = _configs(True)
    params = ttfm.stage_slice(ttfm.init_params(tcfg, seed=2, device="cpu"),
                              1)
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, device="cpu")
    step(params, *_data())
    assert tattn.flash_attention_lse.launches == 0
    assert tattn.flash_attention.launches == 0
