"""The port's train step with an optimizer, and ``dp_quant_bits`` on a
one-rank mesh.

``make_train_step_optim`` with ``torch.optim.AdamW`` is held against the
JAX package's ``make_train_step_optax`` with ``optax.adamw`` (optax's
defaults written out on the torch side), three steps in float32 on the
1x1x1 mesh: loss rtol 1e-5; params at tests/test_train.py's own atol
5e-4 and rtol 5e-3, looser than SGD's because AdamW divides each gradient
by its own RMS, so an element whose gradient is near zero turns
summation-order noise into a visible step; that step scales with lr, so
lr is 1e-3 here.
"""

import numpy as np
import optax
import pytest
import torch

import jax.numpy as jnp

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import (M, MESH, _assert_params_close,
                                    _configs, _data, _staged_params)


def test_adamw_steps_match_optax():
    jcfg, tcfg = _configs(True)
    jp, tp = _staged_params(jcfg)
    tokens, targets = _data(2)
    lr = 1e-3
    opt = optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    jstep, _ = jtrain.make_train_step_optax(jcfg, jmesh(MESH), M, opt)
    state = opt.init(jp)
    topt = torch.optim.AdamW(ttrain.param_leaves(tp), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    tstep, _ = ttrain.make_train_step_optim(tcfg, tmesh(MESH), M, topt,
                                            device="cpu")
    for _ in range(3):
        jl, jp, state = jstep(jp, state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tp, jp, atol=5e-4, rtol=5e-3)


class _OtherConfig:
    """A model configuration of another family (Llama, MoE)."""


@pytest.mark.parametrize("builder", ["make_loss_and_grads", "make_train_step",
                                     "make_train_step_optim"])
def test_dp_quant_is_exact_at_dp_one(builder):
    """``dp_quant_bits=8`` is taken by every builder: on a dp axis of 1
    the quantized sync is the identity, so the step equals the exact one
    bit for bit (tests/test_torch_train_ranks*.py hold it at dp = 2
    against JAX's)."""
    _, tcfg = _configs(True)
    tokens, targets = _data(3)
    results = []
    for kw in ({}, dict(dp_quant_bits=8)):
        params = ttfm.stage_slice(ttfm.init_params(tcfg, seed=6,
                                                   device="cpu"), 1)
        args = (tcfg, tmesh(MESH), M)
        if builder == "make_train_step_optim":
            args += (torch.optim.SGD(ttrain.param_leaves(params), lr=0.1),)
        fn, _ = getattr(ttrain, builder)(*args, device="cpu", **kw)
        loss, out = fn(params, tokens, targets)
        results.append((loss, ttrain.param_leaves(out)))
    (l0, p0), (l1, p1) = results
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def test_other_families_raise():
    """A config of none of the three families (GPT-2, Llama, MoE) is
    refused by name."""
    with pytest.raises(TypeError, match="_OtherConfig: no model family"):
        ttrain.make_loss_and_grads(_OtherConfig(), tmesh(MESH), M,
                                   device="cpu")


def test_unknown_schedule_is_a_value_error():
    _, tcfg = _configs(True)
    with pytest.raises(ValueError, match="unknown schedule"):
        ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M, schedule="zb",
                                   device="cpu")


def test_optimizer_must_hold_the_params():
    _, tcfg = _configs(True)
    params = ttfm.stage_slice(ttfm.init_params(tcfg, seed=6, device="cpu"),
                              1)
    leaves = ttrain.param_leaves(params)
    opt = torch.optim.AdamW(leaves[:-1], lr=1e-3)
    step, _ = ttrain.make_train_step_optim(tcfg, tmesh(MESH), M, opt,
                                           device="cpu")
    with pytest.raises(ValueError, match="param_leaves"):
        step(params, *_data())
