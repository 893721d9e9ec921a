"""The GPT-2 cases of tests/test_torch_train_schedules.py through the
ring's dense blocks: each pipeline option of the port's train step held
against the JAX package's step with the same option, three SGD steps in
float32 (loss rtol 1e-5; params atol 1e-5, rtol 1e-4); and the optimizer
step with every option at once against ``make_train_step_optax``. A file
of its own so that each stays under 30 s on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import MESH, _assert_params_close, _configs
from tests.test_torch_train_schedules import (M, OPTIONS, SIZES, data,
                                              jax_staged, run_gpt2_case,
                                              staged)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_gpt2_dense_steps_match_jax_with_the_same_option(option):
    run_gpt2_case(option, False)


def test_optim_step_with_every_option_matches_optax():
    """``make_train_step_optim`` (AdamW) with 1F1B, n_virtual=2 and remat
    at once, against ``make_train_step_optax`` (``optax.adamw``) with the
    same options, three steps at test_torch_train_optim.py's tolerances
    (params atol 5e-4, rtol 5e-3; lr 1e-3)."""
    import optax
    import torch
    kw = dict(schedule="1f1b", n_virtual=2, remat=True)
    jcfg, tcfg = _configs(True)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **SIZES})
    tcfg = tcfg.__class__(**{**tcfg.__dict__, **SIZES})
    p = jax.tree.map(lambda t: t.numpy(),
                     ttfm.init_params(tcfg, seed=1, device="cpu"))
    jp = jax_staged(p, jtrain.param_specs(), 2)
    tp = staged(ttfm.params_from_jax(p, device="cpu"), ttfm, 2)
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    jstep, _ = jtrain.make_train_step_optax(jcfg, jmesh(MESH), M, opt, **kw)
    state = opt.init(jp)
    topt = torch.optim.AdamW(ttrain.param_leaves(tp), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)
    tstep, _ = ttrain.make_train_step_optim(tcfg, tmesh(MESH), M, topt,
                                            device="cpu", **kw)
    tokens, targets = data(3)
    for _ in range(3):
        jl, jp, state = jstep(jp, state, jnp.asarray(tokens),
                              jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tp, jp, atol=5e-4, rtol=5e-3)
