"""The port's train step in bf16 compute (f32 parameters, flash ring
blocks) held against the JAX package's ``make_train_step`` on the 1x1x1
mesh: the losses to rtol 1e-2 and the parameters to atol 1e-3 after three
SGD steps of lr 0.1. The two packages round the activations and
attention's probabilities to bf16 at the same points but sum in other
orders, and bf16 keeps 8 bits.
"""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import LR, M, MESH, _configs, _data, \
    _staged_params


def test_bf16_steps_match_jax():
    """Three SGD steps at the limits of the module docstring."""
    jcfg, tcfg = _configs(True)
    jcfg = dataclasses.replace(jcfg, dtype=jnp.bfloat16)
    tcfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    jp, tp = _staged_params(jcfg)
    tokens, targets = _data(3)
    jstep, _ = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=LR)
    tstep, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=LR,
                                      device="cpu")
    for _ in range(3):
        jl, jp = jstep(jp, jnp.asarray(tokens), jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-2)
    for key, want in jax.device_get(jp)["layers"].items():
        assert tp["layers"][key].dtype == torch.float32
        np.testing.assert_allclose(tp["layers"][key].numpy(), want,
                                   atol=1e-3, err_msg=key)
