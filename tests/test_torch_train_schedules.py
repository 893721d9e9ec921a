"""The train step's pipeline options (mpi_acx_torch/train.py) for GPT-2,
each held against the JAX package's ``make_train_step`` with the same
option on a 1x1x1 ('dp', 'pp', 'tp') mesh: ``remat=True``,
``n_virtual=2`` (over ``stage_slice_interleaved`` params),
``schedule="1f1b"`` and 1F1B with ``n_virtual=2``.

The same seed-0 parameters (drawn by the port, crossed as numpy) and numpy
tokens go through both steps for three SGD steps in float32, with the
ring's flash blocks (the JAX kernel in Pallas interpret mode; B10's plain
version in the port) here, and with its dense blocks in
tests/test_torch_train_schedules_dense.py, at the tolerances of
tests/test_torch_train.py: loss rtol 1e-5, params atol 1e-5 and rtol
1e-4. One JAX train compile a case (~2-3 s): the JAX parameters start
with the shardings its step gives them, so later steps reuse it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import transformer as jtfm
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import (LR, MESH, _assert_params_close,
                                    _configs)

SIZES = dict(vocab=61, d_model=32, n_heads=2, n_layers=4, d_ff=64,
             max_seq=32)
M, MB, S = 4, 2, 16
OPTIONS = {
    "remat": dict(remat=True),
    "virtual2": dict(n_virtual=2),
    "1f1b": dict(schedule="1f1b"),
    "1f1b_virtual2": dict(schedule="1f1b", n_virtual=2),
}


def staged(params, mod, n_virtual):
    """``params`` stage-sliced for a one-stage mesh, interleaved into
    ``n_virtual`` chunks when that is above 1."""
    if n_virtual > 1:
        return mod.stage_slice_interleaved(params, 1, n_virtual)
    return mod.stage_slice(params, 1)


def jax_staged(np_params, specs, n_virtual):
    """The JAX side of :func:`staged`, each leaf placed with the sharding
    the JAX step gives its outputs, so that its second step reuses the
    first one's compile (the step's own spec rule for ``n_virtual``)."""
    p = staged(jax.tree.map(jnp.asarray, np_params), jtfm, n_virtual)
    if n_virtual > 1:
        specs = dict(specs, layers={k: P(s[0], None, *s[1:])
                                    for k, s in specs["layers"].items()})
    mesh = jmesh(MESH)
    return jax.tree.map(lambda a, s: jax.device_put(a, NamedSharding(
        mesh, s)), p, specs)


def data(seed=0, vocab=SIZES["vocab"]):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (M, MB, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_gpt2_steps_match_jax_with_the_same_option(option):
    """The ring's flash blocks (tests/test_torch_train_schedules_dense.py
    has the dense ones)."""
    run_gpt2_case(option, True)


def run_gpt2_case(option, use_flash):
    kw = OPTIONS[option]
    nv = kw.get("n_virtual", 1)
    jcfg, tcfg = _configs(use_flash)
    jcfg = jcfg.__class__(**{**jcfg.__dict__, **SIZES})
    tcfg = tcfg.__class__(**{**tcfg.__dict__, **SIZES})
    p = jax.tree.map(lambda t: t.numpy(),
                     ttfm.init_params(tcfg, seed=0, device="cpu"))
    jp = jax_staged(p, jtrain.param_specs(), nv)
    tp = staged(ttfm.params_from_jax(p, device="cpu"), ttfm, nv)
    tokens, targets = data()
    jstep, _ = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=LR, **kw)
    tstep, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=LR,
                                      device="cpu", **kw)
    for _ in range(3):
        jl, jp = jstep(jp, jnp.asarray(tokens), jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tp, jp)

