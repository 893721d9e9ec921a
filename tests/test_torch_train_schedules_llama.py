"""The train step's pipeline options (mpi_acx_torch/train.py) for the
Llama family (GQA) here and the MoE family in
tests/test_torch_train_schedules_moe.py, held against the JAX package's
GPipe ``make_train_step``: ``remat=True``, ``n_virtual=2``,
``schedule="1f1b"``, 1F1B with ``n_virtual=2``, and 1F1B under remat
with and without ``n_virtual=2``. The JAX package's own tests show each of
its options equal to its GPipe step (tests/test_train_1f1b.py,
tests/test_train.py), so one JAX compile per family and block form holds
every option of the port.

Weights drawn by the port from a seed and crossed as numpy; three SGD
steps in float32 with the ring's flash blocks (JAX's Pallas B10 in
interpret mode; B10's plain version in the port) and with its dense
blocks; the MoE family at capacity factor 1.0 (tokens drop) with router
weights large enough to show. Tolerances of tests/test_torch_train.py:
loss rtol 1e-5; params atol 1e-5, rtol 1e-4.

Also: how many times each option runs the ring's flash block a step (on
the CPU its plain version; on the card B10's launches, which
``chip_smoke.py`` phase 5e pins by the same count).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import moe_transformer as jmt
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import moe_transformer as tmt
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import LR, MESH
from tests.test_torch_train_schedules import (M, OPTIONS, data, jax_staged,
                                              staged)

OPTIONS = dict(OPTIONS, **{
    "1f1b_remat": dict(schedule="1f1b", remat=True),
    "1f1b_virtual2_remat": dict(schedule="1f1b", n_virtual=2, remat=True),
})
VOCAB = 61
AW, ZW = 0.1, 0.01
FAMILIES = {
    "llama": (jl, tl, dict(vocab=VOCAB, d_model=32, n_heads=4, n_kv_heads=2,
                           n_layers=4, d_ff=64, max_seq=32)),
    "moe": (jmt, tmt, dict(vocab=VOCAB, d_model=32, n_heads=2, n_layers=4,
                           d_ff=64, n_experts=8, top_k=2,
                           capacity_factor=1.0, max_seq=32)),
}


def _configs(family, use_flash):
    jmod, tmod, sizes = FAMILIES[family]
    make = "tiny_llama" if family == "llama" else "tiny_moe_config"
    return (dataclasses.replace(getattr(jmod, make)(**sizes),
                                dtype=jnp.float32, use_flash=use_flash),
            dataclasses.replace(getattr(tmod, make)(**sizes),
                                dtype=torch.float32, use_flash=use_flash))


def _np_params(family, tcfg):
    tmod = FAMILIES[family][1]
    return jax.tree.map(lambda t: t.numpy(),
                        tmod.init_params(tcfg, seed=0, device="cpu"))


@pytest.fixture(scope="module")
def jax_gpipe():
    """JAX's GPipe trajectory, per (family, use_flash): the three
    losses and the final parameters (numpy)."""
    runs = {}

    def run(family, use_flash):
        if (family, use_flash) not in runs:
            jcfg, tcfg = _configs(family, use_flash)
            jp = jax_staged(_np_params(family, tcfg),
                            jtrain._family(jcfg).specs(), 1)
            step, _ = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=LR,
                                             aux_weight=AW, z_weight=ZW)
            tokens, targets = data(vocab=VOCAB)
            losses = []
            for _ in range(3):
                loss, jp = step(jp, jnp.asarray(tokens),
                                jnp.asarray(targets))
                losses.append(float(loss))
            runs[family, use_flash] = losses, jax.device_get(jp)
        return runs[family, use_flash]
    return run


def _assert_close_to(tp, jp, key=""):
    """The port's params against JAX's GPipe ones; interleaved layer
    leaves [1, v, L / v, ...] read as [1, L, ...] (one stage: chunk j
    holds layers j * L / v onward)."""
    for k, want in jp.items():
        if isinstance(want, dict):
            _assert_close_to(tp[k], want, k)
            continue
        got = tp[k].detach().reshape(want.shape).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                   err_msg=f"{key}/{k}")


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "dense"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_llama_option_steps_match_jax_gpipe(jax_gpipe, option, use_flash):
    """tests/test_torch_train_schedules_moe.py has the MoE family's."""
    run_family_case(jax_gpipe, "llama", option, use_flash)


def run_family_case(jax_gpipe, family, option, use_flash):
    want_losses, want_params = jax_gpipe(family, use_flash)
    kw = OPTIONS[option]
    _, tcfg = _configs(family, use_flash)
    tp = staged(ttfm.params_from_jax(_np_params(family, tcfg),
                                     device="cpu"), ttfm,
                kw.get("n_virtual", 1))
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=LR,
                                     aux_weight=AW, z_weight=ZW,
                                     device="cpu", **kw)
    tokens, targets = data(vocab=VOCAB)
    for want in want_losses:
        loss, tp = step(tp, tokens, targets)
        np.testing.assert_allclose(loss.item(), want, rtol=1e-5)
    _assert_close_to(tp, want_params)


# Runs of the ring's flash block a step, per (layer, microbatch): the
# forward, plus the re-run for 1F1B's backward, plus remat's recompute.
FLASH_RUNS = {"gpipe": 1, "remat": 2, "virtual2": 1, "1f1b": 2,
              "1f1b_virtual2": 2, "1f1b_remat": 3, "1f1b_virtual2_remat": 3}


@pytest.mark.parametrize("option", sorted(FLASH_RUNS))
def test_flash_block_runs_per_step(option, monkeypatch):
    calls = []
    plain = tattn._reference_lse

    def counted(*args, **kw):
        calls.append(1)
        return plain(*args, **kw)

    monkeypatch.setattr(tattn, "_reference_lse", counted)
    kw = OPTIONS.get(option, {})
    _, tcfg = _configs("llama", True)
    tp = staged(tl.init_params(tcfg, seed=1, device="cpu"), ttfm,
                kw.get("n_virtual", 1))
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, device="cpu",
                                     **kw)
    step(tp, *data(vocab=VOCAB))
    assert len(calls) == FLASH_RUNS[option] * tcfg.n_layers * M
