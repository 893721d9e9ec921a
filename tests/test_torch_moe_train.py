"""The MoE family through the port's train step (mpi_acx_torch/train.py)
held against the JAX package's on a 1x1x1 ('dp', 'pp', 'tp') mesh.

A tiny MoE transformer (8 experts, top-2, capacity factor 1.0, so tokens
drop in every router call) in float32: loss and every gradient leaf of
``make_loss_and_grads`` within 1e-5 of JAX's, with the ring's flash blocks
(the JAX kernel in interpret mode; B10's plain version in the port) and
with its dense blocks; two SGD steps of ``make_train_step``; one AdamW
step against ``optax.adamw`` applied to JAX's gradients. At n_micro = 1
the step's loss equals ``moe_transformer.loss_fn``'s. Three JAX train
compiles in all (each ~5 s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import moe_transformer as jmt
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import moe_transformer as tmt
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import _assert_params_close

MESH = {"dp": 1, "pp": 1, "tp": 1}
SIZES = dict(vocab=67, d_model=32, n_heads=2, n_layers=2, d_ff=64,
             n_experts=8, top_k=2, capacity_factor=1.0, max_seq=16)
M, MB, S = 2, 2, 16
AW, ZW = 0.1, 0.01          # router weights large enough to show


def _configs(use_flash=True):
    jcfg = dataclasses.replace(jmt.tiny_moe_config(**SIZES),
                               dtype=jnp.float32, use_flash=use_flash)
    tcfg = dataclasses.replace(tmt.tiny_moe_config(**SIZES),
                               dtype=torch.float32, use_flash=use_flash)
    return jcfg, tcfg


def _data(seed=0, m=M):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, SIZES["vocab"], (m, MB, S)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


def _staged(seed=0):
    """Seed-drawn parameters, stage-sliced, as the JAX tree (jnp) and the
    port's (CPU tensors)."""
    _, tcfg = _configs()
    p = jax.tree.map(lambda t: t.numpy(), ttfm.stage_slice(
        tmt.init_params(tcfg, seed=seed, device="cpu"), 1))
    return (jax.tree.map(jnp.asarray, p),
            ttfm.params_from_jax(p, device="cpu"))


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "dense"])
def test_loss_and_every_gradient_match_jax(use_flash):
    jcfg, tcfg = _configs(use_flash)
    jp, tp = _staged()
    tokens, targets = _data()
    jfn, _ = jtrain.make_loss_and_grads(jcfg, jmesh(MESH), M,
                                        aux_weight=AW, z_weight=ZW)
    tfn, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M,
                                        aux_weight=AW, z_weight=ZW,
                                        device="cpu")
    jl, jg = jfn(jp, jnp.asarray(tokens), jnp.asarray(targets))
    tl, tg = tfn(tp, tokens, targets)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tg, jg, atol=1e-5, rtol=1e-5)
    assert sorted(tg) == sorted(jax.device_get(jg))
    if not use_flash:
        return
    # AdamW from these gradients: torch.optim.AdamW against optax.adamw
    # (its defaults written out on the torch side).
    opt = optax.adamw(1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    updates, _ = opt.update(jg, opt.init(jp), jp)
    jnew = optax.apply_updates(jp, updates)
    topt = torch.optim.AdamW(ttrain.param_leaves(tp), lr=1e-3,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    tstep, _ = ttrain.make_train_step_optim(tcfg, tmesh(MESH), M, topt,
                                            aux_weight=AW, z_weight=ZW,
                                            device="cpu")
    loss, tp = tstep(tp, tokens, targets)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _assert_params_close(tp, jnew, atol=5e-4, rtol=5e-3)


def test_sgd_steps_match_jax():
    """Two SGD steps: each step's loss and the final parameters (loss rtol
    1e-5; params atol 1e-5, rtol 1e-4, as tests/test_torch_train.py)."""
    jcfg, tcfg = _configs()
    jp, tp = _staged(1)
    tokens, targets = _data(1)
    jstep, _ = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=0.1,
                                      aux_weight=AW, z_weight=ZW)
    tstep, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=0.1,
                                      aux_weight=AW, z_weight=ZW,
                                      device="cpu")
    for _ in range(2):
        jl, jp = jstep(jp, jnp.asarray(tokens), jnp.asarray(targets))
        tl, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    _assert_params_close(tp, jp)


def _unstaged(staged):
    return {k: ({n: a[0] for n, a in v.items()} if isinstance(v, dict)
                else v) for k, v in staged.items()}


def test_one_microbatch_loss_equals_jax_loss_fn():
    """n_micro = 1: one router call per layer over the microbatch, so the
    step's loss is ``moe_transformer.loss_fn`` on that batch, in the JAX
    package's and in the port's; the port's gradients are autograd
    through its own loss_fn."""
    _, tcfg = _configs()
    jp, tp = _staged(2)
    tokens, targets = _data(2, m=1)
    grad_fn, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), 1,
                                            aux_weight=AW, z_weight=ZW,
                                            device="cpu")
    loss, grads = grad_fn(tp, tokens, targets)
    jcfg, _ = _configs()
    want = jmt.loss_fn(_unstaged(jp), jcfg, jnp.asarray(tokens[0]),
                       jnp.asarray(targets[0]), AW, ZW)
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    live = {k: ({n: a.detach().requires_grad_() for n, a in v.items()}
                if isinstance(v, dict) else v.detach().requires_grad_())
            for k, v in _unstaged(tp).items()}
    mine = tmt.loss_fn(live, tcfg, torch.from_numpy(tokens[0]).long(),
                       torch.from_numpy(targets[0]), AW, ZW)
    mine.backward()
    torch.testing.assert_close(loss, mine.detach(), atol=1e-6, rtol=1e-6)
    for name, g in grads["layers"].items():
        torch.testing.assert_close(g[0], live["layers"][name].grad,
                                   atol=1e-6, rtol=1e-5)
    for name in ("embed", "pos", "lnf_g", "lnf_b"):
        torch.testing.assert_close(grads[name], live[name].grad, atol=1e-6,
                                   rtol=1e-5)


def test_router_losses_reach_the_loss_once_per_call():
    """The aux terms are normalized per (layer, microbatch) router call:
    with the weights on, the loss grows by exactly the weighted mean of
    the calls' router losses."""
    _, tcfg = _configs()
    _, tp = _staged(3)
    tokens, targets = _data(3)
    base, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M, aux_weight=0,
                                         z_weight=0, device="cpu")
    full, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M,
                                         aux_weight=AW, z_weight=ZW,
                                         device="cpu")
    lb = rz = 0.0
    with torch.no_grad():
        for m in range(M):
            _, aux = tmt.forward(_unstaged(tp), tcfg,
                                 torch.from_numpy(tokens[m]).long())
            lb += float(aux["load_balance"]) / M
            rz += float(aux["router_z"]) / M
    extra = float(full(tp, tokens, targets)[0] - base(tp, tokens,
                                                      targets)[0])
    np.testing.assert_allclose(extra, AW * lb + ZW * rz, rtol=1e-4)


def test_cpu_training_launches_no_kernel():
    from mpi_acx_torch.ops import attention as tattn
    tattn.flash_attention_lse.launches = 0
    _, tcfg = _configs()
    _, tp = _staged(4)
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, device="cpu")
    loss, _ = step(tp, *_data(4))
    assert torch.isfinite(loss)
    assert tattn.flash_attention_lse.launches == 0


def test_llama_still_refuses_to_train():
    """The three families each get their own adapter: Llama's block and
    untied head beside the MoE family's routed block (tests of Llama's
    training itself: tests/test_torch_llama_train.py); a config of no
    family is refused."""
    from mpi_acx_torch.models import llama
    fam = ttrain._family(llama.tiny_llama())
    assert fam.block is ttrain._llama_block_sp_tp and not fam.has_aux
    assert fam.tp_sharded("w_gate") and not fam.tp_sharded("w1")
    _, tcfg = _configs()
    moe = ttrain._family(tcfg)
    assert moe.block is ttrain._moe_block_sp_tp and moe.has_aux
    assert moe.tp_sharded("w1") and not moe.tp_sharded("w_gate")
    _, n_stages = ttrain.make_loss_and_grads(llama.tiny_llama(), tmesh(MESH),
                                             M, device="cpu")
    assert n_stages == 1
    with pytest.raises(TypeError, match="no model family"):
        ttrain.make_loss_and_grads(object(), tmesh(MESH), M, device="cpu")
