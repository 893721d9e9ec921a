"""The Llama family through the port's train step (mpi_acx_torch/train.py)
and ``llama.loss_fn``, held against the JAX package's on a 1x1x1
('dp', 'pp', 'tp') mesh.

A tiny Llama (``tiny_llama``: d 64, 4 query heads over 2 KV groups, head
dim 16, SwiGLU 128, 2 layers) in float32, its weights and tokens drawn
with numpy from a seed and carried to both packages (the norms' gains
drawn around 1, so their gradients show). Loss and every gradient leaf of
``make_loss_and_grads`` within 1e-5 of JAX's, with the ring's flash blocks
(JAX's Pallas B10 in interpret mode; B10's plain version in the port) and
with its dense blocks; two SGD steps of ``make_train_step``; one AdamW
step against ``optax.adamw`` on JAX's gradients; at n_micro = 1 the
step's loss equals ``llama.loss_fn``'s; ``loss_fn`` and its gradients
against JAX's, with and without ``xent_chunk``; the ring's grouped K/V at
Llama-3-8B's attention geometry (8 KV groups of 4, head dim 128). Three
JAX train compiles in all (each ~5 s).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from mpi_acx_tpu import train as jtrain
from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.parallel.mesh import mesh_from_devices as jmesh
from mpi_acx_torch import train as ttrain
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import transformer as ttfm
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.parallel import ring_attention as tring
from mpi_acx_torch.parallel.mesh import mesh_from_devices as tmesh
from tests.test_torch_train import _assert_params_close

# The JAX package's parallel/__init__ exports a function of this name.
jring = importlib.import_module("mpi_acx_tpu.parallel.ring_attention")

MESH = {"dp": 1, "pp": 1, "tp": 1}
M, MB, S = 2, 2, 16
TOL = 1e-5


def _configs(use_flash=True):
    jcfg = dataclasses.replace(jl.tiny_llama(), dtype=jnp.float32,
                               use_flash=use_flash)
    tcfg = dataclasses.replace(tl.tiny_llama(), dtype=torch.float32,
                               use_flash=use_flash)
    assert tcfg.n_heads // tcfg.n_kv_heads == 2
    return jcfg, tcfg


def _numpy_params(seed):
    """The model's parameter tree drawn with numpy: matmul weights
    N(0, 0.02), norm gains 1 + N(0, 0.1)."""
    _, tcfg = _configs()
    shapes = tl.init_params(tcfg, device="cpu")
    rng = np.random.default_rng(seed)

    def draw(name, shape):
        if "norm" in name:
            return (1 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    return {k: ({n: draw(n, tuple(a.shape)) for n, a in v.items()}
                if isinstance(v, dict) else draw(k, tuple(v.shape)))
            for k, v in shapes.items()}


def _staged(seed=0):
    """Seed-drawn parameters, stage-sliced, as the JAX tree (jnp) and the
    port's (CPU tensors)."""
    p = _numpy_params(seed)
    p["layers"] = {n: a[None] for n, a in p["layers"].items()}
    return (jax.tree.map(jnp.asarray, p),
            ttfm.params_from_jax(p, device="cpu"))


def _data(seed=0, m=M):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, jl.tiny_llama().vocab, (m, MB, S)).astype(
        np.int32)
    return tokens, np.roll(tokens, -1, axis=-1)


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "dense"])
def test_loss_and_every_gradient_match_jax(use_flash):
    jcfg, tcfg = _configs(use_flash)
    jp, tp = _staged()
    tokens, targets = _data()
    jfn, _ = jtrain.make_loss_and_grads(jcfg, jmesh(MESH), M)
    tfn, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), M, device="cpu")
    jl_, jg = jfn(jp, jnp.asarray(tokens), jnp.asarray(targets))
    tl_, tg = tfn(tp, tokens, targets)
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=TOL)
    _assert_params_close(tg, jg, atol=TOL, rtol=TOL)
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
                                            device="cpu")
    loss, tp = tstep(tp, tokens, targets)
    np.testing.assert_allclose(float(loss), float(jl_), rtol=TOL)
    _assert_params_close(tp, jnew, atol=TOL, rtol=TOL)


def test_sgd_steps_match_jax():
    """Two SGD steps on the flash blocks: each step's loss (rtol 1e-5) and
    the final parameters (atol 1e-5, rtol 1e-4, as
    tests/test_torch_train.py)."""
    jcfg, tcfg = _configs()
    jp, tp = _staged(1)
    tokens, targets = _data(1)
    jstep, _ = jtrain.make_train_step(jcfg, jmesh(MESH), M, lr=0.5)
    tstep, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, lr=0.5,
                                      device="cpu")
    for _ in range(2):
        jl_, jp = jstep(jp, jnp.asarray(tokens), jnp.asarray(targets))
        tl_, tp = tstep(tp, tokens, targets)
        np.testing.assert_allclose(float(tl_), float(jl_), rtol=TOL)
    _assert_params_close(tp, jp)


def _unstaged(staged):
    return {k: ({n: a[0] for n, a in v.items()} if isinstance(v, dict)
                else v) for k, v in staged.items()}


def _live(params):
    """The port's parameters as fresh leaf tensors that require grad."""
    return {k: ({n: a.detach().clone().requires_grad_()
                 for n, a in v.items()} if isinstance(v, dict)
                else v.detach().clone().requires_grad_())
            for k, v in params.items()}


def _grads(live):
    return {k: ({n: a.grad for n, a in v.items()} if isinstance(v, dict)
                else v.grad) for k, v in live.items()}


def test_one_microbatch_loss_equals_loss_fn():
    """n_micro = 1: the step's loss is ``llama.loss_fn`` on that batch, in
    the JAX package's and in the port's, and the step's gradients are
    autograd through the port's own loss_fn."""
    _, tcfg = _configs()
    jp, tp = _staged(2)
    tokens, targets = _data(2, m=1)
    grad_fn, _ = ttrain.make_loss_and_grads(tcfg, tmesh(MESH), 1,
                                            device="cpu")
    loss, grads = grad_fn(tp, tokens, targets)
    jcfg, _ = _configs()
    want = jl.loss_fn(_unstaged(jp), jcfg, jnp.asarray(tokens[0]),
                      jnp.asarray(targets[0]))
    np.testing.assert_allclose(float(loss), float(want), rtol=TOL)
    live = _live(_unstaged(tp))
    mine = tl.loss_fn(live, tcfg, torch.from_numpy(tokens[0]).long(),
                      torch.from_numpy(targets[0]))
    mine.backward()
    torch.testing.assert_close(loss, mine.detach(), atol=1e-6, rtol=1e-6)
    got = _grads(live)
    for name, g in grads["layers"].items():
        torch.testing.assert_close(g[0], got["layers"][name], atol=1e-6,
                                   rtol=1e-5)
    for name in ("embed", "final_norm", "unembed"):
        torch.testing.assert_close(grads[name], got[name], atol=1e-6,
                                   rtol=1e-5)


@pytest.mark.parametrize("xent_chunk", [None, 96], ids=["naive", "chunked"])
def test_loss_fn_and_gradients_match_jax(xent_chunk):
    """``llama.loss_fn`` and every gradient leaf against
    ``jax.value_and_grad`` of JAX's, with the naive log-softmax and with
    the chunked-vocab CE (96 rows a chunk over a vocab of 256: the last
    chunk is short)."""
    jcfg, tcfg = _configs()
    p = _numpy_params(3)
    tokens, targets = (x[0] for x in _data(3, m=1))
    jfn = jax.jit(jax.value_and_grad(functools.partial(
        jl.loss_fn, cfg=jcfg, xent_chunk=xent_chunk)))
    jloss, jg = jfn(jax.tree.map(jnp.asarray, p), tokens=jnp.asarray(tokens),
                    targets=jnp.asarray(targets))
    live = _live(ttfm.params_from_jax(p, device="cpu"))
    loss = tl.loss_fn(live, tcfg, torch.from_numpy(tokens).long(),
                      torch.from_numpy(targets), xent_chunk=xent_chunk)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    _assert_params_close(_grads(live), jg, atol=TOL, rtol=TOL)


def test_cpu_training_launches_no_kernel():
    for name in ("launches", "launches_d128"):
        setattr(tattn.flash_attention_lse, name, 0)
        setattr(tattn.flash_attention, name, 0)
    _, tcfg = _configs()
    _, tp = _staged(4)
    step, _ = ttrain.make_train_step(tcfg, tmesh(MESH), M, device="cpu")
    loss, _ = step(tp, *_data(4))
    live = _live(_unstaged(tp))
    tl.loss_fn(live, tcfg, torch.from_numpy(_data(4)[0][0]).long(),
               torch.from_numpy(_data(4)[1][0])).backward()
    assert torch.isfinite(loss)
    for name in ("launches", "launches_d128"):
        assert getattr(tattn.flash_attention_lse, name) == 0
        assert getattr(tattn.flash_attention, name) == 0


def test_family_adapter_is_llamas():
    """``_family`` gives the Llama config its own block, untied head and
    tp-sharded SwiGLU leaves."""
    fam = ttrain._family(tl.tiny_llama())
    assert fam.block is ttrain._llama_block_sp_tp and not fam.has_aux
    assert [k for k in ("w_gate", "w_up", "w_down", "wq", "wo",
                        "attn_norm") if fam.tp_sharded(k)] == [
        "w_gate", "w_up", "w_down"]
    params = {"unembed": torch.ones(3), "embed": torch.zeros(3)}
    assert fam.head(params) is params["unembed"]


@pytest.mark.parametrize("use_flash", [True, False],
                         ids=["flash", "dense"])
def test_ring_grouped_kv_at_llama_geometry(use_flash):
    """The ring's ``kv_repeat`` at Llama-3-8B's attention: 8 KV groups of 4
    query heads, head dim 128 (S = 16), values and gradients against the
    JAX ring under ``shard_map`` on a size-1 mesh (flash: JAX's Pallas B10
    in interpret mode, the port's plain version)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 16, 32, 128), dtype=np.float32)
    k, v = (rng.standard_normal((1, 16, 8, 128), dtype=np.float32)
            for _ in range(2))
    do = rng.standard_normal(q.shape, dtype=np.float32)
    f = functools.partial(jring.ring_attention_batched, axis_name="x",
                          causal=True, use_flash=use_flash, kv_repeat=4)
    jfn = jax.jit(shard_map(f, mesh=jmesh({"x": 1}),
                            in_specs=(P(), P(), P()), out_specs=P(),
                            check_vma=False))
    want, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    wgrads = vjp(jnp.asarray(do))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    with tmesh({"x": 1}):
        got = tring.ring_attention_batched(*xs, "x", use_flash=use_flash,
                                           kv_repeat=4)
    got.backward(torch.from_numpy(do))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    for x, g in zip(xs, wgrads):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(g),
                                   atol=2e-5, rtol=2e-5)
