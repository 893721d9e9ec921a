"""The flash backward of the port — the blockwise backward shared by the
``torch.autograd.Function``s of flash_attention (B6/B7) and
flash_attention_lse (B10) — held against jax.vjp of the JAX package's
custom VJPs and against its ``_flash_bwd_blockwise``.

Inputs are made from a seed with numpy. The JAX forwards run in Pallas
interpret mode, the port's wrappers their plain versions (CPU tensors).
Block sizes smaller than S make the blockwise loops and the causal
skipping run. Tolerance: both sides compute in float32 and differ in
summation order: 2e-5 on gradients (sums over up to 64 rows of
products); 1e-4 where the JAX side differentiates its dense fallback
over 648 rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_acx_tpu.ops import attention as jattn
from mpi_acx_torch.ops import attention as tattn

GTOL = 2e-5


def _qkv(seed, S, Sk, B=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32))


def _close(got, want, tol=GTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


def _vjp_jax(fn, q, k, v, cts):
    out, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return out, vjp(cts)


def _vjp_torch(fn, q, k, v, cts):
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = fn(*xs)
    outs = out if isinstance(out, tuple) else (out,)
    cts = cts if isinstance(cts, tuple) else (cts,)
    torch.autograd.backward(outs, tuple(map(torch.from_numpy, cts)))
    return out, [x.grad for x in xs]


@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_backward_matches_jax_vjp(causal, streaming):
    """dq, dk, dv of flash_attention (blocks of 16 over S=64, so the
    blockwise loops and the causal skipping run) against jax.vjp of the
    JAX flash_attention, both forward kernels."""
    q, k, v = _qkv(5, 64, 64)
    do = np.random.default_rng(6).standard_normal(q.shape, dtype=np.float32)
    kw = dict(causal=causal, block_q=16, block_k=16, streaming=streaming)
    _, gj = _vjp_jax(lambda *a: jattn.flash_attention(*a, **kw), q, k, v,
                     jnp.asarray(do))
    _, gt = _vjp_torch(lambda *a: tattn.flash_attention(*a, **kw), q, k, v,
                       do)
    for a, b in zip(gt, gj):
        _close(a, b)


@pytest.mark.parametrize("S,Sk,causal,bq,bk", [
    (64, 64, True, 16, 16), (64, 64, True, 32, 16), (64, 64, False, 16, 32),
    (48, 80, False, 16, 16)])
def test_flash_attention_lse_backward_matches_jax_vjp(S, Sk, causal, bq, bk):
    """Gradients through both outputs of flash_attention_lse (random dO
    and dLSE) against jax.vjp of the JAX flash_attention_lse: the emitted
    lse is reused and its cotangent folded into dS."""
    q, k, v = _qkv(7, S, Sk)
    rng = np.random.default_rng(8)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = rng.standard_normal((2, 3, S), dtype=np.float32)
    kw = dict(causal=causal, block_q=bq, block_k=bk)
    _, gj = _vjp_jax(lambda *a: jattn.flash_attention_lse(*a, **kw), q, k, v,
                     (jnp.asarray(do), jnp.asarray(dlse)))
    _, gt = _vjp_torch(lambda *a: tattn.flash_attention_lse(*a, **kw), q, k,
                       v, (do, dlse))
    for a, b in zip(gt, gj):
        _close(a, b)


def test_lse_output_alone_carries_gradient():
    """A loss on the lse alone (no dO) differentiates through dLSE only."""
    q, k, v = _qkv(9, 32, 32)
    w = np.random.default_rng(10).standard_normal((2, 3, 32),
                                                  dtype=np.float32)

    def jloss(q, k, v):
        return (jnp.asarray(w) * jattn.flash_attention_lse(
            q, k, v, block_q=16, block_k=16)[1]).sum()

    gj = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (torch.from_numpy(w) * tattn.flash_attention_lse(
        *xs, block_q=16, block_k=16)[1]).sum().backward()
    for a, b in zip(xs, gj):
        _close(a.grad, b, GTOL)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_backward_matches_jax_function(causal, with_lse):
    """``_flash_bwd_blockwise`` itself against the JAX function on the
    same [B, H, S, D] operands, with the lse rebuilt or given (and a dLSE
    term when given)."""
    rng = np.random.default_rng(12)
    B, H, S, D = 2, 2, 64, 8
    qt, kt, vt, o, do = (rng.standard_normal((B, H, S, D), dtype=np.float32)
                         for _ in range(5))
    lse = dlse = None
    if with_lse:
        _, lse = jattn._reference_lse(*(jnp.swapaxes(jnp.asarray(x), 1, 2)
                                        for x in (qt, kt, vt)), causal=causal)
        lse = np.array(lse)
        dlse = rng.standard_normal((B, H, S), dtype=np.float32)
    want = jattn._flash_bwd_blockwise(
        *map(jnp.asarray, (qt, kt, vt, o, do)), causal, 16, 32,
        lse=None if lse is None else jnp.asarray(lse),
        dlse=None if dlse is None else jnp.asarray(dlse))
    got = tattn._flash_bwd_blockwise(
        *map(torch.from_numpy, (qt, kt, vt, o, do)), causal, 16, 32,
        lse=None if lse is None else torch.from_numpy(lse),
        dlse=None if dlse is None else torch.from_numpy(dlse))
    for a, b in zip(got, want):
        _close(a, b)


def test_ragged_backward_where_jax_falls_back_to_dense(monkeypatch):
    """S=648 has no 128-multiple divisor: the JAX package runs (and
    differentiates) the dense reference there, the port the kernel's
    plain version with a backward whose last block is short. Same
    gradients. The JAX package warns once per shape and process, so the
    set of shapes it has warned about starts empty here, whatever ran
    before in this process."""
    monkeypatch.setattr(jattn, "_fallback_warned", set())
    q, k, v = _qkv(13, 648, 648, B=1, H=1, D=8)
    rng = np.random.default_rng(14)
    do = rng.standard_normal(q.shape, dtype=np.float32)
    dlse = rng.standard_normal((1, 1, 648), dtype=np.float32)
    assert tattn._fit_blocks(648, 512, 512) is None
    assert tattn._backward_blocks(648, 648, 512, 512) == (512, 512)
    with pytest.warns(RuntimeWarning, match="falling back"):
        _, gj = _vjp_jax(jattn.flash_attention_lse, q, k, v,
                         (jnp.asarray(do), jnp.asarray(dlse)))
    _, gt = _vjp_torch(tattn.flash_attention_lse, q, k, v, (do, dlse))
    for a, b in zip(gt, gj):
        _close(a, b, 1e-4)
