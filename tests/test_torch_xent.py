"""The port's chunked-vocab cross-entropy (mpi_acx_torch/ops/xent.py) held
against the JAX package's ``chunked_xent_ll`` (its custom VJP) and against
the naive log-softmax.

Inputs are made from a seed with numpy. Tolerance: both sides compute in
float32 and differ in summation order: 1e-5 on values and gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mpi_acx_tpu.ops import xent as jx
from mpi_acx_torch.ops import xent as tx

TOL = 1e-5
T, D, V = 24, 16, 61


def _case(seed):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((T, D), dtype=np.float32)
    head = rng.standard_normal((V, D), dtype=np.float32) * 0.5
    tg = rng.integers(0, V, T).astype(np.int32)
    tg[:3] = (0, V - 1, V // 2)            # first, last and a middle row
    g = rng.standard_normal(T, dtype=np.float32)
    return h, head, tg, g


@pytest.mark.parametrize("chunk", [7, 16, 61, 100])
def test_values_and_grads_match_jax(chunk):
    """Chunks that do not divide the vocabulary (7, 16), that equal it and
    that exceed it: the per-token values and the gradients of h and head
    under a random cotangent."""
    h, head, tg, g = _case(chunk)
    ll_j, vjp = jax.vjp(lambda a, b: jx.chunked_xent_ll(a, b, jnp.asarray(tg),
                                                        chunk),
                        jnp.asarray(h), jnp.asarray(head))
    dh_j, dhead_j = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(head).requires_grad_()
    ll_t = tx.chunked_xent_ll(th, thead, torch.from_numpy(tg), chunk)
    ll_t.backward(torch.from_numpy(g))
    assert ll_t.shape == (T,) and ll_t.dtype == torch.float32
    for got, want in ((ll_t, ll_j), (th.grad, dh_j), (thead.grad, dhead_j)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=TOL, rtol=TOL)


def test_equals_naive_log_softmax():
    h, head, tg, _ = _case(3)
    th, thead = (torch.from_numpy(x).requires_grad_() for x in (h, head))
    ll = tx.chunked_xent_ll(th, thead, torch.from_numpy(tg), 9)
    ll.sum().backward()
    got = (ll.detach(), th.grad.clone(), thead.grad.clone())
    th.grad = thead.grad = None
    naive = torch.log_softmax(th @ thead.T, -1).gather(
        1, torch.from_numpy(tg).long()[:, None])[:, 0]
    naive.sum().backward()
    for a, b in zip(got, (naive.detach(), th.grad, thead.grad)):
        torch.testing.assert_close(a, b, atol=TOL, rtol=TOL)


def test_bf16_hidden_states_keep_their_dtype():
    """h in bf16 computes in f32 and its gradient comes back in bf16, as
    in the JAX package (equal to bf16 resolution)."""
    h, head, tg, g = _case(4)
    hb = jnp.asarray(h, jnp.bfloat16)
    ll_j, vjp = jax.vjp(lambda a: jx.chunked_xent_ll(a, jnp.asarray(head),
                                                     jnp.asarray(tg), 16), hb)
    (dh_j,) = vjp(jnp.asarray(g))
    th = torch.from_numpy(h).to(torch.bfloat16).requires_grad_()
    ll_t = tx.chunked_xent_ll(th, torch.from_numpy(head),
                              torch.from_numpy(tg), 16)
    ll_t.backward(torch.from_numpy(g))
    assert th.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(ll_t.detach().numpy(), np.asarray(ll_j),
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(th.grad.float().numpy(),
                               np.asarray(dh_j, np.float32), atol=2e-2,
                               rtol=2e-2)
