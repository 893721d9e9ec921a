"""B10 (flash_attention_lse) and B7 (the streaming entry of
flash_attention) of the port, held against the JAX package (the backward:
test_torch_flash_backward.py).

Inputs are made from a seed with numpy and go through both packages: the
JAX kernels run as the JAX package's own tests run them on the CPU (Pallas
interpret mode); the port's wrappers take their plain versions because the
tensors lie on the CPU. The CUDA kernels are held against the plain
versions on the card by chip_smoke.py. Tolerance: both sides compute in
float32 and differ in summation order (and the online softmax's rescaling
on the JAX side): 1e-5 on values and lse.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_acx_tpu.ops import attention as jattn
from mpi_acx_torch.ops import attention as tattn

TOL = 1e-5


def _qkv(seed, S, Sk, B=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32))


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("S,Sk,causal", [(32, 32, True), (64, 64, True),
                                         (64, 64, False), (40, 64, False),
                                         (64, 24, False)])
def test_flash_attention_lse_matches_jax_kernel(S, Sk, causal):
    """o and lse of B10's plain version against the JAX kernel, causal and
    non-causal, Sk equal to and different from S."""
    q, k, v = _qkv(S + Sk, S, Sk)
    o_j, lse_j = jattn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o_t, lse_t = tattn.flash_attention_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert o_t.shape == (2, S, 3, 16) and o_t.dtype == torch.float32
    assert lse_t.shape == (2, 3, S) and lse_t.dtype == torch.float32
    _close(o_t, o_j)
    _close(lse_t, lse_j)


@pytest.mark.parametrize("S,Sk,causal", [(32, 32, True), (24, 40, False)])
def test_flash_attention_lse_at_head_dim_128_matches_jax_kernel(S, Sk,
                                                                causal):
    """Llama-3-8B's head dim: o and lse of B10's plain version against the
    JAX kernel (whose q is scaled by 1/sqrt(128) and rounded before the
    product, not folded into the exponent as at 64)."""
    q, k, v = _qkv(S * Sk, S, Sk, B=1, H=2, D=128)
    o_j, lse_j = jattn.flash_attention_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal)
    o_t, lse_t = tattn.flash_attention_lse(
        *map(torch.from_numpy, (q, k, v)), causal=causal)
    assert o_t.shape == (1, S, 2, 128) and lse_t.shape == (1, 2, S)
    _close(o_t, o_j)
    _close(lse_t, lse_j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_lse_matches_jax_reference(dtype):
    """The plain version is the JAX package's ``_reference_lse``, rounding
    points included: equal to bf16 resolution in bf16."""
    q, k, v = _qkv(3, 24, 24)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    o_j, lse_j = jattn._reference_lse(*(jnp.asarray(x, jd)
                                        for x in (q, k, v)))
    o_t, lse_t = tattn._reference_lse(*(torch.from_numpy(x).to(td)
                                        for x in (q, k, v)))
    assert o_t.dtype == td and lse_t.dtype == torch.float32
    tol = TOL if dtype == "float32" else 2e-2
    _close(o_t.float(), np.asarray(o_j, np.float32), tol)
    _close(lse_t, lse_j, tol)


def test_two_block_merge_equals_full_call():
    """Attending to the K/V halves apart and merging by logaddexp equals
    the whole call (the ring-attention merge), on the port as on JAX."""
    q, k, v = map(torch.from_numpy, _qkv(1, 48, 64))
    o_full, lse_full = tattn.flash_attention_lse(q, k, v, causal=False)
    o1, l1 = tattn.flash_attention_lse(q, k[:, :40], v[:, :40], causal=False)
    o2, l2 = tattn.flash_attention_lse(q, k[:, 40:], v[:, 40:], causal=False)
    lse = torch.logaddexp(l1, l2)
    w1 = torch.exp(l1 - lse).transpose(1, 2)[..., None]
    w2 = torch.exp(l2 - lse).transpose(1, 2)[..., None]
    _close(o1 * w1 + o2 * w2, o_full.numpy())
    _close(lse, lse_full.numpy())
    o_j, _ = jattn.flash_attention_lse(*(jnp.asarray(x.numpy())
                                         for x in (q, k, v)), causal=False)
    _close(o_full, o_j)


@pytest.mark.parametrize("causal", [True, False])
def test_streaming_entry_matches_jax_streaming_kernel(causal):
    """B7: the port's flash_attention(streaming=True) against the JAX
    streaming kernel (interpret mode), several K/V tiles per row."""
    q, k, v = _qkv(11, 64, 64)
    want = jattn.flash_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                                 streaming=True, block_q=16, block_k=16)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal, streaming=True, block_q=16,
                                block_k=16)
    _close(got, want)


def test_streaming_auto_rule(monkeypatch):
    """streaming=None turns the streaming entry on exactly at Sk >= 16384,
    as the JAX package's rule does; an explicit flag wins."""
    seen = []

    def spy(q, k, v, causal, bq, bk, streaming):
        seen.append(streaming)
        return torch.zeros_like(q)

    monkeypatch.setattr(tattn._Flash, "apply", spy)
    for Sk in (16383, 16384):
        q = torch.zeros((1, 8, 1, 4))
        kv = torch.zeros((1, Sk, 1, 4)).expand(1, Sk, 1, 4)
        tattn.flash_attention(q, kv, kv, causal=False)
        tattn.flash_attention(q, kv, kv, causal=False, streaming=False)
    tattn.flash_attention(q, q, q, streaming=True)
    assert seen == [False, False, True, False, True]


def test_fit_blocks_matches_jax():
    for S in (8, 40, 64, 128, 256, 384, 512, 640, 648, 1000, 1024, 1536,
              16384):
        for bq, bk in ((512, 512), (128, 256), (16, 16), (1024, 512)):
            assert tattn._fit_blocks(S, bq, bk) == jattn._fit_blocks(
                S, bq, bk), (S, bq, bk)


def test_cpu_tensors_leave_new_counts_at_zero():
    """On CPU tensors neither B10 nor the streaming entry counts a launch
    (the kernels never ran), forward or backward."""
    tattn.flash_attention.launches_stream = 0
    tattn.flash_attention_lse.launches = 0
    xs = [torch.from_numpy(x).requires_grad_() for x in _qkv(15, 32, 32)]
    o, lse = tattn.flash_attention_lse(*xs)
    (o.sum() + lse.sum() + tattn.flash_attention(
        *xs, streaming=True).sum()).backward()
    assert tattn.flash_attention.launches_stream == 0
    assert tattn.flash_attention_lse.launches == 0


@pytest.mark.parametrize("fn", ["flash_attention", "flash_attention_lse"])
def test_no_kernel_off_cuda_and_cpu(fn):
    """A tensor on neither the CPU nor a CUDA card raises: there is no
    kernel and no quiet plain path for it."""
    x = torch.zeros((1, 8, 1, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        getattr(tattn, fn)(x, x, x)
