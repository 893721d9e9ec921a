"""The port's attention ops (mpi_acx_torch/ops) held against the JAX package.

Inputs are made from a seed with numpy and go through both packages: the
JAX kernels run as the JAX package's own tests run them on the CPU
(Pallas interpret mode), the port's wrappers take their plain PyTorch
versions because the tensors lie on the CPU. The CUDA kernels themselves
are held against those plain versions on the card by chip_smoke.py.
Tolerances: both sides compute in float32, so what differs is summation
order (and the online softmax's rescaling on the JAX side): 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mpi_acx_tpu.ops import attention as jattn
from mpi_acx_tpu.ops import flash_decode as jfd
from mpi_acx_tpu.ops import wquant as jwq
from mpi_acx_tpu.models import decoding as jdec
from mpi_acx_torch.ops import attention as tattn
from mpi_acx_torch.ops import flash_decode as tfd
from mpi_acx_torch.ops import wquant as twq

TOL = 1e-5


def _qkv(seed, S, Sk, B=2, H=3, D=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32),
            rng.standard_normal((B, Sk, H, D), dtype=np.float32))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [40, 64, 128])
def test_flash_attention_matches_jax_kernel(S, causal):
    q, k, v = _qkv(S, S, S)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_flash_attention_cross_length_matches_jax_kernel():
    """Non-causal with Sk != S (the cross/ring-block form)."""
    q, k, v = _qkv(7, 40, 64)
    want = jattn.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=False)
    got = tattn.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_reference_matches_jax_reference(dtype):
    """The plain version is the JAX reference, rounding points included
    (bf16 logits and probabilities): equal to bf16 resolution."""
    q, k, v = _qkv(3, 24, 24)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = jattn.attention_reference(*(jnp.asarray(x, jd) for x in (q, k, v)))
    got = tattn.attention_reference(*(torch.from_numpy(x).to(td)
                                      for x in (q, k, v)))
    tol = TOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


B, HKV, D, MAX_LEN, BLOCK_K = 3, 2, 16, 96, 32


def _decode_case(n_rep, W, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, W, HKV * n_rep, D), dtype=np.float32)
    kc = rng.standard_normal((B, MAX_LEN, HKV, D), dtype=np.float32)
    vc = rng.standard_normal((B, MAX_LEN, HKV, D), dtype=np.float32)
    return q, kc, vc


@pytest.mark.parametrize("posmode", ["scalar", "vector"])
@pytest.mark.parametrize("n_rep", [1, 2])
@pytest.mark.parametrize("W", [1, 3])
def test_flash_decode_matches_jax_kernel(W, n_rep, posmode):
    """Mirrors tests/test_flash_decode.py: GQA rows, window masking,
    scalar and per-slot positions (slot at 0, at a block edge, at the
    end), against the JAX decode kernel in interpret mode."""
    q, kc, vc = _decode_case(n_rep, W)
    pos = 41 if posmode == "scalar" else np.array([0, 63, MAX_LEN - W],
                                                  np.int32)
    want = jfd.flash_decode_attend(jnp.asarray(q), jnp.asarray(kc),
                                   jnp.asarray(vc), jnp.asarray(pos),
                                   MAX_LEN, n_rep, block_k=BLOCK_K)
    got = tfd.flash_decode_attend(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.as_tensor(pos), MAX_LEN, n_rep)
    assert got.shape == (B, W, HKV * n_rep * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_dense_decode_int8_cache_matches_jax():
    """The (codes, scales) operand form of the plain version: scales on
    the logits and probabilities, as the JAX dense reference applies
    them."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((B, 2, HKV * 2, D), dtype=np.float32)
    codes = [rng.integers(-127, 128, (B, MAX_LEN, HKV, D)).astype(np.int8)
             for _ in range(2)]
    scales = [rng.uniform(0.001, 0.02, (B, MAX_LEN, HKV, 1)).astype(
        np.float32) for _ in range(2)]
    pos = np.array([3, 50, 90], np.int32)
    want = jdec.dense_decode_attend(
        jnp.asarray(q), (jnp.asarray(codes[0]), jnp.asarray(scales[0])),
        (jnp.asarray(codes[1]), jnp.asarray(scales[1])), jnp.asarray(pos),
        MAX_LEN, 2)
    got = tfd.dense_decode_attend(
        torch.from_numpy(q),
        (torch.from_numpy(codes[0]), torch.from_numpy(scales[0])),
        (torch.from_numpy(codes[1]), torch.from_numpy(scales[1])),
        torch.from_numpy(pos), MAX_LEN, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


def test_select_switches():
    """False -> the plain version; True and None -> the kernel wrapper
    (which takes the plain version for a CPU tensor)."""
    assert tattn.select_attention(False) is tattn.attention_reference
    assert tattn.select_attention(True) is tattn.flash_attention
    assert tattn.select_attention(None) is tattn.flash_attention
    assert tfd.select_decode_attend(False) is tfd.dense_decode_attend
    assert tfd.select_decode_attend(True) is tfd.flash_decode_attend
    assert tfd.select_decode_attend(None) is tfd.flash_decode_attend


def test_kernel_wrappers_refuse_other_devices():
    """Off the CPU a wrapper launches its kernel or raises — never a quiet
    plain-version path, for a bf16/f32 cache and an int8 one alike."""
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tattn.flash_attention(q, q, q)
    qd = torch.empty((1, 1, 2, 64), device="meta")
    kc = torch.empty((1, 32, 2, 64), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfd.flash_decode_attend(qd, kc, kc, 3, 32, 1)
    codes = (torch.empty((1, 32, 2, 64), dtype=torch.int8, device="meta"),
             torch.empty((1, 32, 2, 1), device="meta"))
    with pytest.raises(ValueError, match="no kernel"):
        tfd.flash_decode_attend(qd, codes, codes, 3, 32, 1)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wread_matches_jax(dtype, quant):
    rng = np.random.default_rng(9)
    w = rng.standard_normal((2, 8, 6), dtype=np.float32)
    jlp, tlp = {"w1": jnp.asarray(w)}, {"w1": torch.from_numpy(w)}
    if quant:
        codes = rng.integers(-127, 128, w.shape).astype(np.int8)
        s = rng.uniform(0.01, 0.1, (2, 1, 6)).astype(np.float32)
        jlp = {"w1": jnp.asarray(codes), "w1_scale": jnp.asarray(s)}
        tlp = {"w1": torch.from_numpy(codes),
               "w1_scale": torch.from_numpy(s)}
    want = jwq.wread(jlp, "w1", getattr(jnp, dtype))
    got = twq.wread(tlp, "w1", getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
