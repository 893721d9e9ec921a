"""The port's int8 KV cache (mpi_acx_torch/ops/kvquant.py and the int8
carry of models/decoding.py, transformer.py, serving.py) held against the
JAX package.

Inputs come from a numpy seed. ``kv_quant`` must equal the JAX function as
every JAX decode path runs it (under ``jax.jit``) bit for bit, in f32 and
bf16. The decode scaffolds, given the same K/V, fill the same codes and
scales. End to end the models run in float32 on a tiny config with the JAX
weights (``params_from_jax``): greedy tokens must be equal; decode logits
agree to 1e-4 (summation order over a few layers). K2's int8 form is held
to the JAX decode kernel's ``quant=True`` branch in interpret mode: with
f32 queries both sides dequantize exactly, so 1e-5 is summation order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import decoding as jdec
from mpi_acx_tpu.models import serving as js
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_tpu.ops import flash_decode as jfd
from mpi_acx_tpu.ops import kvquant as jkq
from mpi_acx_torch.models import decoding as tdec
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt
from mpi_acx_torch.ops import flash_decode as tfd
from mpi_acx_torch.ops import kvquant as tkq

TOL = 1e-4
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _torch(a, dtype=None):
    """A numpy or JAX array as a CPU tensor (bf16 through f32)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _bits(t):
    t = t.float() if t.dtype == torch.bfloat16 else t
    return t.numpy().view(np.int32) if t.dtype == torch.float32 \
        else t.numpy()


def _edge_vectors(seed, shape=(3, 17, 2, 64)):
    """Random vectors over ten decades of magnitude, plus an all-zero
    vector, a vector of 1e-20s and one of exact halves (ties of the
    round)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    x *= (10.0 ** rng.uniform(-7, 3, shape[:-1] + (1,))).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 0] = 1e-20
    x[1, 0, 0] = np.arange(64) - 31.5
    return x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kv_quant_bit_equals_jax(dtype, seed):
    jd, td = DTYPES[dtype]
    x = _edge_vectors(seed)
    jq, js_ = jax.jit(jkq.kv_quant)(jnp.asarray(x, jd))
    tq, ts_ = tkq.kv_quant(torch.from_numpy(x).to(td))
    assert tq.dtype == torch.int8 and ts_.dtype == torch.float32
    assert tuple(ts_.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts_), np.asarray(js_).view(np.int32))
    jback = jax.jit(jkq.kv_dequant, static_argnums=2)(jq, js_, jd)
    tback = tkq.kv_dequant(tq, ts_, td)
    assert tback.dtype == td
    np.testing.assert_array_equal(_bits(tback),
                                  _bits(_torch(jback)))


def test_kv_quant_round_trip_bound():
    """Symmetric codes: |dequant - x| <= scale / 2 per element, codes
    within +-127, the largest element of each vector at +-127."""
    x = torch.from_numpy(_edge_vectors(3))
    q, s = tkq.kv_quant(x)
    err = (tkq.kv_dequant(q, s, torch.float32) - x).abs()
    assert (err <= s / 2 * (1 + 1e-6)).all()
    assert q.abs().max() == 127 and q.min() >= -127
    big = x.abs().amax(-1) > 1e-6
    assert (q.abs().amax(-1)[big] == 127).all()


def _base():
    return dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                max_seq=96)


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jt.tiny_config(**_base()), dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.tiny_config(**_base()), dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def test_init_kv_cache_int8_matches_jax(models):
    jcfg, _, tcfg, _ = models
    want = jt.init_kv_cache(jcfg, 3, 16, kv_int8=True)
    got = tt.init_kv_cache(tcfg, 3, 16, kv_int8=True, device="cpu")
    assert sorted(got) == sorted(want) == ["k", "ks", "pos", "v", "vs"]
    for key in ("k", "v", "ks", "vs"):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype)[6:] == str(want[key].dtype)
        assert not got[key].any()
    assert tuple(got["ks"].shape) == (2, 3, 16, 4, 1)


def test_fill_kv_cache_quantizes_like_jax(models):
    """The same prefill K/V land as the same codes and scales."""
    jcfg, _, tcfg, _ = models
    rng = np.random.default_rng(4)
    k = rng.standard_normal((2, 3, 10, 4, 12), dtype=np.float32)
    v = rng.standard_normal((2, 3, 10, 4, 12), dtype=np.float32)
    want = jax.jit(lambda c, a, b: jdec.fill_kv_cache(c, a, b, 10))(
        jt.init_kv_cache(jcfg, 3, 16, kv_int8=True), jnp.asarray(k),
        jnp.asarray(v))
    got = tdec.fill_kv_cache(tt.init_kv_cache(tcfg, 3, 16, kv_int8=True,
                                              device="cpu"),
                             torch.from_numpy(k), torch.from_numpy(v), 10)
    for key in ("k", "v", "ks", "vs"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
    assert int(got["pos"]) == int(want["pos"]) == 10


@pytest.mark.parametrize("posmode", ["scalar", "vector"])
def test_int8_decode_step_matches_jax(models, posmode):
    """Prefill into an int8 cache, then three decode steps (vector pos:
    each slot at its own position): logits within TOL, the same cache
    codes but where an f32 summation-order difference moved a value across
    a rounding edge (at most one code step, rarely)."""
    jcfg, jparams, tcfg, tparams = models
    tok = np.random.default_rng(5).integers(0, 61, (3, 10)).astype(np.int32)
    _, jc = jt.prefill(jparams, jcfg, jnp.asarray(tok), 24, last_only=True,
                       kv_int8=True)
    _, tc = tt.prefill(tparams, tcfg, torch.from_numpy(tok), 24,
                       last_only=True, kv_int8=True)
    if posmode == "vector":
        pos = np.array([10, 4, 7], np.int32)
        jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    step = jax.jit(lambda c, t: jt.decode_step(jparams, jcfg, c, t))
    for i in range(3):
        nxt = np.random.default_rng(10 + i).integers(0, 61, 3).astype(
            np.int32)
        jl, jc = step(jc, jnp.asarray(nxt))
        tl, tc = tt.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    for key in ("k", "v"):
        diff = np.abs(tc[key].numpy().astype(np.int32)
                      - np.asarray(jc[key]).astype(np.int32))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-2
    np.testing.assert_allclose(tc["ks"].numpy(), np.asarray(jc["ks"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_generate_int8_matches_jax():
    """bf16 compute, int8 cache (the f32 path is held by the decode step
    and serving tests)."""
    jd, td = DTYPES["bfloat16"]
    jcfg = dataclasses.replace(jt.tiny_config(**_base()), dtype=jd)
    tcfg = dataclasses.replace(tt.tiny_config(**_base()), dtype=td)
    jparams = jt.init_params(jax.random.key(1), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    tok = np.random.default_rng(6).integers(0, 61, (2, 12)).astype(np.int32)
    want = jax.jit(lambda t: jt.generate(jparams, jcfg, t, 10, max_len=32,
                                         kv_int8=True))(jnp.asarray(tok))
    got = tt.generate(tparams, tcfg, torch.from_numpy(tok), 10, max_len=32,
                      kv_int8=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype,chunk", [("float32", 1), ("bfloat16", 3)])
def test_serve_greedy_int8_matches_jax(dtype, chunk):
    """7 requests, mixed n_new, 3 int8 slots: the port's tokens equal the
    JAX server's, and each its own solo int8 generate."""
    jd, td = DTYPES[dtype]
    jcfg = dataclasses.replace(jt.tiny_config(**_base()), dtype=jd)
    tcfg = dataclasses.replace(tt.tiny_config(**_base()), dtype=td)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 61, n).astype(np.int32)
               for n in (5, 9, 3, 12, 7, 6, 10)]
    n_new = [6, 3, 8, 1, 5, 7, 2]
    want = js.serve_greedy(jparams, jcfg, prompts, n_new, n_slots=3,
                           max_len=32, chunk=chunk, kv_int8=True)
    got = ts.serve_greedy(tparams, tcfg, prompts, n_new, n_slots=3,
                          max_len=32, chunk=chunk, kv_int8=True,
                          device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.steps == want.metrics.steps
    for p, g, n in zip(prompts[:3], got, n_new):
        solo = tt.generate(tparams, tcfg, torch.from_numpy(p)[None], n,
                           max_len=32, kv_int8=True, device="cpu")
        np.testing.assert_array_equal(g, solo[0].numpy())


def test_server_fns_refuse_another_cache_type(models):
    _, _, tcfg, tparams = models
    fns = ts.make_server_fns(tparams, tcfg, tt, chunk=1, kv_int8=False)
    with pytest.raises(ValueError, match="kv_int8"):
        ts.serve_greedy(tparams, tcfg, [np.arange(4, dtype=np.int32)], 2,
                        n_slots=1, max_len=16, server_fns=fns, kv_int8=True,
                        device="cpu")


@pytest.mark.parametrize("posmode", ["scalar", "vector"])
def test_flash_decode_int8_matches_jax_kernel(posmode):
    """K2's int8 operand form: the port's wrapper (its plain version on a
    CPU tensor) against the JAX decode kernel's quant branch in interpret
    mode, f32 queries, GQA rows and a window of 2."""
    rng = np.random.default_rng(8)
    B, Hkv, D, L, n_rep, W = 3, 2, 16, 96, 2, 2
    q = rng.standard_normal((B, W, Hkv * n_rep, D), dtype=np.float32)
    kc = jax.jit(jkq.kv_quant)(jnp.asarray(
        rng.standard_normal((B, L, Hkv, D), dtype=np.float32)))
    vc = jax.jit(jkq.kv_quant)(jnp.asarray(
        rng.standard_normal((B, L, Hkv, D), dtype=np.float32)))
    pos = 41 if posmode == "scalar" else np.array([0, 63, L - W], np.int32)
    want = jfd.flash_decode_attend(jnp.asarray(q), kc, vc, jnp.asarray(pos),
                                   L, n_rep, block_k=32)
    got = tfd.flash_decode_attend(
        torch.from_numpy(q), tuple(map(_torch, kc)), tuple(map(_torch, vc)),
        torch.as_tensor(pos), L, n_rep)
    assert got.shape == (B, W, Hkv * n_rep * D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
