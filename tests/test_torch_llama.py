"""The port's Llama family (mpi_acx_torch/models/llama.py) held against the
JAX package's (mpi_acx_tpu/models/llama.py) on the CPU.

Two float32 configs: ``tiny_llama`` (head dim 16) and the serving tests'
fixture (tests/test_serving.py, head dim 12). The JAX parameters cross into
the port through ``llama.params_from_jax``, so both packages compute the
same function; inputs come from a numpy seed. JAX runs its default CPU
paths (dense attention) and, in the decode cases marked so, its Pallas
decode kernel in interpret mode (``decode_flash=True``, head dim 16 and a
max_len of 128, as tests/test_torch_decode_split.py runs it). Values agree
within rtol/atol 1e-5 (f32, summation order); greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import llama as jl
from mpi_acx_torch.models import llama as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _tiny(**kw):
    jcfg = dataclasses.replace(jl.tiny_llama(**kw), dtype=jnp.float32)
    tcfg = dataclasses.replace(tl.tiny_llama(**kw), dtype=torch.float32)
    return jcfg, tcfg


# tiny_llama's defaults, and tests/test_serving.py's _llama fixture.
CONFIGS = {"tiny": ({}, 0),
           "serving": (dict(vocab=61, d_model=48, n_heads=4, n_kv_heads=2,
                            n_layers=2, d_ff=96, max_seq=96), 1)}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    kw, seed = CONFIGS[request.param]
    jcfg, tcfg = _tiny(**kw)
    jparams = jl.init_params(jax.random.key(seed), jcfg)
    tparams = tl.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_configs_match_jax():
    for jcfg, tcfg in ((jl.llama3_8b(), tl.llama3_8b()),
                       (jl.tiny_llama(), tl.tiny_llama())):
        for f in ("vocab", "d_model", "n_heads", "n_kv_heads", "n_layers",
                  "d_ff", "max_seq", "rope_theta", "head_dim"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
    cfg = tl.llama3_8b()
    assert (cfg.head_dim, cfg.n_heads // cfg.n_kv_heads) == (128, 4)


def test_params_from_jax_keeps_layout(models):
    _, jparams, _, tparams = models
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_init_params_draws_the_jax_layout_on_the_device():
    jcfg, tcfg = _tiny()
    jp = jax.eval_shape(lambda: jl.init_params(jax.random.key(0), jcfg))
    tp = tl.init_params(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
    again = tl.init_params(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node, twin = tp, again
        for p in path:
            node, twin = node[p.key], twin[p.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        assert torch.equal(node, twin)          # the seed fixes the draw
    wq = tp["layers"]["wq"].float()
    assert abs(wq.std().item() - 0.02) < 2e-3
    assert torch.equal(tp["final_norm"], torch.ones(tcfg.d_model,
                                                    dtype=torch.bfloat16))


def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 48)).astype(np.float32) * 3
    g = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.rmsnorm(torch.from_numpy(x), torch.from_numpy(g))),
        np.asarray(jl.rmsnorm(jnp.asarray(x), jnp.asarray(g))), **TOL)


@pytest.mark.parametrize("theta", [500000.0, 10000.0])
@pytest.mark.parametrize("D,max_seq", [(128, 8192), (16, 64), (12, 96)],
                         ids=["llama3_8b", "tiny", "serving"])
def test_rope_matches_jax(theta, D, max_seq):
    """Every position up to the config's max_seq, both thetas."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((1, max_seq, 2, D)).astype(np.float32)
    pos = np.arange(max_seq, dtype=np.int32)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


def test_rope_per_slot_positions_match_jax():
    """Decode's [B, 1] positions: each slot rotates by its own."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 1, 4, 16)).astype(np.float32)
    pos = np.array([[0], [17], [63]], np.int32)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("n_rep", [1, 4])
def test_repeat_kv_matches_jax(n_rep):
    x = np.random.default_rng(2).standard_normal((2, 3, 2, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        _np(tl._repeat_kv(torch.from_numpy(x), n_rep)),
        np.asarray(jl._repeat_kv(jnp.asarray(x), n_rep)))


def test_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(3, (2, 16), jcfg.vocab)
    got = tl.forward(tparams, tcfg, torch.from_numpy(toks))
    want = jl.forward(jparams, jcfg, jnp.asarray(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["full", "last_only", "last_index"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_matches_jax(models, mode, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(4, (2, 12), jcfg.vocab)
    kw = dict(last_only=mode == "last_only", kv_int8=kv_int8,
              last_index=7 if mode == "last_index" else None)
    lg, cache = tl.prefill(tparams, tcfg, torch.from_numpy(toks), 20, **kw)
    jlg, jcache = jl.prefill(jparams, jcfg, jnp.asarray(toks), 20, **kw)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    assert sorted(cache) == sorted(jcache)
    assert cache["k"].shape == (jcfg.n_layers, 2, 20, jcfg.n_kv_heads,
                                jcfg.head_dim)
    assert int(cache["pos"]) == int(jcache["pos"]) == 12
    if not kv_int8:
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]),
                                       np.asarray(jcache[key]), **TOL)
        return
    # int8: the dequantized entries (the codes times their scales).
    for key, sk in (("k", "ks"), ("v", "vs")):
        assert cache[key].dtype == torch.int8
        got = _np(cache[key]).astype(np.float32) * _np(cache[sk])
        want = np.asarray(jcache[key], np.float32) * np.asarray(jcache[sk])
        np.testing.assert_allclose(got, want, **TOL)


def _random_cache(rng, jcfg, B, max_len, pos):
    shape = (jcfg.n_layers, B, max_len, jcfg.n_kv_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos.copy())}
    return jc, tc


@pytest.mark.parametrize("pos", [[3, 10, 17], 9], ids=["per_slot", "scalar"])
def test_decode_step_matches_jax(models, pos):
    """Three steps from the same cache: logits, every cache row and the
    positions after each; per-slot positions rotate each slot by its own."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(5)
    jc, tc = _random_cache(rng, jcfg, 3, 24, pos)
    tok = _tokens(6, (3,), jcfg.vocab)
    for _ in range(3):
        lg, tc = tl.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        jlg, jc = jl.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        tok = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(lg.argmax(-1)), tok)
        np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                       **TOL)


def test_decode_step_matches_jax_decode_kernel():
    """JAX through its Pallas decode kernel (interpret mode), the port
    through the same kernel's plain version on the CPU: tiny_llama (head
    dim 16), max_len 128, per-slot positions at 0, mid-cache and the last
    row."""
    jcfg, tcfg = _tiny()
    jcfg = dataclasses.replace(jcfg, decode_flash=True)
    jparams = jl.init_params(jax.random.key(0), jcfg)
    tparams = tl.params_from_jax(jax.device_get(jparams), device="cpu")
    rng = np.random.default_rng(7)
    jc, tc = _random_cache(rng, jcfg, 3, 128, [0, 70, 127])
    tok = _tokens(8, (3,), jcfg.vocab)
    lg, tc = tl.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
    jlg, jc = jl.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax(models, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    prompt = _tokens(9, (2, 7), jcfg.vocab)
    got = tl.generate(tparams, tcfg, torch.from_numpy(prompt), 6,
                      max_len=16, kv_int8=kv_int8, device="cpu")
    want = jl.generate(jparams, jcfg, jnp.asarray(prompt), 6, max_len=16,
                       kv_int8=kv_int8)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_int8_decode_matches_jax(models):
    """Prefill into an int8 cache, then decode steps against it: logits
    and the codes' dequantized values as JAX's."""
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(10, (2, 9), jcfg.vocab)
    _, tc = tl.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                       kv_int8=True)
    _, jc = jl.prefill(jparams, jcfg, jnp.asarray(toks), 16, kv_int8=True)
    tok = _tokens(11, (2,), jcfg.vocab)
    for _ in range(3):
        lg, tc = tl.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        jlg, jc = jl.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        tok = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)
    for key, sk in (("k", "ks"), ("v", "vs")):
        got = _np(tc[key]).astype(np.float32) * _np(tc[sk])
        want = np.asarray(jc[key], np.float32) * np.asarray(jc[sk])
        np.testing.assert_allclose(got, want, **TOL)


def test_cache_layout_is_gqa():
    _, tcfg = _tiny()
    for kv_int8 in (False, True):
        c = tl.init_kv_cache(tcfg, 3, 32, kv_int8=kv_int8, device="cpu")
        assert c["k"].shape == (tcfg.n_layers, 3, 32, tcfg.n_kv_heads,
                                tcfg.head_dim)
        assert sorted(c) == (["k", "ks", "pos", "v", "vs"] if kv_int8
                             else ["k", "pos", "v"])
        if kv_int8:
            assert c["ks"].shape == c["k"].shape[:-1] + (1,)


def test_too_long_a_prompt_is_refused():
    _, tcfg = _tiny()
    params = tl.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="max_seq"):
        tl.forward(params, tcfg, torch.zeros((1, tcfg.max_seq + 1),
                                             dtype=torch.int64))
    with pytest.raises(ValueError, match="max_len"):
        tl.prefill(params, tcfg, torch.zeros((1, 9), dtype=torch.int64), 8)
