"""The port's GPT-2 family (mpi_acx_torch/models) held against the JAX
package on a tiny float32 config.

The JAX parameters cross into the port through ``params_from_jax``, so both
packages compute the same function; prompts come from a numpy seed. JAX
runs its default CPU paths (dense attention) and, in one case, its Pallas
kernels in interpret mode. Logits agree to 1e-4 (f32, summation order
over a few layers); greedy tokens must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import transformer as tt

TOL = 1e-4


def _cfgs(**kw):
    base = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                max_seq=96)
    jcfg = dataclasses.replace(jt.tiny_config(**base), dtype=jnp.float32,
                               **kw)
    tcfg = dataclasses.replace(tt.tiny_config(**base), dtype=torch.float32)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = _cfgs()
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _tokens(seed, shape, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def test_params_from_jax_keeps_layout_and_dtype(models):
    jcfg, jparams, _, tparams = models
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)
    assert len(flat_j) == 14
    for path, leaf in flat_j:
        node = tparams
        for p in path:
            node = node[p.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    bf = tt.params_from_jax(jax.device_get(jt.cast_params(jparams)),
                            device="cpu")
    assert bf["layers"]["wqkv"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jparams["embed"].astype(jnp.bfloat16), np.float32))


def test_init_params_scheme():
    """Same tree, shapes and N(0, 0.02) scheme as the JAX init (not the
    same numbers: the two generators differ); a seed fixes the draw."""
    _, tcfg = _cfgs()
    p = tt.init_params(tcfg, seed=1, device="cpu")
    q = tt.init_params(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda a: a.shape, jt.init_params(
        jax.random.key(0), _cfgs()[0]))
    assert jax.tree.map(lambda a: tuple(a.shape), p,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)
                        ) == shapes
    torch.testing.assert_close(p["embed"], q["embed"], rtol=0, atol=0)
    assert abs(p["layers"]["w1"].std().item() - 0.02) < 2e-3
    assert torch.equal(p["layers"]["ln1_g"], torch.ones(2, 48))


def test_forward_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(1, (2, 20))
    want = jt.forward(jparams, jcfg, jnp.asarray(tok))
    got = tt.forward(tparams, tcfg, torch.from_numpy(tok))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)


@pytest.mark.parametrize("mode", ["full", "last_only", "last_index"])
def test_prefill_matches_jax(models, mode):
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(2, (2, 16))
    kw = {"full": {}, "last_only": {"last_only": True},
          "last_index": {"last_index": 9}}[mode]
    jl, jc = jt.prefill(jparams, jcfg, jnp.asarray(tok), 32, **kw)
    tl, tc = tt.prefill(tparams, tcfg, torch.from_numpy(tok), 32, **kw)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    for key in ("k", "v"):
        assert tuple(tc[key].shape) == jc[key].shape == (2, 2, 32, 4, 12)
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   atol=TOL, rtol=TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 16


@pytest.mark.parametrize("posmode", ["scalar", "vector"])
def test_decode_step_matches_jax(models, posmode):
    """Three decode steps from a prefilled cache; vector pos puts each
    slot at its own position (the serving mode)."""
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(3, (3, 10))
    _, jc = jt.prefill(jparams, jcfg, jnp.asarray(tok), 24, last_only=True)
    _, tc = tt.prefill(tparams, tcfg, torch.from_numpy(tok), 24,
                       last_only=True)
    if posmode == "vector":
        pos = np.array([10, 4, 7], np.int32)
        jc["pos"] = jnp.asarray(pos)
        tc["pos"] = torch.from_numpy(pos)
    for step in range(3):
        nxt = _tokens(10 + step, (3,))
        jl, jc = jt.decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
        tl, tc = tt.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                                   rtol=TOL)
    np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                               atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


def test_decode_write_past_cache_clamps_like_jax(models):
    """A position past the cache: JAX's dynamic_update_slice clamps the
    write to the last row; the port's in-place write must do the same
    instead of indexing out of bounds."""
    jcfg, jparams, tcfg, tparams = models
    tok = _tokens(4, (2, 8))
    _, jc = jt.prefill(jparams, jcfg, jnp.asarray(tok), 8, last_only=True)
    _, tc = tt.prefill(tparams, tcfg, torch.from_numpy(tok), 8,
                       last_only=True)
    pos = np.array([8, 3], np.int32)                 # slot 0 is past the end
    jc["pos"], tc["pos"] = jnp.asarray(pos), torch.from_numpy(pos)
    nxt = _tokens(5, (2,))
    jl, jc = jt.decode_step(jparams, jcfg, jc, jnp.asarray(nxt))
    tl, tc = tt.decode_step(tparams, tcfg, tc, torch.from_numpy(nxt))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("jax_kernels", [False, True],
                         ids=["jax_dense", "jax_pallas"])
def test_generate_matches_jax(models, jax_kernels):
    """Greedy tokens equal, against JAX's dense paths and against its
    Pallas flash/flash-decode kernels (interpret mode)."""
    jcfg, jparams, tcfg, tparams = models
    if jax_kernels:
        jcfg = dataclasses.replace(jcfg, use_flash=True, decode_flash=True)
    tok = _tokens(6, (2, 16))
    want = jt.generate(jparams, jcfg, jnp.asarray(tok), 8, max_len=32)
    got = tt.generate(tparams, tcfg, torch.from_numpy(tok), 8, max_len=32,
                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_layernorm_and_cast_match_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 7, 48), dtype=np.float32) * 3 + 1
    g = rng.standard_normal(48, dtype=np.float32)
    b = rng.standard_normal(48, dtype=np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = jt.layernorm(jnp.asarray(x, jd), jnp.asarray(g),
                            jnp.asarray(b))
        got = tt.layernorm(torch.from_numpy(x).to(td), torch.from_numpy(g),
                           torch.from_numpy(b))
        assert got.dtype == td
        tol = 1e-5 if td == torch.float32 else 2e-2
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)
    cast = tt.cast_params({"a": torch.ones(2), "b": {"c": torch.zeros(3)}})
    assert cast["b"]["c"].dtype == torch.bfloat16


def test_bf16_logits_stay_f32():
    """The unembedding takes bf16 operands but returns f32 logits (never
    rounded to bf16 before an argmax), like JAX's
    preferred_element_type=float32."""
    _, tcfg = _cfgs()
    cfg = dataclasses.replace(tcfg, dtype=torch.bfloat16)
    params = tt.cast_params(tt.init_params(cfg, seed=0, device="cpu"))
    logits, cache = tt.prefill(params, cfg, torch.from_numpy(
        _tokens(7, (1, 12))), 16, last_only=True)
    assert logits.dtype == torch.float32 and cache["k"].dtype == cfg.dtype
    x = torch.randn(1, 1, 48).to(torch.bfloat16)
    emb = params["embed"]
    np.testing.assert_array_equal(
        tt._unembed(x, emb).numpy(),
        (x.float() @ emb.float().T).numpy())
