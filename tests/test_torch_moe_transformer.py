"""The port's MoE transformer (mpi_acx_torch/models/moe_transformer.py)
held against the JAX package's (mpi_acx_tpu/models/moe_transformer.py) on
the CPU, and GPT-2's scaffold unchanged by its ``ffn`` hook.

Two float32 configs: ``tiny_moe_config`` (8 experts, head dim 16) and the
serving tests' fixture (tests/test_serving.py: vocab 61, d 48, 4 heads, 2
layers, d_ff 96, 4 experts). JAX's parameters cross into the port through
``moe_transformer.params_from_jax``; tokens come from a numpy seed. Both
keep the default capacity factor 2.0, so the decode steps' groups of 3
slots (capacity 1 at 8 experts) drop tokens, the same ones on both sides.
JAX runs its default CPU paths (dense attention) and, in the case marked
so, its Pallas decode kernel in interpret mode. Values agree within
rtol/atol 1e-5 (f32, summation order); greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import moe_transformer as jm
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import moe_transformer as tm
from mpi_acx_torch.models import transformer as tt

TOL = dict(rtol=1e-5, atol=1e-5)

CONFIGS = {"tiny": ({}, 0),
           "serving": (dict(vocab=61, d_model=48, n_heads=4, n_layers=2,
                            d_ff=96, max_seq=96, n_experts=4), 2)}


def _cfgs(**kw):
    return (dataclasses.replace(jm.tiny_moe_config(**kw), dtype=jnp.float32),
            dataclasses.replace(tm.tiny_moe_config(**kw),
                                dtype=torch.float32))


def _draw(jcfg, seed):
    """The JAX parameter tree, drawn with numpy (JAX's eager draw takes
    seconds on the CPU): weights N(0, 0.02), the norms' gains 1 and biases
    0, as ``init_params`` lays them out."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name.endswith("_g"):
            return np.ones(s.shape, np.float32)
        if name.endswith("_b"):
            return np.zeros(s.shape, np.float32)
        return (rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    shapes = jax.eval_shape(lambda: jm.init_params(jax.random.key(0), jcfg))
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def models(request):
    kw, seed = CONFIGS[request.param]
    jcfg, tcfg = _cfgs(**kw)
    np_params = _draw(jcfg, seed)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, jparams, tcfg, tm.params_from_jax(np_params, device="cpu")


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def test_configs_match_jax():
    for jcfg, tcfg in ((jm.MoeTransformerConfig(),
                        tm.MoeTransformerConfig()),
                       (jm.tiny_moe_config(), tm.tiny_moe_config())):
        for f in ("vocab", "d_model", "n_heads", "n_layers", "d_ff",
                  "n_experts", "top_k", "capacity_factor", "max_seq",
                  "head_dim"):
            assert getattr(tcfg, f) == getattr(jcfg, f), f
        assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
    cfg = tm.MoeTransformerConfig()
    assert (cfg.head_dim, cfg.dtype) == (64, torch.bfloat16)


def test_init_params_draws_the_jax_layout_on_the_device():
    jcfg, tcfg = _cfgs()
    jp = jax.eval_shape(lambda: jm.init_params(jax.random.key(0), jcfg))
    tp = tm.init_params(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
    again = tm.init_params(tcfg, seed=3, device="cpu", dtype=torch.bfloat16)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node, twin = tp, again
        for p in path:
            node, twin = node[p.key], twin[p.key]
        assert tuple(node.shape) == leaf.shape
        assert node.dtype == torch.bfloat16
        assert torch.equal(node, twin)
    assert abs(tp["layers"]["w1"].float().std().item() - 0.02) < 2e-3
    assert torch.equal(tp["layers"]["ln2_g"],
                       torch.ones_like(tp["layers"]["ln2_g"]))


def test_params_from_jax_keeps_layout(models):
    _, jparams, _, tparams = models
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        node = tparams
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_forward_and_block_aux_match_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(3, (2, 16), jcfg.vocab)
    got, aux = tm.forward(tparams, tcfg, torch.from_numpy(toks))
    want, jaux = jm.forward(jparams, jcfg, jnp.asarray(toks))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    for key in ("load_balance", "router_z"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), **TOL)


@pytest.mark.parametrize("xent_chunk", [None, 16], ids=["full", "chunked"])
def test_loss_fn_matches_jax(models, xent_chunk):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(4, (2, 12), jcfg.vocab)
    tg = np.roll(toks, -1, axis=-1)
    got = tm.loss_fn(tparams, tcfg, torch.from_numpy(toks),
                     torch.from_numpy(tg), aux_weight=0.1, z_weight=0.01,
                     xent_chunk=xent_chunk)
    want = jm.loss_fn(jparams, jcfg, jnp.asarray(toks), jnp.asarray(tg),
                      aux_weight=0.1, z_weight=0.01, xent_chunk=xent_chunk)
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("mode", ["full", "last_only", "last_index"])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_prefill_matches_jax(models, mode, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    toks = _tokens(5, (2, 12), jcfg.vocab)
    kw = dict(last_only=mode == "last_only", kv_int8=kv_int8,
              last_index=7 if mode == "last_index" else None)
    lg, cache = tm.prefill(tparams, tcfg, torch.from_numpy(toks), 20, **kw)
    jlg, jcache = jm.prefill(jparams, jcfg, jnp.asarray(toks), 20, **kw)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    assert sorted(cache) == sorted(jcache)
    assert int(cache["pos"]) == int(jcache["pos"]) == 12
    if not kv_int8:
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(cache[key]),
                                       np.asarray(jcache[key]), **TOL)
        return
    for key, sk in (("k", "ks"), ("v", "vs")):
        assert cache[key].dtype == torch.int8
        got = _np(cache[key]).astype(np.float32) * _np(cache[sk])
        want = np.asarray(jcache[key], np.float32) * np.asarray(jcache[sk])
        np.testing.assert_allclose(got, want, **TOL)


def _random_cache(rng, jcfg, B, max_len, pos):
    shape = (jcfg.n_layers, B, max_len, jcfg.n_heads, jcfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.asarray(pos)}
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "pos": torch.from_numpy(pos.copy())}
    return jc, tc


def test_decode_step_per_slot_positions_match_jax(models):
    """Two steps from the same cache with one position per slot: logits,
    tokens, every cache row and the positions after each."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(6)
    jc, tc = _random_cache(rng, jcfg, 3, 24, [3, 10, 17])
    tok = _tokens(7, (3,), jcfg.vocab)
    for _ in range(2):
        lg, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
        jlg, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
        np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
        tok = np.asarray(jnp.argmax(jlg, axis=-1)).astype(np.int32)
        np.testing.assert_array_equal(_np(lg.argmax(-1)), tok)
        np.testing.assert_array_equal(_np(tc["pos"]), np.asarray(jc["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]),
                                       **TOL)


def test_decode_step_matches_jax_decode_kernel():
    """JAX through its Pallas decode kernel (interpret mode), the port
    through the kernel's plain version on the CPU: tiny_moe_config (head
    dim 16), max_len 128, slots at 0, mid-cache and the last row."""
    jcfg, tcfg = _cfgs()
    jcfg = dataclasses.replace(jcfg, decode_flash=True)
    np_params = _draw(jcfg, 4)
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = tm.params_from_jax(np_params, device="cpu")
    jc, tc = _random_cache(np.random.default_rng(8), jcfg, 3, 128,
                           [0, 70, 127])
    tok = _tokens(9, (3,), jcfg.vocab)
    lg, tc = tm.decode_step(tparams, tcfg, tc, torch.from_numpy(tok))
    jlg, jc = jm.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tc[key]), np.asarray(jc[key]), **TOL)


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32", "int8"])
def test_generate_matches_jax(models, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    prompt = _tokens(10, (2, 7), jcfg.vocab)
    got = tm.generate(tparams, tcfg, torch.from_numpy(prompt), 4,
                      max_len=16, kv_int8=kv_int8, device="cpu")
    want = jm.generate(jparams, jcfg, jnp.asarray(prompt), 4, max_len=16,
                       kv_int8=kv_int8)
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_moe_ffn_aux_equals_the_block_router():
    """``_moe_ffn(with_aux=True)`` is the block's FFN half and its
    router's losses."""
    jcfg, tcfg = _cfgs()
    tparams = tm.init_params(tcfg, seed=1, device="cpu")
    lp = tt._layer(tparams, 0)
    h = torch.randn(2, 8, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    out, (lb, rz) = tm._moe_ffn(tcfg, lp, h, with_aux=True)
    torch.testing.assert_close(tm._moe_ffn(tcfg, lp, h), out, rtol=0,
                               atol=0)
    hn = tt.layernorm(h, lp["ln2_g"], lp["ln2_b"]).reshape(16, -1)
    y, aux = tm.moe_layer_and_aux(tm._experts(lp), hn, tcfg.moe)
    torch.testing.assert_close(out, h + y.reshape(h.shape), rtol=0, atol=0)
    assert (float(lb), float(rz)) == (float(aux["load_balance"]),
                                      float(aux["router_z"]))


def test_quantized_experts_are_refused():
    _, tcfg = _cfgs()
    tparams = tm.init_params(tcfg, seed=0, device="cpu")
    lp = dict(tt._layer(tparams, 0), w1_scale=torch.ones(1))
    with pytest.raises(ValueError, match="int8 weight-only"):
        tm._moe_ffn(tcfg, lp, torch.zeros(1, 2, tcfg.d_model))


def test_generate_sample_is_not_ported():
    """generate_sample, once a stub that raised, is ported: at temperature
    0 it is the greedy decode (tests/test_torch_sampling.py holds its
    draws)."""
    cfg = tm.tiny_moe_config(vocab=31, d_model=16, n_heads=2, n_layers=1,
                             d_ff=16, n_experts=4, capacity_factor=4.0,
                             max_seq=16)
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    params = tm.init_params(cfg, seed=0, device="cpu")
    prompt = torch.arange(4, dtype=torch.int32)[None]
    got = tm.generate_sample(params, cfg, prompt, 5, torch.Generator(),
                             temperature=0.0, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), tm.generate(params, cfg, prompt, 5, device="cpu").numpy())


@pytest.fixture(scope="module")
def gpt2():
    cfg = dict(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
               max_seq=32)
    jcfg = dataclasses.replace(jt.tiny_config(**cfg), dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.tiny_config(**cfg), dtype=torch.float32)
    np_params = jax.tree.map(lambda t: t.numpy(),
                             tt.init_params(tcfg, seed=5, device="cpu"))
    return (jcfg, jax.tree.map(jnp.asarray, np_params), tcfg,
            tt.params_from_jax(np_params, device="cpu"))


def test_gpt2_scaffold_is_unchanged_by_the_hook(gpt2):
    """``ffn=None`` is GPT-2's MLP: prefill and decode equal JAX's GPT-2
    and the port's own calls without the argument, bit for bit."""
    jcfg, jparams, tcfg, tparams = gpt2
    toks = _tokens(11, (2, 9), jcfg.vocab)
    lg, cache = tt.prefill(tparams, tcfg, torch.from_numpy(toks), 16,
                           ffn=None)
    lg0, cache0 = tt.prefill(tparams, tcfg, torch.from_numpy(toks), 16)
    jlg, jc = jt.prefill(jparams, jcfg, jnp.asarray(toks), 16)
    assert torch.equal(lg, lg0) and torch.equal(cache["k"], cache0["k"])
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
    tok = _tokens(12, (2,), jcfg.vocab)
    lg, cache = tt.decode_step(tparams, tcfg, cache, torch.from_numpy(tok),
                               ffn=None)
    lg0, _ = tt.decode_step(tparams, tcfg, cache0, torch.from_numpy(tok))
    jlg, _ = jt.decode_step(jparams, jcfg, jc, jnp.asarray(tok))
    assert torch.equal(lg, lg0)
    np.testing.assert_allclose(_np(lg), np.asarray(jlg), **TOL)
