"""The port's continuous-batching server with the Llama family
(``serve_greedy(family=llama)``) held against the JAX package's server on
tests/test_serving.py's Llama fixture (head dim 12, 4 query heads over 2 KV
groups) in bf16 compute.

Both servers get the same prompts (numpy seed) and the same weights (the
JAX tree cast to bf16, through ``llama.params_from_jax``); the tokens must
be equal, bf16 and int8 KV, stepwise and in chunks of 4: five requests
through two slots (refills mid-stream), with requests longer than one
chunk. Every prompt fits one prefill bucket (8 tokens), so each JAX serve
compiles one prefill. With the port's capture cap
(``decoding.PREFILL_CAPTURE_MAX``) lowered to 4, the same requests are
served with every prompt above 4 tokens prefilled at its own length, and
the tokens must still equal the JAX server's (which pads every prompt).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import serving as js
from mpi_acx_torch.models import decoding
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import serving as ts

BASE = dict(vocab=61, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2,
            d_ff=96, max_seq=96)
N_NEW = [9, 3, 6, 1, 7]


@pytest.fixture(scope="module")
def models():
    jcfg = jl.tiny_llama(**BASE)
    tcfg = tl.tiny_llama(**BASE)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                           jl.init_params(jax.random.key(1), jcfg))
    tparams = tl.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, n, lens, vocab=61):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_greedy_llama_matches_jax(models, chunk, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(1, 5, [5, 8, 3, 7])
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=2,
                           max_len=32, family=jl, chunk=chunk,
                           kv_int8=kv_int8)
    got = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                          max_len=32, family=tl, chunk=chunk,
                          kv_int8=kv_int8, device="cpu")
    assert len(got) == len(want) == 5
    for g, w, p, n in zip(got, want, prompts, N_NEW):
        assert len(g) == len(p) + n
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.prefills == want.metrics.prefills == 5
    assert got.metrics.new_tokens == sum(N_NEW)
    assert got.metrics.steps == want.metrics.steps


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_unpadded_prefill_matches_jax(models, monkeypatch, chunk, kv_int8):
    """The cap at 4 tokens: prompts of 5, 8 and 7 tokens are seated at
    their own length (the 3-token one still in its 8 bucket), bf16 and
    int8 slot caches, and the tokens equal the JAX server's, whose every
    prefill is padded to 8."""
    jcfg, jparams, tcfg, tparams = models
    monkeypatch.setattr(decoding, "PREFILL_CAPTURE_MAX", 4)
    widths = []
    padded = ts._padded

    def spy(prompt, *a):
        out = padded(prompt, *a)
        widths.append(out.shape[1])
        return out

    monkeypatch.setattr(ts, "_padded", spy)
    prompts = _prompts(1, 5, [5, 8, 3, 7])
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=2,
                           max_len=32, family=jl, chunk=chunk,
                           kv_int8=kv_int8)
    got = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                          max_len=32, family=tl, chunk=chunk,
                          kv_int8=kv_int8, device="cpu")
    assert widths == [5, 8, 8, 7, 5]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.steps == want.metrics.steps


def test_served_equals_solo_generate(models):
    """Per-slot positions make each slot's math its solo run's."""
    _, _, tcfg, tparams = models
    prompts = _prompts(2, 4, [6, 2, 8])
    n_new = [5, 8, 2, 6]
    got = ts.serve_greedy(tparams, tcfg, prompts, n_new, n_slots=3,
                          max_len=24, family=tl, chunk=2, device="cpu")
    for p, g, n in zip(prompts, got, n_new):
        solo = tl.generate(tparams, tcfg, torch.from_numpy(p)[None], n,
                           max_len=24, device="cpu")
        np.testing.assert_array_equal(g, solo[0].numpy())


def test_slot_cache_is_gqa_and_scatter_lands_rows(models):
    """The server's slot cache holds the KV groups ([L, B, max_len, Hkv,
    Dh]) and a prefilled request lands in its slot's rows."""
    _, _, tcfg, tparams = models
    prefill_fn, _, scatter_fn, _, _, _ = ts.make_server_fns(
        tparams, tcfg, tl, chunk=1, kv_int8=True)
    slots = tl.init_kv_cache(tcfg, 3, 16, kv_int8=True, device="cpu")
    slots["pos"] = torch.zeros(3, dtype=torch.int32)
    toks = torch.from_numpy(_prompts(3, 1, [8])[0])[None]
    _, one = prefill_fn(toks, 7)
    slots = scatter_fn(slots, one, 1, 8)
    assert slots["k"].shape == (tcfg.n_layers, 3, 16, tcfg.n_kv_heads,
                                tcfg.head_dim)
    for key in ("k", "v", "ks", "vs"):
        assert torch.equal(slots[key][:, 1, :8], one[key][:, 0])
        assert not slots[key][:, (0, 2)].any()
    assert slots["pos"].tolist() == [0, 8, 0]


def test_paged_server_refuses_llama(models):
    """Paged serving is GPT-2's alone, in the port as in the JAX package
    (mpi_acx_tpu/models/kvpage.py refuses another family)."""
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError, match="llama"):
        ts.serve_paged_greedy(tparams, tcfg, _prompts(4, 1, [4]), 2,
                              n_slots=1, max_len=16, family=tl,
                              device="cpu")
