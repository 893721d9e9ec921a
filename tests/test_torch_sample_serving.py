"""The port's sampled continuous batching (``serving.serve_sample``).

Request ``rid`` draws from its own generator, seeded
``decoding.fold_in(key, rid)``; its first token at refill, each later one
in a step, as its solo ``generate_sample`` run draws them. So every
request's tokens must equal that solo run's, whatever the slots, the
chunk and the refill order: held here for GPT-2 and Llama in bf16 compute
(the JAX tree cast to bf16), bf16 and int8 KV, chunk 1 and 4, seven
requests through three slots with top-k and top-p on. At temperature 0
the server is the greedy one, and its tokens equal the JAX package's
``serve_greedy`` (one prefill bucket: prompts of 8 tokens or fewer). A
``server_fns`` tuple built for other sampling settings is refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import serving as js
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import decoding as td
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt

GPT2 = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96, max_seq=96)
LLAMA = dict(vocab=61, d_model=48, n_heads=4, n_kv_heads=2, n_layers=2,
             d_ff=96, max_seq=96)
N_NEW = [6, 3, 8, 1, 5, 7, 2]
SAMPLE = dict(temperature=0.9, top_k=12, top_p=0.9)
KEY = 1234


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, jmod, tmod, kw, init in (
            ("gpt2", jt, tt, GPT2, jt.tiny_config),
            ("llama", jl, tl, LLAMA, jl.tiny_llama)):
        jcfg = init(**kw)
        tcfg = (tt.tiny_config if tmod is tt else tl.tiny_llama)(**kw)
        jparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16),
                               jmod.init_params(jax.random.key(1), jcfg))
        tparams = tmod.params_from_jax(jax.device_get(jparams), device="cpu")
        out[name] = (jmod, jcfg, jparams, tmod, tcfg, tparams)
    return out


def _prompts(seed, n, lens, vocab=61):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_served_sample_equals_solo_runs(models, family, chunk, kv_int8):
    _, _, _, tmod, tcfg, tparams = models[family]
    prompts = _prompts(1, 7, [5, 8, 3, 7])
    got = ts.serve_sample(tparams, tcfg, prompts, N_NEW, n_slots=3,
                          max_len=32, key=KEY, family=tmod, chunk=chunk,
                          kv_int8=kv_int8, device="cpu", **SAMPLE)
    assert got.metrics.prefills == 7
    assert got.metrics.new_tokens == sum(N_NEW)
    for rid, (g, p, n) in enumerate(zip(got, prompts, N_NEW)):
        solo = tmod.generate_sample(
            tparams, tcfg, torch.from_numpy(p)[None], n,
            td.key_generator(td.fold_in(KEY, rid), "cpu"), max_len=32,
            kv_int8=kv_int8, device="cpu", **SAMPLE)
        np.testing.assert_array_equal(g, solo[0].numpy(), err_msg=str(rid))


def test_schedule_does_not_perturb_a_sample_path(models):
    """Another slot count, chunk and key order: each request's tokens are
    the same; another key gives other tokens."""
    _, _, _, tmod, tcfg, tparams = models["gpt2"]
    prompts = _prompts(2, 6, [8, 4, 6])
    kw = dict(max_len=40, key=KEY, family=tmod, device="cpu", **SAMPLE)
    a = ts.serve_sample(tparams, tcfg, prompts, 9, n_slots=2, chunk=3, **kw)
    b = ts.serve_sample(tparams, tcfg, prompts, 9, n_slots=4, chunk=1, **kw)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    kw["key"] = KEY + 1
    c = ts.serve_sample(tparams, tcfg, prompts, 9, n_slots=2, chunk=3, **kw)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_temperature_zero_equals_jax_serve_greedy(models, family, kv_int8):
    jmod, jcfg, jparams, tmod, tcfg, tparams = models[family]
    prompts = _prompts(3, 5, [5, 8, 3, 7])
    n_new = N_NEW[:5]
    want = js.serve_greedy(jparams, jcfg, prompts, n_new, n_slots=2,
                           max_len=32, family=jmod, chunk=4,
                           kv_int8=kv_int8)
    got = ts.serve_sample(tparams, tcfg, prompts, n_new, n_slots=2,
                          max_len=32, key=KEY, family=tmod, chunk=4,
                          kv_int8=kv_int8, temperature=0.0, top_k=5,
                          device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.steps == want.metrics.steps


def test_mismatched_server_fns_are_refused(models):
    _, _, _, tmod, tcfg, tparams = models["gpt2"]
    prompts = _prompts(4, 1, [4])
    fns = ts.make_server_fns(tparams, tcfg, tmod, chunk=1,
                             sample_cfg=(0.9, 12, 0.9))
    assert len(fns) == 6 and fns[-1] == (0.9, 12, 0.9)
    with pytest.raises(ValueError, match="sampling settings"):
        ts.serve_sample(tparams, tcfg, prompts, 2, n_slots=1, max_len=16,
                        key=KEY, server_fns=fns, temperature=0.5,
                        device="cpu")
    with pytest.raises(ValueError, match="sampling settings"):
        ts.serve_greedy(tparams, tcfg, prompts, 2, n_slots=1, max_len=16,
                        server_fns=fns, device="cpu")
    out = ts.serve_sample(tparams, tcfg, prompts, 2, n_slots=1, max_len=16,
                          key=KEY, server_fns=fns, device="cpu", **SAMPLE)
    assert len(out[0]) == 6
    with pytest.raises(TypeError):
        ts.serve_sample(tparams, tcfg, prompts, 2, n_slots=1, max_len=16,
                        key=torch.Generator(), device="cpu")
