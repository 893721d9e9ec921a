"""The port's continuous-batching server with the MoE family
(``serve_greedy(family=moe_transformer)``) held against the JAX package's
server on tests/test_serving.py's MoE fixture (vocab 61, d 48, 4 heads, 2
layers, d_ff 96, 4 experts).

bf16 compute, the JAX tree cast to bf16 and crossed through
``moe_transformer.params_from_jax``; the same prompts (numpy seed). At the
default capacity factor (2.0: a decode step's 2 slots get capacity 2 at 4
experts, a prefill bucket's 8 rows capacity 5, pad rows included) the
router's groups are the same rows on both sides, so the tokens must be
equal, with bf16 and int8 KV, stepwise and in chunks of 4; and at 1.0,
where tokens drop. In f32 at the
drop-free capacity factor (4.0 = n_experts) the served tokens must equal
each request's solo ``generate``. Every prompt fits one prefill bucket (8
tokens), so each JAX serve compiles one prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import moe_transformer as jm
from mpi_acx_tpu.models import serving as js
from mpi_acx_torch.models import moe as tmoe
from mpi_acx_torch.models import moe_transformer as tm
from mpi_acx_torch.models import serving as ts

BASE = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
            max_seq=96, n_experts=4)
N_NEW = [9, 3, 6, 1, 7]


def _np_params(cfg, seed):
    """Seeded weights in the JAX layout (numpy; gains 1, biases 0)."""
    return jax.tree.map(lambda t: t.numpy(), tm.init_params(
        dataclasses.replace(cfg, dtype=torch.float32), seed=seed,
        device="cpu"))


@pytest.fixture(scope="module")
def models():
    jcfg = jm.tiny_moe_config(**BASE)
    tcfg = tm.tiny_moe_config(**BASE)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    assert jcfg.capacity_factor == tcfg.capacity_factor == 2.0
    jparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16),
                           _np_params(tcfg, 1))
    tparams = tm.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, n, lens, vocab=61):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_greedy_moe_matches_jax(models, chunk, kv_int8):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(1, 5, [5, 8, 3, 7])
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=2,
                           max_len=32, family=jm, chunk=chunk,
                           kv_int8=kv_int8)
    got = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                          max_len=32, family=tm, chunk=chunk,
                          kv_int8=kv_int8, device="cpu")
    assert len(got) == len(want) == 5
    for g, w, p, n in zip(got, want, prompts, N_NEW):
        assert len(g) == len(p) + n
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.prefills == want.metrics.prefills == 5
    assert got.metrics.steps == want.metrics.steps


def test_serve_greedy_moe_matches_jax_where_tokens_drop(models,
                                                        monkeypatch):
    """capacity_factor 1.0: capacity 3 in a prefill bucket of 8 rows and 1
    in a decode step of 2 slots, so tokens drop; the port must route the
    same rows (pad rows and idle slots included) in the same order."""
    dropped = []
    dispatch_tensors = tmoe._dispatch_tensors

    def counting(gates, capacity, k=1):
        d, c = dispatch_tensors(gates, capacity, k)
        dropped.append(gates.shape[0] * k - int(d.sum()))
        return d, c

    monkeypatch.setattr(tmoe, "_dispatch_tensors", counting)
    jcfg, jparams, tcfg, tparams = models
    jcfg = dataclasses.replace(jcfg, capacity_factor=1.0)
    tcfg = dataclasses.replace(tcfg, capacity_factor=1.0)
    prompts = _prompts(5, 5, [8, 2, 6, 7])
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=2,
                           max_len=32, family=jm, chunk=4)
    got = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=2,
                          max_len=32, family=tm, chunk=4, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert sum(dropped) > 0


def test_served_equals_solo_generate_when_drop_free():
    """f32 at capacity_factor = n_experts: no token is dropped, so each
    slot's math is its solo run's, whatever shares its decode steps."""
    cfg = dataclasses.replace(tm.tiny_moe_config(**BASE),
                              dtype=torch.float32, capacity_factor=4.0)
    params = tm.params_from_jax(_np_params(cfg, 3), device="cpu")
    prompts = _prompts(2, 4, [6, 2, 8])
    n_new = [5, 8, 2, 6]
    got = ts.serve_greedy(params, cfg, prompts, n_new, n_slots=3,
                          max_len=24, family=tm, chunk=2, device="cpu")
    for p, g, n in zip(prompts, got, n_new):
        solo = tm.generate(params, cfg, torch.from_numpy(p)[None], n,
                           max_len=24, device="cpu")
        np.testing.assert_array_equal(g, solo[0].numpy())


def test_paged_server_refuses_moe(models):
    """Paged serving is GPT-2's alone, in the port as in the JAX package
    (mpi_acx_tpu/models/kvpage.py refuses another family)."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(4, 1, [4])
    with pytest.raises(NotImplementedError, match="moe_transformer"):
        js.serve_paged_greedy(jparams, jcfg, prompts, 2, n_slots=1,
                              max_len=16, family=jm)
    with pytest.raises(NotImplementedError, match="moe_transformer"):
        ts.serve_paged_greedy(tparams, tcfg, prompts, 2, n_slots=1,
                              max_len=16, family=tm, device="cpu")
