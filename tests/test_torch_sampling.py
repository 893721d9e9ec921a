"""The port's sampling (``mpi_acx_torch/models/decoding.py``:
``filter_logits``, ``sample_logits``, ``sample_generate`` and each
family's ``generate_sample``) held against the JAX package's.

torch's and JAX's random streams differ, so the JAX function is held on
its deterministic part: for each of 64 keys, the port's
``argmax(filter_logits(logits) + g)`` with ``g = jax.random.gumbel(key,
...)`` (JAX's own draw) must be the token JAX's ``sample_logits(logits,
key)`` picks, at temperatures 0.5, 1 and 2, top_k None, 1 and 5, top_p
None, 0.0 and 0.9. The test logits are drawn (numpy seed 0) so that no
cumulative probability of the sorted, top-k-filtered distribution lies
within 1e-5 of top_p (asserted below): the two frameworks may sum the
cumulative masses in another order, and a mass within an ulp of top_p
could keep a token in one and drop it in the other. The port's draws are
then held as its own properties: temperature 0 and top_k = 1 are the
argmax, a sample follows the softmax, every sampled token lies in its
top-k set, one generator gives one sequence, and ``generate_sample`` at
temperature 0 is ``generate`` for all three families.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import decoding as jd
from mpi_acx_torch.models import decoding as td
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import moe_transformer as tm
from mpi_acx_torch.models import transformer as tt

B, V, N_KEYS = 4, 50, 64
TEMPS, TOP_KS, TOP_PS = (0.5, 1.0, 2.0), (None, 1, 5), (None, 0.0, 0.9)


def _logits():
    return (np.random.default_rng(0).standard_normal((B, V)) * 2.0).astype(
        np.float32)


def _exclusive_masses(logits, temperature, top_k):
    """Per row, the float64 mass before each sorted token of the
    distribution top-p sees (after top-k)."""
    srt = -np.sort(-logits.astype(np.float64) / temperature, axis=-1)
    if top_k is not None:
        srt = srt[:, :top_k]
    p = np.exp(srt - srt[:, :1])
    p /= p.sum(-1, keepdims=True)
    return np.cumsum(p, -1) - p


def test_test_logits_keep_clear_of_top_p():
    logits = _logits()
    for T in TEMPS:
        for k in TOP_KS:
            margin = np.abs(_exclusive_masses(logits, T, k) - 0.9).min()
            assert margin >= 1e-5, (T, k, margin)


@functools.lru_cache(maxsize=None)
def _jax_samples(T):
    """JAX's sample_logits tokens [keys, B] for every (top_k, top_p) at
    temperature T, and the Gumbel noise [keys, B, V] they draw: one
    compile per temperature."""
    combos = [(k, p) for k in TOP_KS for p in TOP_PS]

    def one(logits, key):
        return ([jd.sample_logits(logits, key, T, k, p) for k, p in combos],
                jax.random.gumbel(key, logits.shape, logits.dtype))

    keys = jax.random.split(jax.random.key(17), N_KEYS)
    toks, g = jax.jit(jax.vmap(one, in_axes=(None, 0)))(
        jnp.asarray(_logits()), keys)
    return dict(zip(combos, map(np.asarray, toks))), np.array(g)


@pytest.mark.parametrize("top_p", TOP_PS)
@pytest.mark.parametrize("top_k", TOP_KS)
@pytest.mark.parametrize("T", TEMPS)
def test_filter_plus_jax_gumbel_is_jax_sample(T, top_k, top_p):
    toks, g = _jax_samples(T)
    f = td.filter_logits(torch.from_numpy(_logits()), T, top_k, top_p)
    got = (f[None] + torch.from_numpy(g)).argmax(-1)
    np.testing.assert_array_equal(got.numpy(), toks[(top_k, top_p)])
    # The filter keeps at least the top-1 token and at most top_k.
    kept = (f > torch.finfo(torch.float32).min).sum(-1)
    assert kept.min() >= 1
    if top_k is not None:
        assert kept.max() <= top_k
    if top_p == 0.0 or top_k == 1:
        assert (kept == 1).all()


def test_temperature_zero_and_top_k_one_are_argmax():
    logits = torch.from_numpy(_logits())
    want = logits.argmax(-1)
    g = torch.Generator().manual_seed(0)
    assert torch.equal(td.sample_logits(logits, g, 0.0), want)
    state = g.get_state()
    td.sample_logits(logits, g, 0.0)
    assert torch.equal(g.get_state(), state)       # nothing drawn
    for T in TEMPS:
        assert torch.equal(td.sample_logits(logits, g, T, top_k=1), want)
    assert np.array_equal(np.asarray(jd.sample_logits(
        jnp.asarray(logits.numpy()), jax.random.key(0), 0.0)), want.numpy())


def test_gumbel_draw_follows_the_softmax():
    """20000 draws over 8 tokens: the empirical distribution lies within
    0.02 (total variation) of softmax(logits / T); the noise is finite."""
    logits = torch.tensor([[1.0, 0.5, -0.3, 2.0, 0.0, -1.0, 1.5, 0.2]])
    T, n = 0.7, 20000
    g = torch.Generator().manual_seed(1)
    toks = td.sample_logits(logits.expand(n, 8).contiguous(), g, T)
    emp = torch.bincount(toks, minlength=8).double() / n
    tv = 0.5 * (emp - torch.softmax(logits[0].double() / T, -1)).abs().sum()
    assert tv.item() < 0.02, tv
    assert torch.isfinite(td.gumbel((4096,), g)).all()


def test_samples_lie_in_the_top_k_set():
    logits = torch.from_numpy(_logits())
    g = torch.Generator().manual_seed(2)
    top5 = logits.topk(5, dim=-1).indices
    for _ in range(50):
        tok = td.sample_logits(logits, g, 1.5, top_k=5, top_p=0.95)
        assert (top5 == tok[:, None]).any(-1).all()


def test_fold_in_and_split_are_reproducible():
    assert td.fold_in(7, 3) == td.fold_in(7, 3)
    assert len({td.fold_in(7, r) for r in range(100)}) == 100
    assert td.fold_in(7, 3) != td.fold_in(8, 3)
    assert 0 <= td.fold_in(2 ** 70, 1) < 2 ** 63
    a = [x.initial_seed() for x in td.split_generator(
        torch.Generator().manual_seed(5), 4)]
    b = [x.initial_seed() for x in td.split_generator(
        torch.Generator().manual_seed(5), 4)]
    assert a == b and len(set(a)) == 4


def _families():
    gpt2 = dataclasses.replace(
        tt.tiny_config(vocab=61, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                       max_seq=32), dtype=torch.float32)
    llama = dataclasses.replace(
        tl.tiny_llama(vocab=61, d_model=32, n_heads=4, n_kv_heads=2,
                      n_layers=2, d_ff=64, max_seq=32), dtype=torch.float32)
    moe = dataclasses.replace(
        tm.tiny_moe_config(vocab=61, d_model=32, n_heads=2, n_layers=2,
                           d_ff=32, n_experts=4, capacity_factor=4.0,
                           max_seq=32), dtype=torch.float32)
    return {"gpt2": (tt, gpt2), "llama": (tl, llama), "moe": (tm, moe)}


@pytest.mark.parametrize("kv_int8", [False, True], ids=["f32kv", "int8kv"])
@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_generate_sample_at_temperature_zero_is_generate(family, kv_int8):
    mod, cfg = _families()[family]
    params = mod.init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, (2, 7)).astype(np.int32))
    want = mod.generate(params, cfg, prompt, 9, kv_int8=kv_int8,
                        device="cpu")
    got = mod.generate_sample(params, cfg, prompt, 9, torch.Generator(),
                              temperature=0.0, kv_int8=kv_int8,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_generate_sample_draws_from_its_generator(family):
    """One seed, one sequence; another seed, another; the draws in order
    are sample_logits over the model's own steps."""
    mod, cfg = _families()[family]
    params = mod.init_params(cfg, seed=0, device="cpu")
    prompt = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (2, 5)).astype(np.int32))

    def run(seed):
        return mod.generate_sample(
            params, cfg, prompt, 10, torch.Generator().manual_seed(seed),
            temperature=1.5, top_k=20, top_p=0.95, device="cpu")

    a, b, c = run(1), run(1), run(2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(a[:, :5], prompt)
    # The same draws by hand: the prefill's last logits, then each step.
    g = torch.Generator().manual_seed(1)
    logits, cache = mod.prefill(params, cfg, prompt, 15, last_only=True)
    tok = td.sample_logits(logits[:, -1], g, 1.5, 20, 0.95).to(torch.int32)
    toks = [tok]
    for _ in range(9):
        logits, cache = mod.decode_step(params, cfg, cache, tok)
        tok = td.sample_logits(logits, g, 1.5, 20, 0.95).to(torch.int32)
        toks.append(tok)
    assert torch.equal(a[:, 5:], torch.stack(toks, 1))


def test_a_generator_on_another_device_is_refused():
    mod, cfg = _families()["gpt2"]
    params = mod.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(TypeError, match="torch.Generator"):
        mod.generate_sample(params, cfg, np.zeros((1, 3), np.int32), 2, 7,
                            device="cpu")
    with pytest.raises(ValueError, match="generator on cpu"):
        td.check_key(torch.Generator(), "cuda")
