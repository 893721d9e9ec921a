"""The port's speculative decoding (``mpi_acx_torch/models/speculative.py``)
held against the JAX package's (``mpi_acx_tpu/models/speculative.py``).

Weights are drawn by the port on the CPU (seeded, f32) and handed to JAX
as numpy arrays (JAX's eager ``init_params`` takes seconds). Greedy: the
port's tokens, rounds and accepted counts equal JAX's compiled loop for a
random and a perfect draft, for GPT-2, Llama (GQA) and an MoE target (a
GPT-2 draft, drop-free capacity), and the tokens equal the target's own
``generate``. The window pass equals JAX's (logits within 1e-5, caches).
Batched rows equal their B = 1 runs, greedy and sampled; a perfect draft
accepts every proposal. The hooks under JAX's own draws (``jax.random``
uniforms and Gumbel noise from the keys JAX's ``decide`` splits) give
JAX's decisions. ``speculative_sample``'s two-token joint distribution
matches the target's teacher-forced one (6000 rows in one batched call,
vocab 8). Int8 weights on both models emit the int8 target's greedy
tokens. The JAX loops compile once per configuration (the JAX package
caches them).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import llama as jl
from mpi_acx_tpu.models import moe_transformer as jm
from mpi_acx_tpu.models import speculative as jsp
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import decoding as td
from mpi_acx_torch.models import llama as tl
from mpi_acx_torch.models import moe_transformer as tm
from mpi_acx_torch.models import speculative as tsp
from mpi_acx_torch.models import transformer as tt
from mpi_acx_torch.ops import wquant as tw


def _gpt2(n_layers, max_seq=128, vocab=64):
    kw = dict(vocab=vocab, d_model=32, n_heads=2, n_layers=n_layers,
              d_ff=64, max_seq=max_seq)
    return (tt, dataclasses.replace(tt.tiny_config(**kw), dtype=torch.float32),
            jt, dataclasses.replace(jt.tiny_config(**kw), dtype=jnp.float32))


def _llama(n_layers, max_seq=128, vocab=64):
    kw = dict(vocab=vocab, d_model=32, n_heads=4, n_kv_heads=2,
              n_layers=n_layers, d_ff=64, max_seq=max_seq)
    return (tl, dataclasses.replace(tl.tiny_llama(**kw), dtype=torch.float32),
            jl, dataclasses.replace(jl.tiny_llama(**kw), dtype=jnp.float32))


def _moe(n_layers, max_seq=128, vocab=64, capacity_factor=4.0):
    kw = dict(vocab=vocab, d_model=32, n_heads=2, n_layers=n_layers,
              d_ff=64, n_experts=4, top_k=2, capacity_factor=capacity_factor,
              max_seq=max_seq)
    return (tm, dataclasses.replace(tm.tiny_moe_config(**kw),
                                    dtype=torch.float32),
            jm, dataclasses.replace(jm.tiny_moe_config(**kw),
                                    dtype=jnp.float32))


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    return jnp.asarray(tree.numpy())


def _models(target, draft, seed=0, draft_seed=7):
    """(port target params, cfg, JAX params, cfg) and the same for the
    draft (``draft=None``: the target itself)."""
    tmod, tcfg, _, jcfg = target
    tp = tmod.init_params(tcfg, seed=seed, device="cpu")
    if draft is None:
        return (tp, tcfg, _to_jax(tp), jcfg), (tp, tcfg, _to_jax(tp), jcfg)
    dmod, dcfg, _, jdcfg = draft
    dp = dmod.init_params(dcfg, seed=draft_seed, device="cpu")
    return (tp, tcfg, _to_jax(tp), jcfg), (dp, dcfg, _to_jax(dp), jdcfg)


def _prompt(B, S=8, vocab=64, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


FAMILIES = {"gpt2": (lambda: _gpt2(2), lambda: _gpt2(1)),
            "llama": (lambda: _llama(2), lambda: _llama(1)),
            "moe": (lambda: _moe(2), lambda: _gpt2(1))}


@pytest.mark.parametrize("draft", ["random", "perfect"])
@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_greedy_matches_jax_and_generate(family, draft):
    target, dr = FAMILIES[family]
    (tp, tcfg, jp, jcfg), (dp, dcfg, jdp, jdcfg) = _models(
        target(), None if draft == "perfect" else dr())
    prompt = _prompt(1)
    n_new, k = 20, 4
    got, st = tsp.speculative_generate(dp, dcfg, tp, tcfg,
                                       torch.from_numpy(prompt), n_new, k=k,
                                       device="cpu")
    want, wst = jsp.speculative_generate(jdp, jdcfg, jp, jcfg,
                                         jnp.asarray(prompt), n_new, k=k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(st["rounds"]) == int(wst["rounds"])
    assert int(st["drafted_accepted"]) == int(wst["drafted_accepted"])
    mod = target()[0]
    solo = mod.generate(tp, tcfg, torch.from_numpy(prompt), n_new,
                        max_len=8 + n_new + k, device="cpu")
    np.testing.assert_array_equal(got.numpy(), solo.numpy())
    if draft == "perfect":
        assert int(st["drafted_accepted"]) == int(st["rounds"]) * (k - 1)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_window_pass_matches_jax(family):
    tmod, tcfg, jmod, jcfg = FAMILIES[family][0]()
    tp = tmod.init_params(tcfg, seed=2, device="cpu")
    jp = _to_jax(tp)
    prompt = _prompt(2, S=6, seed=3)
    window = _prompt(2, S=4, seed=4)
    _, tcache = tmod.prefill(tp, tcfg, torch.from_numpy(prompt), 16)
    _, jcache = jax.jit(jmod.prefill, static_argnums=(1, 3))(
        jp, jcfg, jnp.asarray(prompt), 16)
    wp = (tsp._window_pass_llama if family == "llama" else tsp._window_pass)
    jwp = (jsp._window_pass_llama if family == "llama" else jsp._window_pass)
    got, gc = wp(tp, tcfg, tcache, torch.from_numpy(window))
    want, wc = jax.jit(jwp, static_argnums=1)(jp, jcfg, jcache,
                                              jnp.asarray(window))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for key in ("k", "v"):
        np.testing.assert_allclose(gc[key].numpy(), np.asarray(wc[key]),
                                   rtol=1e-5, atol=1e-5)
    assert int(gc["pos"]) == int(wc["pos"]) == 10


def test_batched_rows_match_single_row_runs():
    """B = 8 greedy: each row equals its target generate and its own B = 1
    speculative run, rounds and accepted included; the rows really advance
    at different paces."""
    (tp, tcfg, _, _), (dp, dcfg, _, _) = _models(_gpt2(2), _gpt2(1))
    B, n_new, k = 8, 16, 4
    prompts = torch.from_numpy(_prompt(B))
    got, st = tsp.speculative_generate(dp, dcfg, tp, tcfg, prompts, n_new,
                                       k=k, device="cpu")
    assert got.shape == (B, 8 + n_new) and st["rounds"].shape == (B,)
    assert len(set(st["rounds"].tolist())) > 1, st
    want = tt.generate(tp, tcfg, prompts, n_new, max_len=8 + n_new + k,
                       device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for b in range(B):
        solo, sst = tsp.speculative_generate(dp, dcfg, tp, tcfg,
                                             prompts[b:b + 1], n_new, k=k,
                                             device="cpu")
        assert torch.equal(got[b:b + 1], solo)
        assert int(st["rounds"][b]) == int(sst["rounds"])
        assert int(st["drafted_accepted"][b]) == int(
            sst["drafted_accepted"])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_batched_sample_rows_match_single_row_runs(family):
    """Batched sampling: row b equals the B = 1 run with
    ``split_generator(key, B)[b]``."""
    target, dr = FAMILIES[family]
    (tp, tcfg, _, _), (dp, dcfg, _, _) = _models(target(), dr())
    B, n_new, k = 4, 12, 4
    prompts = torch.from_numpy(_prompt(B, seed=2))
    got, st = tsp.speculative_sample(dp, dcfg, tp, tcfg, prompts, n_new,
                                     torch.Generator().manual_seed(11), k=k,
                                     temperature=0.9, device="cpu")
    gens = td.split_generator(torch.Generator().manual_seed(11), B)
    for b in range(B):
        solo, sst = tsp.speculative_sample(dp, dcfg, tp, tcfg,
                                           prompts[b:b + 1], n_new, gens[b],
                                           k=k, temperature=0.9,
                                           device="cpu")
        assert torch.equal(got[b:b + 1], solo)
        assert int(st["rounds"][b]) == int(sst["rounds"])


@pytest.mark.parametrize("family", ["gpt2", "llama", "moe"])
def test_perfect_draft_accepts_everything(family):
    """Draft == target over many rounds: every proposal accepted (a cache
    row the draft left unwritten would show as a rejection), rounds within
    ceil(n_new / k) + 1."""
    (tp, tcfg, _, _), _ = _models(FAMILIES[family][0](), None)
    n_new, k = 41, 4
    prompts = torch.from_numpy(_prompt(2))
    got, st = tsp.speculative_generate(tp, tcfg, tp, tcfg, prompts, n_new,
                                       k=k, device="cpu")
    mod = FAMILIES[family][0]()[0]
    want = mod.generate(tp, tcfg, prompts, n_new, max_len=8 + n_new + k,
                        device="cpu")
    assert torch.equal(got, want)
    for r, a in zip(st["rounds"].tolist(), st["drafted_accepted"].tolist()):
        assert a == r * (k - 1)
        assert r <= -(-n_new // k) + 1


def test_moe_target_tight_capacity_is_refused():
    tmod, tcfg, _, _ = _moe(2, capacity_factor=2.0)
    tp = tmod.init_params(tcfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="drop-free"):
        tsp.speculative_generate(tp, tcfg, tp, tcfg,
                                 torch.zeros((1, 4), dtype=torch.int32), 4,
                                 device="cpu")
    tsp._check_moe_target(dataclasses.replace(tcfg, capacity_factor=4.0))
    with pytest.raises(ValueError, match="vocabularies differ"):
        _, gcfg, _, _ = _gpt2(1, vocab=32)
        tsp.speculative_generate(tt.init_params(gcfg, 0, device="cpu"), gcfg,
                                 tp, dataclasses.replace(tcfg,
                                                         capacity_factor=4.0),
                                 torch.zeros((1, 4), dtype=torch.int32), 4,
                                 device="cpu")


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_hooks_under_jax_draws_match_jax(temperature):
    """The sampled hooks fed JAX's own draws decide as JAX's hooks do: for
    each key, ``decide``'s ``ka, kr = split(key)`` gives ``u =
    uniform(ka, (k-1,))`` and the residual draw's ``gumbel(kr, (V,))``;
    ``categorical(key, l / T)`` is ``argmax(l / T + gumbel(key, l.shape))``.
    Proposals are the draft's own argmax half of the time, so both the
    accept and the reject branches run. The greedy hooks likewise."""
    k, V, n = 4, 12, 32
    rng = np.random.default_rng(5)
    q_logits = (rng.standard_normal((n, k - 1, V)) * 2).astype(np.float32)
    t_logits = (rng.standard_normal((n, k, V)) * 2).astype(np.float32)
    noise = rng.standard_normal((n // 2, k - 1, V)).astype(np.float32)
    t_logits[:n // 2, :k - 1] = q_logits[:n // 2] + 0.3 * noise
    props = np.where(rng.random((n, k - 1)) < 0.5, q_logits.argmax(-1),
                     rng.integers(0, V, (n, k - 1))).astype(np.int32)
    keys = jax.random.split(jax.random.key(9), n)
    jpick0, _, jdecide = jsp._sample_hooks(k, temperature)

    @jax.jit
    def jax_side(props, q_logits, t_logits, lg, keys):
        def one(pr, ql, tlg, l0, key):
            ka, kr = jax.random.split(key)
            return (jdecide(pr, ql, tlg, key),
                    jax.random.uniform(ka, (k - 1,)),
                    jax.random.gumbel(kr, (V,)),
                    jpick0(l0[None], key)[0],
                    jax.random.gumbel(key, (1, V))[0])
        return jax.vmap(one)(props, q_logits, t_logits, lg, keys)

    lg = t_logits[:, 0]
    (we_all, wm_all, wy_all), u, g, wp, gp = jax.tree.map(
        np.array, jax_side(props, q_logits, t_logits, lg, keys))
    want = list(zip(we_all, wm_all, wy_all))
    tpick0, tdraft, tdecide = tsp._sample_hooks(k, temperature)
    emit, m, y = tdecide(torch.from_numpy(props), torch.from_numpy(q_logits),
                         torch.from_numpy(t_logits), torch.from_numpy(u),
                         torch.from_numpy(g))
    for i, (we, wm, wy) in enumerate(want):
        assert int(m[i]) == int(wm), i
        assert int(y[i]) == int(wy[0]), i
        np.testing.assert_array_equal(emit[i, :int(m[i]) + 1].numpy(),
                                      np.asarray(we)[:int(wm) + 1])
    assert 0 < int((m < k - 1).sum()) < n          # both branches ran
    for hook in (tpick0, tdraft):
        assert hook(torch.from_numpy(lg),
                    torch.from_numpy(gp)).tolist() == wp.tolist()
    _, _, jgd = jsp._greedy_hooks(k)
    _, _, tgd = tsp._greedy_hooks(k)
    emit, m, y = tgd(torch.from_numpy(props), None,
                     torch.from_numpy(t_logits), None, None)
    we, wm, wy = jax.vmap(lambda pr, tlg: jgd(pr, None, tlg, None))(
        jnp.asarray(props), jnp.asarray(t_logits))
    np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(y.numpy(), np.asarray(wy)[:, 0])
    np.testing.assert_array_equal(emit.numpy(), np.asarray(we))


def test_speculative_sample_distribution_matches_target():
    """Emitted tokens follow the target's distribution whatever the draft:
    the joint of the first two generated tokens (the second through the
    accept/resample round) over 6000 rows, against the target's exact
    teacher-forced joint and, as a negative control, the draft's."""
    V = 8
    _, cfg, _, _ = _gpt2(1, vocab=V, max_seq=32)

    def sharpened(seed):
        p = tt.init_params(cfg, seed=seed, device="cpu")
        return tt._tree_map(lambda a: a * 8.0, p)

    params, dparams = sharpened(0), sharpened(9)
    prompt = torch.tensor([[3, 1, 4]], dtype=torch.int32)
    S, k, N = 3, 3, 6000

    def joint(p):
        p1 = torch.softmax(tt.forward(p, cfg, prompt)[0, -1].double(), -1)
        exts = torch.cat([prompt.expand(V, S),
                          torch.arange(V, dtype=torch.int32)[:, None]], 1)
        p2 = torch.softmax(tt.forward(p, cfg, exts)[:, -1].double(), -1)
        return (p1[:, None] * p2).numpy()

    joint_t, joint_d = joint(params), joint(dparams)
    power = 0.5 * np.abs(joint_t - joint_d).sum()
    assert power > 0.2, power
    toks, _ = tsp.speculative_sample(dparams, cfg, params, cfg,
                                     prompt.expand(N, S), 2,
                                     torch.Generator().manual_seed(123),
                                     k=k, temperature=1.0, device="cpu")
    emp = np.zeros((V, V))
    np.add.at(emp, (toks[:, S].numpy(), toks[:, S + 1].numpy()), 1.0 / N)
    tv_target = 0.5 * np.abs(emp - joint_t).sum()
    tv_draft = 0.5 * np.abs(emp - joint_d).sum()
    # Sampling noise at N = 6000 over 64 cells is about 0.05-0.08.
    assert tv_target < 0.12, (tv_target, tv_draft)
    assert tv_draft > tv_target + 0.05, (tv_target, tv_draft)


def test_speculative_sample_reproducible_and_valid():
    (tp, tcfg, _, _), (dp, dcfg, _, _) = _models(_gpt2(2), _gpt2(1))
    prompt = torch.from_numpy(_prompt(1))

    def run(seed):
        return tsp.speculative_sample(dp, dcfg, tp, tcfg, prompt, 20,
                                      torch.Generator().manual_seed(seed),
                                      k=4, temperature=0.8, device="cpu")

    (a, sa), (b, _), (c, _) = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ((0 <= a) & (a < tcfg.vocab)).all()
    assert int(sa["rounds"]) <= 20
    with pytest.raises(ValueError, match="temperature"):
        tsp.speculative_sample(dp, dcfg, tp, tcfg, prompt, 4,
                               torch.Generator(), temperature=0.0,
                               device="cpu")


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_int8_weights_speculative_matches(family):
    """Quantized draft and target (every weight read through wread, the
    k-wide window's included) emit the quantized target's greedy tokens
    (tests/test_torch_wquant.py holds those to the JAX package's)."""
    tmod, tcfg, _, _ = FAMILIES[family][0]()
    names = tw.GPT2_WEIGHTS if family == "gpt2" else tw.LLAMA_WEIGHTS
    dcfg = dataclasses.replace(tcfg, n_layers=1)
    tp = tmod.init_params(tcfg, seed=0, device="cpu")
    qp = tw.quantize_weights_int8(tp, names)
    qd = tw.quantize_weights_int8(tmod.init_params(dcfg, seed=9,
                                                   device="cpu"), names)
    prompt = _prompt(2, seed=6)
    want = tmod.generate(qp, tcfg, torch.from_numpy(prompt), 8, max_len=24,
                         device="cpu")
    got, _ = tsp.speculative_generate(qd, dcfg, qp, tcfg,
                                      torch.from_numpy(prompt), 8, k=3,
                                      device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())
