"""The port's paged server (mpi_acx_torch/models/serving.py:
serve_paged_greedy) held against the JAX package's, and against the port's
own fixed-slot server.

Both servers get the same prompts (numpy seed) and the same weights (the
JAX tree through ``params_from_jax``) on a tiny bf16 config; tokens must be
equal, and so must the paged counters (preemptions, prefix hits, pages
reused, the pages' high-water mark), which depend only on the schedule.
With the port's capture cap (``decoding.PREFILL_CAPTURE_MAX``) lowered to
4, cold prompts and prefix-hit suffixes above it are prefilled at their
own length, and must still give the JAX server's tokens and counters.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu.models import serving as js
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch.models import decoding
from mpi_acx_torch.models import kvpage as tkp
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt

PAGED_COUNTERS = ("preemptions", "prefix_hits", "prefix_pages_reused",
                  "pages_hwm", "prefix_evictions", "requeues", "steps",
                  "prefills", "rejections")


@pytest.fixture(scope="module")
def models():
    base = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                max_seq=96)
    jcfg = jt.tiny_config(**base)
    tcfg = tt.tiny_config(**base)
    assert jcfg.dtype == jnp.bfloat16 and tcfg.dtype == torch.bfloat16
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed=1, lens=(5, 8, 3, 7, 6, 4, 8), vocab=61):
    """Prompts of one prefill bucket (8), so that each JAX server
    compiles one prefill."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def _same(got, want, counters=PAGED_COUNTERS):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, js.RequestRejected):
            assert isinstance(g, ts.RequestRejected)
            assert (g.reason, g.detail) == (w.reason, w.detail)
        else:
            np.testing.assert_array_equal(g, np.asarray(w),
                                          err_msg=f"request {i}")
    for name in counters:
        assert getattr(got.metrics, name) == getattr(want.metrics, name), \
            name


@pytest.mark.parametrize("chunk", [1, 3])
@pytest.mark.parametrize("kv_int8", [False, True], ids=["bf16", "int8"])
def test_serve_paged_matches_jax_and_fixed(models, kv_int8, chunk):
    """7 staggered requests through 3 slots and 8-token pages: the tokens
    and paged counters of JAX's paged server, and the port's own
    fixed-slot tokens (the paged path changes where rows live, not what
    is computed)."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts()
    kw = dict(n_slots=3, max_len=32, chunk=chunk, kv_int8=kv_int8)
    want = js.serve_paged_greedy(jparams, jcfg, prompts, 6, page_tokens=8,
                                 **kw)
    got = ts.serve_paged_greedy(tparams, tcfg, prompts, 6, page_tokens=8,
                                device="cpu", **kw)
    _same(got, want)
    fixed = ts.serve_greedy(tparams, tcfg, prompts, 6, device="cpu", **kw)
    for g, f in zip(got, fixed):
        np.testing.assert_array_equal(g, f)
    assert got.metrics.preemptions == 0 and 0 < got.metrics.pages_hwm < 12


def test_preemption_replay_matches_jax(models):
    """A 4-page pool cannot hold three live requests: the latest arrival
    is preempted, requeued uncharged, and replays the same tokens; the
    schedule's counters equal JAX's."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts()
    kw = dict(n_slots=3, max_len=32, page_tokens=8, n_pages=4)
    want = js.serve_paged_greedy(jparams, jcfg, prompts, 6, **kw)
    got = ts.serve_paged_greedy(tparams, tcfg, prompts, 6, device="cpu",
                                **kw)
    _same(got, want)
    assert got.metrics.preemptions >= 1 and got.metrics.requeues == 0
    fixed = ts.serve_greedy(tparams, tcfg, prompts, 6, n_slots=3,
                            max_len=32, device="cpu")
    for g, f in zip(got, fixed):
        np.testing.assert_array_equal(g, f)


def test_prefix_hits_match_jax(models):
    """Requests sharing a 20-token system prompt (two full 8-token pages)
    with the prefix cache on, int8 pages (so the hits' history is
    dequantized): JAX's tokens, hits, reused pages and high-water mark;
    two runs agree (a hit's path is deterministic)."""
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(11)
    system = rng.integers(0, 61, 20).astype(np.int32)
    prompts = [np.concatenate([system, rng.integers(0, 61, 4 + i).astype(
        np.int32)]) for i in range(4)]
    kw = dict(n_slots=2, max_len=40, page_tokens=8, kv_int8=True)
    want = js.serve_paged_greedy(jparams, jcfg, prompts, 4,
                                 prefix_cache=True, **kw)
    got = ts.serve_paged_greedy(tparams, tcfg, prompts, 4, prefix_cache=True,
                                device="cpu", **kw)
    _same(got, want)
    assert got.metrics.prefix_hits == 3
    assert got.metrics.prefix_pages_reused == 6
    again = ts.serve_paged_greedy(tparams, tcfg, prompts, 4,
                                  prefix_cache=True, device="cpu", **kw)
    _same(again, got)


def _shared_system(seed=11, vocab=61):
    """Four prompts sharing a 20-token system prompt (two full 8-token
    pages), with suffixes of 4 to 7 tokens."""
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 20).astype(np.int32)
    return [np.concatenate([system, rng.integers(0, vocab, 4 + i).astype(
        np.int32)]) for i in range(4)]


@pytest.mark.parametrize("case", ["cold-bf16", "cold-int8", "prefix-int8"])
def test_unpadded_prefill_matches_jax(models, monkeypatch, case):
    """The cap at 4 tokens: the cold prompts of 5 to 8 tokens (those of 3
    and 4 still padded to 8), and with the prefix cache on (int8 pages)
    the first 24-token prompt and, on the three hits, the suffixes of 9
    to 11 tokens past the two cached pages, are prefilled at their own
    length; the tokens and paged counters equal the JAX server's, whose
    every prefill is padded to its bucket."""
    jcfg, jparams, tcfg, tparams = models
    monkeypatch.setattr(decoding, "PREFILL_CAPTURE_MAX", 4)
    widths = []
    padded = ts._padded

    def spy(prompt, *a):
        out = padded(prompt, *a)
        widths.append(out.shape[1])
        return out

    monkeypatch.setattr(ts, "_padded", spy)
    kv_int8 = case.endswith("int8")
    if case.startswith("cold"):
        prompts, n_new, widths_want = _prompts(), 6, [5, 8, 8, 7, 6, 8, 8]
        kw = dict(n_slots=3, max_len=32, chunk=3, page_tokens=8,
                  kv_int8=kv_int8)
    else:
        prompts, n_new, widths_want = _shared_system(), 4, [24, 9, 10, 11]
        kw = dict(n_slots=2, max_len=40, page_tokens=8, kv_int8=kv_int8,
                  prefix_cache=True)
    want = js.serve_paged_greedy(jparams, jcfg, prompts, n_new, **kw)
    got = ts.serve_paged_greedy(tparams, tcfg, prompts, n_new,
                                device="cpu", **kw)
    _same(got, want)
    assert widths == widths_want
    assert got.metrics.prefix_hits == (0 if case.startswith("cold") else 3)


def test_page_budget_rejection_matches_jax(models):
    """A request whose pages exceed the whole pool is rejected up front
    (reason and arithmetic as JAX's admission rule), the rest served."""
    _, _, tcfg, tparams = models
    prompts = _prompts(lens=(12, 5))
    for args in ((0, prompts[0], 6, 1, 32, 96, 2, 8),
                 (1, prompts[1], 6, 1, 32, 96, 2, 8),
                 (1, prompts[1], 30, 1, 32, 96, None, None)):
        want = js._admission_check(*args)
        got = ts._admission_check(*args)
        assert (got is None) == (want is None)
        if want is not None:
            assert (got.rid, got.reason, got.detail) == (
                want.rid, want.reason, want.detail)
    out = ts.serve_paged_greedy(tparams, tcfg, prompts, 6, n_slots=1,
                                max_len=32, page_tokens=8, n_pages=2,
                                device="cpu")
    assert isinstance(out[0], ts.RequestRejected)
    assert out[0].reason == "exceeds_page_budget"
    assert out.metrics.rejection_reasons == {"exceeds_page_budget": 1}
    assert len(out[1]) == len(prompts[1]) + 6


def test_streaming_drain_and_slo_gate(models, monkeypatch):
    """on_token streams every consumed token (the prefill's first
    included) and the stream equals the outputs; the pool drains to zero;
    an impossible TTFT target defers refills but never starves an empty
    server, and the tokens stay those of the ungated run."""
    _, _, tcfg, tparams = models
    prompts = _prompts()[:4]
    streams = {}
    out = ts.serve_paged_greedy(
        tparams, tcfg, prompts, 5, n_slots=2, max_len=32, page_tokens=8,
        return_paged_state=True, device="cpu",
        on_token=lambda rid, tok: streams.setdefault(rid, []).append(tok))
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(np.asarray(streams[rid], np.int32),
                                      out[rid][len(p):])
    assert out.paged_state.alloc.used_count == 0
    assert out.metrics.slo_deferrals == 0
    assert ts._slo_admit_targets(None) == (None, None)
    monkeypatch.setenv("ACX_SERVE_ADMIT_TTFT_MS", "0.000001")
    assert ts._slo_admit_targets(None) == (pytest.approx(1e-9), None)
    gated = ts.serve_paged_greedy(tparams, tcfg, prompts, 5, n_slots=2,
                                  max_len=32, page_tokens=8, device="cpu")
    assert gated.metrics.slo_deferrals >= 1
    for g, o in zip(gated, out):
        np.testing.assert_array_equal(g, o)


def test_failed_step_requeues_and_resets_pool(models, monkeypatch):
    """A step that raises once: every active request requeues (charged),
    the pool starts over from zeros, and the replays give the tokens of
    an undisturbed run; past the retry budget the error propagates."""
    _, _, tcfg, tparams = models
    prompts = _prompts()[:3]
    want = ts.serve_paged_greedy(tparams, tcfg, prompts, 4, n_slots=2,
                                 max_len=32, page_tokens=8, device="cpu")
    real = tkp.make_paged_step_fn
    fails = {"left": 1}

    def flaky(*args, **kwargs):
        step = real(*args, **kwargs)

        def wrapped(state, tok):
            if fails["left"]:
                fails["left"] -= 1
                raise RuntimeError("device fault")
            return step(state, tok)
        return wrapped
    monkeypatch.setattr(tkp, "make_paged_step_fn", flaky)
    got = ts.serve_paged_greedy(tparams, tcfg, prompts, 4, n_slots=2,
                                max_len=32, page_tokens=8, device="cpu")
    assert got.metrics.requeues == 2
    assert [r.retries for r in got.metrics.per_request] == [1, 1, 0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    fails["left"] = 10
    with pytest.raises(RuntimeError, match="request 0 failed 3 time"):
        ts.serve_paged_greedy(tparams, tcfg, prompts, 4, n_slots=2,
                              max_len=32, page_tokens=8, device="cpu")


def test_other_families_and_bad_pages_raise(models):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="page_tokens"):
        ts.serve_paged_greedy(tparams, tcfg, _prompts()[:1], 2, n_slots=1,
                              max_len=32, page_tokens=7, device="cpu")
    fake = type(tt)("llama")
    fake.check_device = tt.check_device
    with pytest.raises(NotImplementedError, match="llama"):
        ts.serve_paged_greedy(tparams, dataclasses.replace(tcfg),
                              _prompts()[:1], 2, n_slots=1, max_len=32,
                              family=fake, device="cpu")
