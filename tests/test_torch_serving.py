"""The port's continuous-batching server (mpi_acx_torch/models/serving.py)
held against the JAX package's ``serve_greedy`` on a tiny float32 config.

Both servers get the same prompts (numpy seed) and the same weights (the
JAX tree through ``params_from_jax``); outputs must be equal token for
token, and equal to the port's own solo ``generate`` runs. The request
journey log is the JAX package's format, readable by tools/acx_request.py.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_acx_tpu import reqlog as jreqlog
from mpi_acx_tpu.models import serving as js
from mpi_acx_tpu.models import transformer as jt
from mpi_acx_torch import reqlog as treqlog
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import acx_request  # noqa: E402


@pytest.fixture(scope="module")
def models():
    base = dict(vocab=61, d_model=48, n_heads=4, n_layers=2, d_ff=96,
                max_seq=96)
    jcfg = dataclasses.replace(jt.tiny_config(**base), dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.tiny_config(**base), dtype=torch.float32)
    jparams = jt.init_params(jax.random.key(0), jcfg)
    tparams = tt.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, tcfg, tparams


def _prompts(seed, n, lens, vocab=61):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, lens[i % len(lens)]).astype(np.int32)
            for i in range(n)]


N_NEW = [6, 3, 8, 1, 5, 7, 2]


@pytest.mark.parametrize("chunk", [1, 4])
def test_serve_greedy_matches_jax(models, chunk):
    """7 requests, mixed n_new (one single-token request), 3 slots:
    refills mid-stream, chunked steps with mid-chunk finishes."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(1, 7, [5, 9, 3, 12, 7])
    want = js.serve_greedy(jparams, jcfg, prompts, N_NEW, n_slots=3,
                           max_len=32, chunk=chunk)
    got = ts.serve_greedy(tparams, tcfg, prompts, N_NEW, n_slots=3,
                          max_len=32, chunk=chunk, device="cpu")
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got.metrics.prefills == want.metrics.prefills == 7
    assert got.metrics.new_tokens == want.metrics.new_tokens == sum(N_NEW)
    assert got.metrics.steps == want.metrics.steps


def test_serve_eos_matches_jax(models):
    """An eos hit retires the request at the eos token and refills."""
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(2, 6, [5, 8, 11])
    solo = [tt.generate(tparams, tcfg, torch.from_numpy(p)[None], 8,
                        max_len=32, device="cpu")[0, len(p):].tolist()
            for p in prompts]
    eos = solo[1][0]              # request 1 stops at its first token
    want = js.serve_greedy(jparams, jcfg, prompts, 8, n_slots=2, max_len=32,
                           eos=eos)
    got = ts.serve_greedy(tparams, tcfg, prompts, 8, n_slots=2, max_len=32,
                          eos=eos, device="cpu")
    assert len(got[1]) == len(prompts[1]) + 1
    assert any(len(g) == len(p) + 8 for g, p in zip(got, prompts))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("n_slots", [1, 3])
def test_batched_equals_solo_generate(models, n_slots):
    """Per-slot positions make each slot's math its solo run's."""
    _, _, tcfg, tparams = models
    prompts = _prompts(3, 5, [4, 10, 6])
    got = ts.serve_greedy(tparams, tcfg, prompts, [5, 2, 7, 3, 4],
                          n_slots=n_slots, max_len=24, chunk=2,
                          device="cpu")
    for p, g, n in zip(prompts, got, [5, 2, 7, 3, 4]):
        solo = tt.generate(tparams, tcfg, torch.from_numpy(p)[None], n,
                           max_len=24, device="cpu")
        np.testing.assert_array_equal(g, solo[0].numpy())


def test_admission_rejects_like_jax(models):
    jcfg, jparams, tcfg, tparams = models
    prompts = _prompts(4, 3, [5, 30, 6])
    want = js.serve_greedy(jparams, jcfg, prompts, 4, n_slots=2,
                           max_len=32)
    got = ts.serve_greedy(tparams, tcfg, prompts, 4, n_slots=2, max_len=32,
                          device="cpu")
    assert isinstance(got[1], ts.RequestRejected)
    assert (got[1].reason, got[1].detail) == (want[1].reason,
                                              want[1].detail)
    assert got.metrics.rejection_reasons == {"exceeds_max_len": 1}
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))


def test_metrics_carry_jax_field_names(models):
    _, _, tcfg, tparams = models
    for jcls, tcls in ((js.ServingMetrics, ts.ServingMetrics),
                       (js.RequestTelemetry, ts.RequestTelemetry),
                       (js.RequestRejected, ts.RequestRejected)):
        assert ([f.name for f in dataclasses.fields(tcls)]
                == [f.name for f in dataclasses.fields(jcls)])
    got = ts.serve_greedy(tparams, tcfg, _prompts(5, 4, [3, 7]), 3,
                          n_slots=2, max_len=16, device="cpu")
    m = got.metrics
    assert m.requests == 4 and m.new_tokens == 12 and m.requeues == 0
    assert 0 < m.slot_occupancy_mean <= 1 and m.ttft_p50_s > 0
    assert [r.new_tokens for r in m.per_request] == [3] * 4
    slo = ts.RollingSLO()
    slo.note_ttft(0.5)
    assert set(slo.live_slos()) == set(js.RollingSLO().live_slos())


def test_failed_prefill_requeues_then_raises(models):
    """The retry plane: a failing step re-queues its requests and, past
    max_request_retries, re-raises with the request id."""
    _, _, tcfg, tparams = models
    fns = ts.make_server_fns(tparams, tcfg, tt, chunk=1)

    def broken_prefill(tokens, last):
        raise RuntimeError("device fault")

    with pytest.raises(RuntimeError, match="request 0 failed 3 time"):
        ts.serve_greedy(tparams, tcfg, _prompts(6, 2, [4]), 2, n_slots=1,
                        max_len=16, server_fns=(broken_prefill,) + fns[1:],
                        device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        ts.serve_greedy(tparams, tcfg, _prompts(6, 2, [4]), 2, n_slots=1,
                        max_len=16, server_fns=fns, chunk=2, device="cpu")


def test_not_yet_ported_paths_raise(models):
    _, _, tcfg, tparams = models
    with pytest.raises(NotImplementedError):
        ts.serve_greedy(tparams, tcfg, _prompts(7, 1, [4]), 2, n_slots=1,
                        max_len=16, kv_int8=True, device="cpu")
    with pytest.raises(NotImplementedError):
        ts.serve_sample(tparams, tcfg, [], 1, 1, 16, None)
    with pytest.raises(NotImplementedError):
        ts.serve_paged_greedy(tparams, tcfg, [], 1, 1, 16)


def test_reqlog_is_the_jax_format(models, tmp_path, monkeypatch):
    """Same event vocabulary as the JAX package, and a journey log that
    tools/acx_request.py decodes with no unknown kinds."""
    assert treqlog.KINDS == jreqlog.KINDS == frozenset(acx_request.KINDS)
    _, _, tcfg, tparams = models
    prefix = str(tmp_path / "serve")
    monkeypatch.setenv("ACX_REQLOG", prefix)
    treqlog._reset_for_tests()
    try:
        ts.serve_greedy(tparams, tcfg, _prompts(8, 3, [4, 6]), 3,
                        n_slots=2, max_len=16, device="cpu")
    finally:
        treqlog._reset_for_tests()
    init, events, torn = acx_request.load_reqlog(prefix +
                                                 ".rank0.reqlog.jsonl")
    assert init["schema"] == 1 and init["clock"] == "mono" and torn == 0
    journeys, fleet, unknown = acx_request.build_journeys(
        [(0, init, events, torn)], {})
    assert not unknown and sorted(journeys) == [0, 1, 2]
    assert fleet["decode_steps"] > 0
    for evs in journeys.values():
        kinds = [e["k"] for _, _, e in evs]
        assert kinds[0] == "admit" and kinds[-1] == "finish"
