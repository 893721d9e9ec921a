"""The port's own spans (``profiling.annotate``, named ``acx.<layer>.<what>``).

With no profiler running ``annotate`` builds no range at all. Under a
CPU ``torch.profiler`` run, a tiny served batch and a tiny train step show
every span at the boundary it is placed at, in the counts the program's
own counters give, nested and never overlapping. The serve loops compute
the rolling SLOs only for an armed telemetry sampler.
"""

import dataclasses
import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from mpi_acx_torch import profiling, train
from mpi_acx_torch.models import serving
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.parallel.mesh import mesh_from_devices

SERVE_SPANS = ("acx.serve.call", "acx.serve.round", "acx.serve.issue",
               "acx.serve.wait", "acx.serve.refill",
               "acx.serve.first_token", "acx.model.prefill",
               "acx.model.decode", "acx.model.layers", "acx.model.head")
N_SLOTS, CHUNK = 4, 2


def _ranges(prof):
    """name -> [(start_ns, end_ns)] of the ``acx.`` ranges, by start."""
    out = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.is_user_annotation() and ev.name().startswith("acx."):
            out.setdefault(ev.name(), []).append(
                (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return {k: sorted(v) for k, v in out.items()}


def _within(inner, outer):
    a, b = inner
    return any(s <= a and b <= e for s, e in outer)


def _tiny():
    cfg = dataclasses.replace(tfm.tiny_config(vocab=97, d_model=32,
                                              n_heads=2, n_layers=2,
                                              d_ff=64, max_seq=64),
                              dtype=torch.float32)
    return cfg, tfm.init_params(cfg, seed=0, device="cpu")


def _tiny_serve(n_requests=10):
    cfg, params = _tiny()
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(3, 20, n_requests)]
    n_new = [int(n) for n in rng.integers(1, 9, n_requests)]
    return cfg, serving.serve_greedy(
        params, cfg, prompts, n_new, n_slots=N_SLOTS, max_len=48,
        chunk=CHUNK, device="cpu")


def test_annotate_builds_no_range_without_a_profiler(monkeypatch):
    """No profiler: neither a ``record_function`` nor an NVTX range is
    built, in the helper or anywhere a served batch reaches."""
    class Refused:
        def __init__(self, *a, **kw):
            raise AssertionError("a range was built with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        Refused)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", Refused)
    assert not torch.autograd.profiler._is_profiler_enabled
    with profiling.annotate("acx.test.off"):
        pass
    _, out = _tiny_serve(n_requests=3)
    assert out.metrics.steps > 0


def test_annotate_records_a_range():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.annotate("acx.test.on"):
            torch.ones(4).sum()
    assert list(_ranges(prof)) == ["acx.test.on"]


def test_serve_spans_count_and_nest():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        cfg, out = _tiny_serve()
    r = _ranges(prof)
    m = out.metrics
    assert set(SERVE_SPANS) <= set(r), sorted(r)
    assert len(r["acx.serve.call"]) == 1
    assert len(r["acx.serve.round"]) == m.steps
    assert len(r["acx.serve.issue"]) == len(r["acx.serve.wait"]) == m.steps
    assert len(r["acx.serve.refill"]) == m.prefills == 10
    assert len(r["acx.serve.first_token"]) == m.prefills
    assert len(r["acx.model.prefill"]) == m.prefills
    assert len(r["acx.model.decode"]) == m.steps * CHUNK
    assert len(r["acx.model.layers"]) == len(r["acx.model.head"]) \
        == m.steps * CHUNK
    for name, outer in (("acx.serve.issue", "acx.serve.round"),
                        ("acx.serve.wait", "acx.serve.round"),
                        ("acx.serve.round", "acx.serve.call"),
                        ("acx.serve.refill", "acx.serve.call"),
                        ("acx.serve.first_token", "acx.serve.refill"),
                        ("acx.model.prefill", "acx.serve.refill"),
                        ("acx.model.decode", "acx.serve.issue"),
                        ("acx.model.layers", "acx.model.decode"),
                        ("acx.model.head", "acx.model.decode")):
        assert all(_within(iv, r[outer]) for iv in r[name]), (name, outer)
    # Ranges of one name never overlap.
    for name, iv in r.items():
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), name
    # TTFT is measured from the call's start to the first token's end
    # (its scatter and bookkeeping after it take microseconds).
    call0 = r["acx.serve.call"][0][0]
    firsts = sorted(e - call0 for _, e in r["acx.serve.first_token"])
    ttfts = sorted(1e9 * q.ttft_s for q in m.per_request)
    assert np.allclose(ttfts, firsts, rtol=0, atol=1e6)


def test_train_spans():
    """A tiny GPT-2 step: forward, the head inside it, backward and the
    optimizer once a step, the attention backward once a layer and
    microbatch."""
    n_micro, n_layers, steps = 2, 2, 2
    cfg = dataclasses.replace(
        tfm.tiny_config(vocab=61, d_model=32, n_heads=2, n_layers=n_layers,
                        d_ff=64, max_seq=32),
        dtype=torch.float32, use_flash=True)
    params = tfm.stage_slice(tfm.init_params(cfg, seed=0, device="cpu"), 1)
    opt = torch.optim.AdamW(train.param_leaves(params), lr=1e-3)
    step, _ = train.make_train_step_optim(
        cfg, mesh_from_devices({"dp": 1, "pp": 1, "tp": 1}), n_micro, opt,
        device="cpu")
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(
        rng.integers(0, cfg.vocab, (steps, n_micro, 2, 17)).astype(np.int32))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in tok:
            step(params, t[..., :-1], t[..., 1:])
    r = _ranges(prof)
    for name in ("acx.train.forward", "acx.train.head",
                 "acx.train.backward", "acx.train.optimizer"):
        assert len(r[name]) == steps, name
    assert all(_within(iv, r["acx.train.forward"])
               for iv in r["acx.train.head"])
    assert len(r["acx.ops.attn_bwd"]) == steps * n_layers * n_micro
    assert all(_within(iv, r["acx.train.backward"])
               for iv in r["acx.ops.attn_bwd"])
    for name, iv in r.items():
        assert all(a[1] <= b[0] for a, b in zip(iv, iv[1:])), name


# -- the rolling SLOs, computed only for an armed sampler -----------------

def test_serve_computes_no_live_slos_unarmed(monkeypatch):
    """No sampler armed (and no SLO gate): the rolling SLOs are neither
    fed nor computed, by the fixed-slot or the paged server."""
    monkeypatch.delenv("ACX_TSERIES", raising=False)

    def refused(self, *a):
        raise AssertionError("rolling SLOs kept with no sampler armed")

    for name in ("live_slos", "note_ttft", "note_itl", "note_gauges"):
        monkeypatch.setattr(serving.RollingSLO, name, refused)
    _, out = _tiny_serve(n_requests=6)
    assert out.metrics.steps > 0
    cfg, params = _tiny()
    prompts = [np.arange(1, 6 + i, dtype=np.int32) for i in range(5)]
    paged = serving.serve_paged_greedy(params, cfg, prompts, 5, n_slots=2,
                                       max_len=32, chunk=2, device="cpu")
    assert paged.metrics.steps > 0


def test_armed_sampler_gets_the_live_slos(monkeypatch):
    """An armed sampler is handed the rolling SLOs every turn, with every
    TTFT and inter-token sample of the call in them."""
    got = []

    class Lib:
        def acx_tseries_annotate(self, blob):
            got.append(blob)

    monkeypatch.setattr(serving, "_tseries_lib", lambda: Lib())
    _, out = _tiny_serve(n_requests=6)
    slos = [json.loads(b) for b in got]
    assert len(slos) == out.metrics.steps
    assert set(slos[-1]) == set(serving.RollingSLO().live_slos())
    # Each turn's fragment precedes its step: the last one holds every
    # sample but the final step's tokens and the requests seated after it.
    itl = sum(r.new_tokens - 1 for r in out.metrics.per_request)
    assert 0 < slos[-1]["itl_n"] < itl
    assert 0 < slos[-1]["ttft_n"] <= 6
    assert [f["itl_n"] for f in slos] == sorted(f["itl_n"] for f in slos)
