"""The serving-to-runtime hooks of the port's servers
(mpi_acx_torch/models/serving.py) against the JAX package's
(mpi_acx_tpu/models/serving.py): a step failure shaped like peer loss
requeues its victims without charging their retry budget and sheds one
slot, as tests/test_recovery.py holds the JAX server to; any other failure
is still charged; ``_peer_dead`` classifies exceptions as JAX's does.

The port's own tiny f32 weights on the CPU; no native library is loaded.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mpi_acx_torch import runtime as trt
from mpi_acx_torch.models import kvpage as tkp
from mpi_acx_torch.models import serving as ts
from mpi_acx_torch.models import transformer as tt

MAKE_PAGED_STEP_FN = tkp.make_paged_step_fn


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(tt.tiny_config(), dtype=torch.float32)
    return cfg, tt.init_params(cfg, seed=0, device="cpu")


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return [rng.integers(0, cfg.vocab, n).astype(np.int32)
            for n in (5, 9, 3, 7, 4)]


def _peer_loss():
    return trt.AcxPeerDeadError(
        "tpu-acx: peer dead (error=20, source=1, tag=0)", trt.ERR_PEER_DEAD,
        1, 0)


def _failing(step_fn, exc, at=2):
    """``step_fn`` that raises ``exc`` on its ``at``-th call."""
    calls = {"n": 0}

    def step(*args):
        calls["n"] += 1
        if calls["n"] == at:
            raise exc
        return step_fn(*args)
    return step, calls


def _serve_fixed(model, exc, retries=0):
    cfg, params = model
    prefill_fn, step_fn, scatter_fn, chunk, kv8, smp = ts.make_server_fns(
        params, cfg, tt)
    step, calls = _failing(step_fn, exc)
    got = ts.serve_greedy(params, cfg, _prompts(cfg), 6, n_slots=3,
                          max_len=32, max_request_retries=retries,
                          server_fns=(prefill_fn, step, scatter_fn, chunk,
                                      kv8, smp), device="cpu")
    return got, calls


def _serve_paged(model, exc, monkeypatch, retries=0):
    cfg, params = model
    calls = {}

    def lossy(*args):
        step, c = _failing(MAKE_PAGED_STEP_FN(*args), exc)
        calls.update(c=c)
        return step

    monkeypatch.setattr(tkp, "make_paged_step_fn", lossy)
    got = ts.serve_paged_greedy(params, cfg, _prompts(cfg), 6, n_slots=3,
                                max_len=32, page_tokens=8,
                                max_request_retries=retries, device="cpu")
    return got, calls["c"]


@pytest.mark.parametrize("server", ["fixed", "paged"])
def test_peer_loss_requeues_uncharged_and_sheds_a_slot(model, server,
                                                       monkeypatch):
    """max_request_retries=0, AcxPeerDeadError on the second step: every
    victim is requeued uncharged (a charged requeue would raise), one slot
    is shed, and the outputs equal the failure-free run's."""
    cfg, params = model
    want = ts.serve_greedy(params, cfg, _prompts(cfg), 6, n_slots=3,
                           max_len=32, device="cpu")
    if server == "fixed":
        got, calls = _serve_fixed(model, _peer_loss())
    else:
        got, calls = _serve_paged(model, _peer_loss(), monkeypatch)
    assert calls["n"] > 2, "the loss fired after the loop had finished"
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)
    m = got.metrics
    assert m.peer_requeues >= 1 and m.requeues == m.peer_requeues, m
    assert m.slots_shed == 1 and m.slots_revived == 0, m
    assert all(r.retries == 0 for r in m.per_request), m.per_request


@pytest.mark.parametrize("server", ["fixed", "paged"])
def test_plain_failure_is_charged(model, server, monkeypatch):
    """Any other step failure spends the budget: at 0 retries it raises
    with the request id, at 1 the victims retry once, and no slot is
    shed."""
    boom = RuntimeError("device step failed")
    with pytest.raises(RuntimeError, match="past max_request_retries=0"):
        if server == "fixed":
            _serve_fixed(model, boom)
        else:
            _serve_paged(model, boom, monkeypatch)
    if server == "fixed":
        got, _ = _serve_fixed(model, boom, retries=1)
    else:
        got, _ = _serve_paged(model, boom, monkeypatch, retries=1)
    m = got.metrics
    assert m.requeues >= 1 and m.peer_requeues == 0 and m.slots_shed == 0
    assert max(r.retries for r in m.per_request) == 1


class _Coded(Exception):
    def __init__(self, error):
        super().__init__("collective failed")
        self.error = error


def test_peer_dead_agrees_with_jax():
    from mpi_acx_tpu import runtime as jrt
    from mpi_acx_tpu.models import serving as js
    cases = [
        (_peer_loss(), True),
        (jrt.AcxPeerDeadError("x", jrt.ERR_PEER_DEAD, 1, 0), True),
        (_Coded(20), True),
        (_Coded(19), False),
        (RuntimeError("tpu-acx: peer dead (error=20)"), True),
        (OSError("link PEER_DEAD on rank 3"), True),
        (RuntimeError("device step failed"), False),
        (trt.AcxTimeoutError("op timed out", trt.ERR_TIMEOUT, 1, 0), False),
    ]
    for exc, want in cases:
        assert ts._peer_dead(exc) is want, exc
        assert js._peer_dead(exc) is want, exc


def test_hooks_stay_off_without_the_library(monkeypatch):
    """With the binding's library not loaded, no hook loads it: no fleet
    view, no dump, no annotation, no span, whatever the knobs say."""
    monkeypatch.setattr(trt, "_lib", None)
    for knob in ("ACX_FLIGHT", "ACX_TSERIES", "ACX_TRACE"):
        monkeypatch.setenv(knob, "1")
    assert ts._fleet_active() is None
    assert ts._flight_dump_best_effort() is False
    assert ts._tseries_annotate_best_effort(ts.RollingSLO()) is False
    assert ts._span_app_begin_best_effort(3) is False
    ts._span_app_end_best_effort()
    assert trt._lib is None


def test_fleet_slots_shed_and_revive(monkeypatch):
    """Shedding keeps one slot alive and takes the highest idle one; a
    rise of the ACTIVE count revives every shed slot, a drop only lowers
    the watermark."""
    active = {"n": 3}
    monkeypatch.setattr(ts, "_fleet_active", lambda: active["n"])
    owner = [7, -1, -1]
    fleet = ts._FleetSlots(owner)
    fleet.shed_one()
    assert owner == [7, -1, -2] and fleet.shed == 1
    fleet.shed_one()
    assert owner == [7, -2, -2] and fleet.shed == 2
    fleet.shed_one()                       # no idle slot left to shed
    assert fleet.shed == 2
    active["n"] = 2
    assert fleet.check_rejoin() == []
    active["n"] = 3
    assert fleet.check_rejoin() == [1, 2]
    assert owner == [7, -1, -1] and fleet.revived == 2
    alone = [-1]
    ts._FleetSlots(alone).shed_one()
    assert alone == [-1]
