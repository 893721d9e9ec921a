"""The benchmark's own bookkeeping on made-up inputs: the serve driver's
window over the program's per-request telemetry, a reader, and the
trace's reductions."""

import numpy as np
import pytest

from acxbench.drivers.serve import Driver
from acxbench.trace import Trace


def _call(t0, reqs, times, occupancy=0.5, steps=4):
    """A returned call as the driver keeps it: the program's ServedBatch
    with per-request (ttft_s, latency_s) from the call's start."""
    from mpi_acx_torch.models.serving import (RequestTelemetry,
                                              ServedBatch, ServingMetrics)
    outs = [np.concatenate([p, np.arange(n, dtype=np.int32)])
            for p, n in reqs]
    per = [RequestTelemetry(rid, t, lat, n, n / lat, 0)
           for rid, ((_, n), (t, lat)) in enumerate(zip(reqs, times))]
    return dict(t0=t0, reqs=reqs, out=ServedBatch(outs, ServingMetrics(
        per_request=per, slot_occupancy_mean=occupancy, steps=steps)))


REQS = [(np.arange(5, 25, dtype=np.int32), 3),
        (np.arange(40, 50, dtype=np.int32), 5),
        (np.arange(60, 64, dtype=np.int32), 1)]


def _driver(calls, t0=10.0, seconds=5.0):
    drv = Driver.__new__(Driver)
    drv.t0, drv.seconds, drv.calls = t0, seconds, calls
    return drv


def test_window_counts_requests_completed_inside():
    # Call 1 starts at 10: its requests end at 11, 13 and 12. Call 2
    # starts at 13: its first ends at 14.5, inside; the others at 15.5
    # and 16, past the window's end at 15.
    drv = _driver([_call(10.0, REQS, [(0.5, 1.0), (1.0, 3.0), (2.0, 2.0)]),
                   _call(13.0, REQS, [(0.5, 1.5), (1.0, 2.5), (3.0, 3.0)])])
    done = drv.in_window()
    assert [(S, n, t, lat) for S, n, t, lat, _ in done] == [
        (20, 3, 0.5, 1.0), (10, 5, 1.0, 3.0), (4, 1, 2.0, 2.0),
        (20, 3, 0.5, 1.5)]
    assert np.array_equal(done[1][4][:10], REQS[1][0])
    e2e = drv.end_to_end(5.0)
    assert e2e["attempted"] == 6 and e2e["failed"] == 0
    assert e2e["serve_tokens_per_s"] == pytest.approx((3 + 5 + 1 + 3) / 5)
    ttft = np.percentile([0.5, 1.0, 2.0, 0.5], 95) * 1e3
    tpot = np.percentile([0.25, 0.5, 0.5], 95) * 1e3
    assert e2e["ttft_p95_ms"] == pytest.approx(ttft)
    assert e2e["tpot_p95_ms"] == pytest.approx(tpot)


def test_slot_occupancy_weighs_calls_by_steps():
    from acxbench import harness
    from types import SimpleNamespace
    calls = [_call(0.0, REQS, [(1, 2)] * 3, occupancy=0.9, steps=30),
             _call(2.0, REQS, [(1, 2)] * 3, occupancy=0.3, steps=10)]
    read = harness.Bench().metric("slot_occupancy.serve").read
    assert read(SimpleNamespace(kind="serve", calls=calls)) == \
        pytest.approx(100 * (0.9 * 30 + 0.3 * 10) / 40)
    assert read(SimpleNamespace(kind="serve", calls=[])) is None


def _trace():
    # Two device ops in [0, 100): [10, 30) launched in k2 at 5, [20, 40)
    # launched at 8 outside it; one op [70, 90) launched at 60 in k2.
    return Trace(window=(0, 100), op_names=["a", "b", "a"],
                 op_start=np.array([10, 20, 70]),
                 op_end=np.array([30, 40, 90]),
                 op_launch=np.array([5, 8, 60]),
                 spans={"k2": (np.array([4, 55]), np.array([7, 65])),
                        "window": (np.array([0]), np.array([100]))})


def test_trace_reductions():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-7)
    assert tr.busy_s() == pytest.approx(50e-9)
    assert tr.count("k2") == 2
    assert tr.inside("k2").tolist() == [True, False, True]
    assert tr.device_s("k2") == pytest.approx(40e-9)
    assert tr.top_ops(1) == [["a", pytest.approx(40e-9)]]
    # Gaps [0, 10) opened in k2? no: at 0 the host is in window only;
    # [40, 70) opened at 40, in window; [90, 100) in window.
    assert tr.idle_by_span(["k2", "window"]) == [
        ["window", pytest.approx(50e-9)]]
