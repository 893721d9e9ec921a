"""The readers of the program's own spans (``acx.<layer>.<what>``, opened
inside ``mpi_acx_torch`` by ``profiling.annotate``) on hand-made traces:
the children of a round are subtracted, each refill is paired with its
call, and nothing is read where the spans are absent. ``reduce_events``
gives the existing trace readers the same values with the program's
ranges in the trace as without them."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from acxbench import harness
from acxbench.trace import Trace, reduce_events


def _metric(name):
    return harness.Bench().metric(name)


def _trace(spans, window=(0, 1000), ops=((), (), ())):
    names = ["op"] * len(ops[0])
    return Trace(window=window, op_names=names,
                 op_start=np.array(ops[0], dtype=np.int64),
                 op_end=np.array(ops[1], dtype=np.int64),
                 op_launch=np.array(ops[2], dtype=np.int64),
                 spans={k: (np.array([a for a, _ in v], dtype=np.int64),
                            np.array([b for _, b in v], dtype=np.int64))
                        for k, v in dict(spans, window=[window]).items()})


def _serve_art(tr, chunk=2):
    return SimpleNamespace(kind="serve", trace=tr, chunk=chunk)


# Two calls; rounds [10, 60) and [100, 200) in call 1; a round cut by the
# profiler's stop past the window's end (1000) in call 2.
SERVE = {
    "acx.serve.call": [(5, 300), (400, 1100)],
    "acx.serve.round": [(10, 60), (100, 200), (900, 1100)],
    "acx.serve.issue": [(12, 30), (110, 150), (905, 1100)],
    "acx.serve.wait": [(30, 50), (150, 160)],
    "acx.serve.refill": [(7, 9), (52, 58), (170, 190), (420, 500)],
}


def test_decode_issue_reader():
    read = _metric("decode_issue_ms.serve").read
    # (18 + 40) ns over 2 ranges x chunk 2; the cut range is left out.
    assert read(_serve_art(_trace(SERVE))) == pytest.approx(58e-6 / 4)
    assert read(_serve_art(_trace({}))) is None
    assert read(_serve_art(None)) is None


def test_sched_reader_subtracts_children():
    read = _metric("sched_ms.serve").read
    # Rounds 50 + 100 ns; inside them issue 18 + 40, wait 20 + 10,
    # refill 6 + 20 (the refill at [7, 9) lies before the first round).
    own = 150 - (58 + 30 + 26)
    assert read(_serve_art(_trace(SERVE))) == pytest.approx(own * 1e-6 / 4)
    only_rounds = {"acx.serve.round": SERVE["acx.serve.round"]}
    assert read(_serve_art(_trace(only_rounds))) == \
        pytest.approx(150e-6 / 4)
    assert read(_serve_art(_trace({}))) is None


def test_queue_wait_reader_pairs_each_refill_with_its_call():
    read = _metric("queue_wait_p90_ms.serve").read
    # Waits 2, 47, 165 (call 1 from 5) and 20 (call 2 from 400, cut at
    # the stop: its start still counts).
    want = np.percentile([2, 47, 165, 20], 90) * 1e-6
    assert read(_serve_art(_trace(SERVE))) == pytest.approx(want)
    no_calls = {"acx.serve.refill": SERVE["acx.serve.refill"]}
    assert read(_serve_art(_trace(no_calls))) is None
    assert read(_serve_art(_trace({}))) is None


def test_attn_bwd_reader():
    read = _metric("attn_bwd_ms.train").read
    spans = {"acx.train.backward": [(100, 400), (500, 800)],
             "acx.ops.attn_bwd": [(110, 150), (200, 260), (510, 590)]}
    # Ops launched at 120 and 520 inside attn_bwd (30 + 50 ns of device),
    # one at 300 outside it.
    ops = ((130, 310, 530), (160, 400, 580), (120, 300, 520))
    tr = _trace(spans, ops=ops)
    art = SimpleNamespace(kind="train", trace=tr)
    assert read(art) == pytest.approx(1e3 * 80e-9 / 2)
    assert read(SimpleNamespace(kind="train", trace=_trace({}, ops=ops))) \
        is None
    assert read(SimpleNamespace(kind="serve", trace=tr)) is None


class _Ev:
    """A Kineto event as ``reduce_events`` reads it."""

    def __init__(self, name, start, dur, cpu=True, annotation=False,
                 corr=0, linked=0):
        self._v = (name, start, dur, cpu, annotation, corr, linked)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return (torch.autograd.DeviceType.CPU if self._v[3]
                else torch.autograd.DeviceType.CUDA)

    def is_user_annotation(self):
        return self._v[4]

    def correlation_id(self):
        return self._v[5]

    def linked_correlation_id(self):
        return self._v[6]

    def activity_type(self):
        return "cuda_runtime" if self._v[0] == "cudaLaunchKernel" else "cpu_op"


def test_existing_readers_unmoved_by_program_spans():
    """The benchmark's trace-based readers read the same values with the
    program's ranges in the trace as without them."""
    base = [_Ev("acxbench.window", 0, 1000, annotation=True),
            _Ev("acxbench.decode_step", 100, 300, annotation=True),
            _Ev("acxbench.decode_step", 500, 300, annotation=True),
            _Ev("acxbench.k2", 150, 50, annotation=True),
            _Ev("cudaLaunchKernel", 160, 5, corr=1),
            _Ev("cudaLaunchKernel", 520, 5, corr=2),
            _Ev("kernel_a", 200, 40, cpu=False, corr=1),
            _Ev("kernel_b", 560, 80, cpu=False, corr=2)]
    program = [_Ev("acx.serve.issue", 90, 320, annotation=True),
               _Ev("acx.model.decode", 105, 290, annotation=True),
               _Ev("acx.serve.round", 80, 700, annotation=True)]
    arts = []
    for events in (base, base + program):
        tr = reduce_events(events)
        arts.append(SimpleNamespace(kind="serve", trace=tr, chunk=2,
                                    k2_steps=[(40, 4), (44, 4)],
                                    dims=None))
    for name in ("decode_device_ms.serve", "device_idle.serve"):
        read = _metric(name).read
        assert read(arts[0]) == read(arts[1]) is not None, name
    without, with_ = ((t.window, t.op_start.tolist(), t.op_launch.tolist(),
                       t.idle_by_span(["k2", "decode_step", "window"]),
                       {k: [x.tolist() for x in v]
                        for k, v in t.spans.items() if not
                        k.startswith("acx.")})
                      for t in (a.trace for a in arts))
    assert without == with_
