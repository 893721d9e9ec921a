"""The program's own spans (``acx.*``, ``mpi_acx_torch.profiling.annotate``)
read in one traced run of a benchmark cell, and the span helper's cost.

    python3 probes/program_spans.py <cell> [--seed N] [--seconds S]
    python3 probes/program_spans.py --cost

The first form runs the cell as ``acxbench/run.py --trace 1`` does
(``harness.run_cell``: set-up, a window of ``--seconds``, the profiler over
the cell's ``trace_seconds``, the check), with the trace reduced so that it
keeps the program's ranges under their full names, and prints one
``SPANS`` JSON line: the per-layer readers of program spans
(``acxbench/metrics/``), the cell's own per-layer metrics and check, the
idle gaps charged to the innermost of the program's and the benchmark's
spans, each span's ranges and device time, the program ranges per
scheduler round or train step, the threads the ``acx.ops.attn_bwd`` ranges
were recorded on, and, for a train cell, the device time a step of the
attention backward and of the head (its forward inside ``acx.train.head``
and the backward of the autograd nodes that forward made, matched by
sequence number). The second prints a ``SPANCOST`` line: the helper's host
cost per range with no profiler and under ``torch.profiler``, and that of a
bare ``record_function``.

Run from the repository root on a machine with one NVIDIA GPU.
"""

import argparse
import bisect
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acxbench import harness, trace  # noqa: E402
from acxbench.run import _fixed_caches  # noqa: E402

READERS = ("decode_issue_ms.serve", "sched_ms.serve",
           "queue_wait_p90_ms.serve", "attn_bwd_ms.train")
# Deepest first: each program span ahead of the benchmark span round it.
ORDER = ["acx.ops.attn_bwd", "k1", "k1_lse", "k2", "acx.model.layers",
         "acx.model.head", "acx.model.decode", "acx.model.prefill",
         "decode_step", "prefill", "acx.serve.first_token",
         "acx.serve.issue", "acx.serve.wait", "acx.serve.refill",
         "data_next", "acx.train.head", "acx.train.forward",
         "acx.train.backward", "acx.train.optimizer", "step",
         "acx.serve.round", "acx.serve.call", "serve_call", "window"]
BACKWARD_NODE = "autograd::engine::evaluate_function: "


class _Named:
    """A profiler event whose ``acx.`` range name reads as a benchmark
    span's, so ``trace.reduce_events`` keeps it under its full name."""

    def __init__(self, ev):
        self._ev = ev

    def name(self):
        return trace.PREFIX + self._ev.name()

    def __getattr__(self, attr):
        return getattr(self._ev, attr)


def _keep_program_spans(raw):
    """Make ``trace.reduce_events`` keep the ``acx.`` ranges, and the raw
    events in ``raw``."""
    reduce_events = trace.reduce_events

    def reduce(events):
        raw[:] = list(events)
        return reduce_events([
            _Named(ev) if ev.is_user_annotation()
            and ev.name().startswith("acx.") else ev for ev in raw])

    trace.reduce_events = reduce


def _threads(events, name):
    return sorted({ev.start_thread_id() for ev in events
                   if ev.is_user_annotation() and ev.name() == name})


def head_ranges(events, name="acx.train.head"):
    """Host ranges (ns) in which the head launched its work: the ``name``
    ranges, and the evaluation of each autograd node that an op inside
    them made (a node carries its forward op's sequence number and
    thread)."""
    fwd = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(),
            ev.start_thread_id()) for ev in events
           if ev.is_user_annotation() and ev.name() == name]
    fwd.sort()
    starts = [s for s, _, _ in fwd]
    made = set()
    for ev in events:
        if ev.device_type() != torch.autograd.DeviceType.CPU or \
                ev.is_user_annotation() or ev.sequence_nr() < 0:
            continue
        t = ev.start_ns()
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < fwd[i][1] and fwd[i][2] == ev.start_thread_id():
            made.add((fwd[i][2], ev.sequence_nr()))
    bwd = [(ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in events if ev.name().startswith(BACKWARD_NODE)
           and (ev.fwd_thread_id(), ev.sequence_nr()) in made]
    return [(s, e) for s, e, _ in fwd] + bwd


def launched_in(tr, ranges):
    """Device seconds of the ops whose launch lies inside any of
    ``ranges``."""
    if not ranges:
        return 0.0
    s = np.array(sorted(a for a, _ in ranges), dtype=np.int64)
    e = np.array([b for _, b in sorted(ranges)], dtype=np.int64)
    idx = np.searchsorted(s, tr.op_launch, side="right") - 1
    ok = (idx >= 0) & (tr.op_launch >= 0)
    ok &= tr.op_launch < np.maximum.accumulate(e)[np.maximum(idx, 0)]
    return float((tr.op_end - tr.op_start)[ok].sum()) / 1e9


def cell(name, seed, seconds):
    raw = []
    _keep_program_spans(raw)
    bench = harness.Bench()
    res = harness.run_cell(bench, name, seed, seconds, True, "cuda")
    art = res["art"]
    tr = art.trace
    out = {"cell": name, "seed": seed, "card": torch.cuda.get_device_name(0),
           "correct": res["correct"], "checks": res["checks"],
           "window_s": tr.window_s, "busy_s": tr.busy_s()}
    out["readers"] = {m: bench.metric(m).read(art) for m in READERS}
    out["metrics"] = {k: v["value"] for k, v in res["metrics"].items()}
    out["idle_gaps"] = tr.idle_by_span(ORDER, 16)
    out["spans"] = {s: [tr.count(s), tr.device_s(s)]
                    for s in sorted(tr.spans)}
    per = tr.count("acx.serve.round") or tr.count("step")
    prog = sum(tr.count(s) for s in tr.spans if s.startswith("acx."))
    out["program_ranges"] = prog
    out["program_ranges_per_round_or_step"] = prog / per if per else None
    steps = tr.count("acx.train.backward")
    if steps:
        out["attn_bwd_threads"] = _threads(raw, "acx.ops.attn_bwd")
        out["main_threads"] = _threads(raw, "acxbench.window")
        out["per_step_device_ms"] = {
            "attn_bwd": 1e3 * tr.device_s("acx.ops.attn_bwd") / steps,
            "head": 1e3 * launched_in(tr, head_ranges(raw)) / steps,
            "step": 1e3 * tr.device_s("step") / tr.count("step")}
    print("SPANS " + json.dumps(out), flush=True)


def cost(n=200_000):
    from mpi_acx_torch import profiling

    def per_call(fn, k):
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return 1e6 * (time.perf_counter() - t0) / k

    def helper():
        with profiling.annotate("acx.probe.range"):
            pass

    def bare():
        with torch.autograd.profiler.record_function("acx.probe.range"):
            pass

    out = {"card": torch.cuda.get_device_name(0),
           "off_us": per_call(helper, n), "bare_off_us": per_call(bare, n)}
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["on_us"] = per_call(helper, n // 20)
        out["bare_on_us"] = per_call(bare, n // 20)
    print("SPANCOST " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("cell", nargs="?")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--cost", action="store_true")
    args = ap.parse_args()
    _fixed_caches()
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    if args.cost:
        cost()
    if args.cell:
        cell(args.cell, args.seed, args.seconds)


if __name__ == "__main__":
    main()
