"""The traced run's instrumentation: ``torch.profiler`` over the traced
window, the benchmark's own spans, and the reduction of the raw trace to
what the per-layer readers take.

Spans are ``record_function`` ranges named ``acxbench.<name>``, opened by
the benchmark's files around its calls into the program. A device
operation belongs to a span when the host op that launched it started
inside one of the span's ranges (a kernel launched straight from a span,
as the ctypes-bound kernels are, links to the span itself).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

PREFIX = "acxbench."


def span(name: str):
    """A named range of the benchmark's (free when no profiler runs but
    for the range's own bookkeeping)."""
    return torch.profiler.record_function(PREFIX + name)


@dataclass
class Trace:
    """The traced window reduced to arrays (times in ns, the profiler's
    clock)."""
    window: Tuple[int, int]
    op_names: List[str]
    op_start: np.ndarray
    op_end: np.ndarray
    op_launch: np.ndarray            # host start of the launching op, or -1
    spans: Dict[str, Tuple[np.ndarray, np.ndarray]] = field(
        default_factory=dict)
    linked: Tuple[int, int, int] = (0, 0, 0)   # ops with a launch, ops, calls

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        """Seconds of the window in which some device operation ran."""
        lo, hi = self.window
        s = np.clip(self.op_start, lo, hi)
        e = np.clip(self.op_end, lo, hi)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        busy, cur_s, cur_e = 0, None, None
        for a, b in zip(s.tolist(), e.tolist()):
            if cur_e is None or a > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy / 1e9

    def count(self, name: str) -> int:
        """How many ranges of span ``name`` the window holds."""
        return len(self.spans.get(name, (np.zeros(0),))[0])

    def inside(self, name: str) -> np.ndarray:
        """Mask of the device operations launched inside span ``name``."""
        if name not in self.spans or not len(self.op_launch):
            return np.zeros(len(self.op_launch), dtype=bool)
        starts, ends = self.spans[name]
        idx = np.searchsorted(starts, self.op_launch, side="right") - 1
        ok = (idx >= 0) & (self.op_launch >= 0)
        idx = np.maximum(idx, 0)
        return ok & (self.op_launch < ends[idx])

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside span
        ``name``."""
        m = self.inside(name)
        return float((self.op_end[m] - self.op_start[m]).sum()) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        """The device operations that took most time, by name."""
        tot: Dict[str, int] = {}
        for name, d in zip(self.op_names,
                           (self.op_end - self.op_start).tolist()):
            tot[name] = tot.get(name, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v / 1e9] for k, v in top]

    def idle_by_span(self, order: List[str], n: int = 10) -> List[list]:
        """Idle device time of the window, each gap charged to the
        innermost of the ``order`` spans (deepest first) that the host was
        in when the gap opened; the largest totals first."""
        lo, hi = self.window
        s = np.sort(np.clip(self.op_start, lo, hi))
        e = np.maximum.accumulate(np.clip(self.op_end, lo, hi)[
            np.argsort(np.clip(self.op_start, lo, hi), kind="stable")])
        gap_s = np.concatenate([[lo], e])
        gap_e = np.concatenate([s, [hi]])
        keep = gap_e > gap_s
        gap_s, gap_e = gap_s[keep], gap_e[keep]
        who = np.full(len(gap_s), "host, outside every span", dtype=object)
        free = np.ones(len(gap_s), dtype=bool)
        for name in order:
            if name not in self.spans:
                continue
            starts, ends = self.spans[name]
            idx = np.searchsorted(starts, gap_s, side="right") - 1
            hit = free & (idx >= 0) & (gap_s < ends[np.maximum(idx, 0)])
            who[hit] = name
            free &= ~hit
        tot: Dict[str, int] = {}
        for w, d in zip(who.tolist(), (gap_e - gap_s).tolist()):
            tot[w] = tot.get(w, 0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in top]


class Tracer:
    """``torch.profiler`` over one window, opened and closed by the
    driver; :meth:`result` reduces it to a :class:`Trace`."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._stack = contextlib.ExitStack()
        self.t_start = self.t_stop = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.start()
        self._stack.enter_context(span("window"))
        self.t_start = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self._stack.close()
        self._prof.stop()

    @property
    def running(self) -> bool:
        return self.t_start is not None and self.t_stop is None

    def result(self) -> Trace:
        return reduce_events(self._prof.profiler.kineto_results.events())


def _is_launch_call(ev) -> bool:
    """A CUDA runtime or driver call (which events carry an activity type
    depends on the torch version)."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in ("cuda_runtime", "cuda_driver")
    name = ev.name()
    return name.startswith("cu") and not ev.is_user_annotation() and any(
        w in name for w in ("Launch", "Memcpy", "Memset"))


def reduce_events(events) -> Trace:
    """Raw Kineto events -> :class:`Trace`: device operations (kernels,
    copies, sets; user-annotation mirrors left out), host spans of the
    benchmark by name, and when each operation was launched: the start of
    its CUDA runtime or driver call, else of the host op it is linked to
    (ops and runtime calls number their correlations apart)."""
    op_start: Dict[int, int] = {}
    rt_start: Dict[int, int] = {}
    spans: Dict[str, List[Tuple[int, int]]] = {}
    dev = []
    for ev in events:
        if ev.device_type() == torch.autograd.DeviceType.CPU:
            if _is_launch_call(ev):
                rt_start[ev.correlation_id()] = ev.start_ns()
                continue
            if ev.correlation_id():
                op_start[ev.correlation_id()] = ev.start_ns()
            name = ev.name()
            if ev.is_user_annotation() and name.startswith(PREFIX):
                spans.setdefault(name[len(PREFIX):], []).append(
                    (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif not ev.is_user_annotation():
            dev.append(ev)
    names = [ev.name() for ev in dev]
    start = np.array([ev.start_ns() for ev in dev], dtype=np.int64)
    end = start + np.array([ev.duration_ns() for ev in dev], dtype=np.int64)
    launch = np.array([rt_start.get(ev.correlation_id(),
                                    op_start.get(ev.linked_correlation_id(),
                                                 -1)) for ev in dev],
                      dtype=np.int64)
    out = {}
    for name, iv in spans.items():
        iv.sort()
        out[name] = (np.array([a for a, _ in iv], dtype=np.int64),
                     np.array([b for _, b in iv], dtype=np.int64))
    if "window" not in out:
        raise RuntimeError("the traced window holds no acxbench.window span")
    window = (int(out["window"][0][0]), int(out["window"][1][-1]))
    tr = Trace(window, names, start, end, launch, out)
    tr.linked = (int((launch >= 0).sum()), len(dev), len(rt_start))
    return tr
