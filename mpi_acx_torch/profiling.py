"""Device-side profiling and step timing (the JAX package's
``profiling.py``), over ``torch.profiler``.

* :func:`trace` — capture a ``torch.profiler`` trace (host ops and, on a
  CUDA device, the card's kernels) into a directory, as a Chrome trace
  file.
* :func:`annotate` — a named span inside a trace: a ``record_function``,
  plus an NVTX range when a CUDA device is present; nothing at all when
  no profiler runs.
* :class:`StepTimer` — wall-clock step statistics where each sample ends
  in a synchronize of the device the step's value lies on, so a sample
  covers the device's work and not only its dispatch.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the region into ``logdir``
    (a Chrome trace, ``trace_<pid>_<time>.json``, readable in Perfetto or
    TensorBoard):

        with profiling.trace("/tmp/prof"):
            loss, params = step(params, tokens, targets)
            loss.item()
    """
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield
    finally:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named sub-region inside a trace (a span in the viewer): a
    ``record_function`` range, plus an NVTX range on a CUDA device.

        with profiling.annotate("attention"):
            o = flash_attention(q, k, v)

    Free when no profiler runs: it reads the profiler's module-level flag,
    which holds for every thread (autograd runs the CUDA backward on one
    of its own), and builds no range. The program's own spans are named
    ``acx.<layer>.<what>``."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _range(name)


_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def _range(name: str):
    nvtx = torch.cuda.is_available()
    with torch.autograd.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def _sync(value: Any) -> bool:
    """Wait for the device work behind ``value``: a synchronize of the
    CUDA device of the first CUDA tensor found in it (a tensor, or a
    tuple, list or dict holding tensors). CPU tensors need nothing.
    Returns whether it synchronized."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
            return True
        return False
    if isinstance(value, dict):
        value = list(value.values())
    if isinstance(value, (tuple, list)):
        return any(_sync(v) for v in value)
    return False


class StepTimer:
    """Wall-clock statistics over training or serving steps.

    Each timed region ends with a synchronize of the device that the
    value handed to ``sync`` lies on, so a sample covers the whole device
    execution, not just its dispatch. Percentiles are nearest-rank over the
    sorted samples (no interpolation).

        timer = StepTimer()
        for batch in data:
            with timer.step() as t:
                loss, params = train_step(params, batch)
                t.sync(loss)
        print(timer.summary())
    """

    class _Region:
        def __init__(self):
            self._value = None
            self._synced = False

        def sync(self, value: Any):
            """Register the value whose readiness ends the step."""
            self._value = value
            self._synced = True

    def __init__(self):
        self.samples: List[float] = []

    @contextlib.contextmanager
    def step(self):
        region = StepTimer._Region()
        t0 = time.perf_counter()
        yield region
        if not region._synced:
            # Without a sync point the sample would time the dispatch of the
            # step, not the device's work: refuse it.
            raise RuntimeError(
                "StepTimer.step() region ended without sync(value); the "
                "sample would time dispatch, not the device step")
        _sync(region._value)
        self.samples.append(time.perf_counter() - t0)

    def _pct(self, p: float) -> float:
        s = sorted(self.samples)
        if not s:
            return 0.0
        # Nearest-rank percentile: the ceil(p*n)-th smallest sample.
        return s[max(0, math.ceil(p * len(s)) - 1)]

    def reset(self) -> None:
        """Drop all recorded samples (e.g. after warm-up steps)."""
        self.samples = []

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"steps": 0}
        n = len(self.samples)
        return {
            "steps": n,
            "mean_s": sum(self.samples) / n,
            "min_s": min(self.samples),
            "p50_s": self._pct(0.50),
            "p90_s": self._pct(0.90),
            "p99_s": self._pct(0.99),
            "max_s": max(self.samples),
        }

    def dump(self, path: str, extra: Optional[Dict[str, Any]] = None):
        """Write the summary and the raw samples as JSON."""
        out = dict(self.summary(), samples=self.samples, **(extra or {}))
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        return out
