"""The program's own spans in a traced run: ``record_function`` ranges
named ``acx.<layer>.<what>``, opened inside ``mpi_acx_torch`` by
``profiling.annotate``, in a :class:`trace.Trace` that holds them under
their full names. The readers that time the program from inside read them
here. ``trace.reduce_events`` keeps only the benchmark's own
``acxbench.`` ranges; ``probes/program_spans.py`` reduces a trace with the
program's ranges kept as well.

A range still open when the profiler stopped ends at the stop, past the
window's own span; :func:`ranges` leaves such ranges out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

Ranges = Tuple[np.ndarray, np.ndarray]


def ranges(tr, name: str) -> Optional[Ranges]:
    """(starts, ends), ns on the profiler's clock, of the ranges of span
    ``name`` that ended inside the traced window; None where there are
    none (a program without the span, or no trace)."""
    if tr is None or name not in tr.spans:
        return None
    s, e = tr.spans[name]
    keep = e <= tr.window[1]
    if not keep.any():
        return None
    return s[keep], e[keep]


def enclosing(outer: Ranges, starts: np.ndarray) -> np.ndarray:
    """For each of ``starts``, the index of the ``outer`` range it lies
    in, or -1 (ranges of one name never overlap)."""
    o_s, o_e = outer
    idx = np.searchsorted(o_s, starts, side="right") - 1
    hit = (idx >= 0) & (starts < o_e[np.maximum(idx, 0)])
    return np.where(hit, idx, -1)


def time_inside(outer: Ranges, inner: Ranges) -> int:
    """ns of the ``inner`` ranges that lie wholly inside an ``outer``
    range."""
    s, e = inner
    idx = enclosing(outer, s)
    m = (idx >= 0) & (e <= outer[1][np.maximum(idx, 0)])
    return int((e[m] - s[m]).sum())
