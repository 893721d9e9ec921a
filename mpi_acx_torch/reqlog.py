"""Request-journey event log: the port's own copy of ``mpi_acx_tpu/reqlog.py``.

The serving loop (models/serving.py) appends one JSON line per lifecycle
event — admit/reject, queue, prefill, seat, decode steps, stream, requeue,
finish — to ``<$ACX_REQLOG>.rank<r>.reqlog.jsonl``, keyed by request id and
by the app span id (``span = rid + 1``). The event kinds (:data:`KINDS`) and
the line format are the JAX package's, so ``tools/acx_request.py`` reads
the port's logs unchanged.

Line schema (one JSON object per line, torn-tolerant):

  init line   {"init":true,"rank":r,"pid":...,"role":"...",
               "clock":"mono","schema":1,
               "t_mono_ns":...,"t_wall_ms":...}
  event line  {"k":<kind>,"t_mono_ns":...,"rid":...,"span":rid+1,
               ...kind-specific fields}

The port has no native runtime binding yet, so ``t_mono_ns`` is always a
process-local monotonic clock (``"clock":"mono"``); the init line's paired
(t_mono_ns, t_wall_ms) reading anchors it for offline merges. Every line is
flushed as it is written, so a crashed process leaves at most one torn
final line, which readers skip.

Emitting never raises: with ACX_REQLOG unset, ``emit`` is one dict lookup
and a falsy return.
"""

from __future__ import annotations

import json
import os
import threading
import time

# The journey event-kind vocabulary: the JAX package's set, which the
# decode table in tools/acx_request.py (KINDS) matches exactly.
KINDS = frozenset({
    "admit",          # request accepted by typed admission
    "reject",         # typed admission rejection (reason field)
    "queue",          # request enqueued on the scheduler queue
    "prefill_start",  # prompt pass begins (bucket field)
    "prefill_layer",  # one layer of a layerwise (disagg) prefill done
    "prefill_end",    # prompt pass done, first token known
    "ship_hdr",       # KV handoff descriptor header sent/received
    "ship_pready",    # one KV partition published to the wire
    "ship_fin",       # KV handoff FIN descriptor sent/received
    "seat",           # request seated in a cache slot (pages/scatter)
    "prefix_hit",     # radix prefix-cache prompt match
    "decode_step",    # one batched decode step (rid-less, batch-wide)
    "stream",         # tokens streamed to the request this step
    "preempt",        # request evicted by page pressure (requeued)
    "resume",         # a previously preempted request re-seated
    "requeue",        # failure-path restart (charged flag)
    "finish",         # request retired; terminal journey event
})

_SCHEMA = 1

_lock = threading.Lock()
_state = None        # None = unprobed, False = disabled, file = armed
_mono_zero = 0


def _now_ns() -> int:
    return time.monotonic_ns() - _mono_zero


def _probe_clock() -> str:
    """Latch the process-local monotonic zero of this reqlog's timeline."""
    global _mono_zero
    _mono_zero = time.monotonic_ns()
    return "mono"


def _rank() -> int:
    try:
        return int(os.environ.get("ACX_RANK", "0") or 0)
    except ValueError:
        return 0


def _armed():
    """Open (once) the per-rank journey file, or latch disabled."""
    global _state
    if _state is not None:
        return _state
    with _lock:
        if _state is not None:
            return _state
        prefix = os.environ.get("ACX_REQLOG", "").strip()
        if not prefix:
            _state = False
            return _state
        clock = _probe_clock()
        try:
            f = open(f"{prefix}.rank{_rank()}.reqlog.jsonl", "a")
            f.write(json.dumps({
                "init": True, "schema": _SCHEMA, "rank": _rank(),
                "pid": os.getpid(),
                "role": os.environ.get("ACX_ROLE", ""),
                "clock": clock, "t_mono_ns": _now_ns(),
                "t_wall_ms": int(time.time() * 1e3),
            }, separators=(",", ":")) + "\n")
            f.flush()
            _state = f
        except OSError:
            _state = False
    return _state


def enabled() -> bool:
    """True iff journey logging is armed for this process."""
    return bool(_armed())


def emit(kind: str, rid: int = -1, **fields) -> bool:
    """Append one journey event; returns True iff a line was written.
    Never raises (an unwritable line is dropped, not fatal) and
    flushes per line so a crashed rank's tail survives."""
    f = _armed()
    if not f:
        return False
    try:
        rec = {"k": kind, "t_mono_ns": _now_ns()}
        if rid >= 0:
            rec["rid"] = int(rid)
            rec["span"] = int(rid) + 1   # the app span id offset
        rec.update(fields)
        with _lock:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")
            f.flush()
        return True
    except Exception:  # pragma: no cover — diagnostics must never raise
        return False


def _reset_for_tests() -> None:
    """Drop the armed/disabled latch so a test can re-point ACX_REQLOG.
    Test-only; production code never re-arms."""
    global _state, _mono_zero
    with _lock:
        if _state not in (None, False):
            try:
                _state.close()
            except Exception:
                pass
        _state = None
        _mono_zero = 0
