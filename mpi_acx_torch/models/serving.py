"""Continuous-batching serving loop (single device): the fixed-slot and
paged servers of the JAX package's ``models/serving.py``.

B cache slots decode in lockstep as one batched step while a host-side
scheduler swaps finished requests out and queued prompts in mid-stream,
so the device never waits for the slowest request. The mechanism is
per-slot positions: each slot's fresh K/V lands at its own ``pos[b]`` and
decode attention masks each slot at ``cols <= pos[b]``, so every slot's
math is its solo run's and greedy outputs equal per-request
``generate()``. A prompt of at most ``decoding.PREFILL_CAPTURE_MAX``
tokens is right-padded to a power-of-two bucket (pad rows are never
attended: they sit past ``pos[b]`` until decode overwrites them); a longer
one runs its pass at its own length, with no pad rows.

Slot caches are bf16/f32 or int8 (``kv_int8``, ops/kvquant.py), seated
as ``decoding.SlotCache``: on the GPU the decode step over one replays
from CUDA graphs between its K2 calls, captured once per slot cache
(``decoding.DecodeGraphs``), and the prefill of a :func:`make_server_fns`
result writes a prompt's rows straight into its slot, replayed from CUDA
graphs between its K1 calls, captured once per bucket
(``decoding.PrefillGraphs``; a prompt above the cap runs eagerly); a
result reused across calls keeps the cache and the captures.
:func:`serve_sample` samples (temperature / top-k / top-p) where
:func:`serve_greedy` takes the argmax: request ``rid`` draws from its own
generator, seeded ``decoding.fold_in(key, rid)``, so its tokens equal its
solo ``generate_sample`` run's whatever the schedule.
:func:`serve_paged_greedy` serves the same way over a paged KV cache
(models/kvpage.py): slots share a pool of fixed-size pages through block
tables, with typed admission against the page budget, lazy page growth and
preemption, radix prefix sharing, an SLO admission gate and per-token
streaming.

Every single-process server, models/disagg.py's loopback included, runs one
scheduler (:class:`_Loop`) over its own slots (:class:`_Slots`): the loop
keeps the queue, the slots' owners, the retry rules and the metrics; the
slots say how a request is seated and how the cache steps. The servers
report to the native runtime (``mpi_acx_torch.runtime``) as the JAX
package's do, and only when the binding has already loaded the
library (telemetry never builds or loads it): a failed step writes a flight
dump (``ACX_FLIGHT``), each scheduler turn annotates the live telemetry
samples with the rolling SLOs (``ACX_TSERIES``), each prefill opens a causal
span for its request (``ACX_TRACE``), and the fleet view's ACTIVE count is
watched so that slots shed after a peer loss come back when a replacement
joins. A failure shaped like peer loss (:func:`_peer_dead`) requeues its
victims without charging their retry budget and sheds one slot.
"""

from __future__ import annotations

import ctypes
import json
import math
import operator
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mpi_acx_torch import profiling, reqlog
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models import decoding, kvpage
from mpi_acx_torch.models.decoding import (SlotCache, filter_logits,
                                           fold_in, gumbel, key_generator,
                                           sample_logits)
from mpi_acx_torch.ops.kvquant import kv_quant


def _pct(samples: List[float], p: float) -> float:
    """Nearest-rank percentile: the ceil(p*n)-th smallest sample, no
    interpolation."""
    if not samples:
        return 0.0
    s = sorted(samples)
    return s[max(0, math.ceil(p * len(s)) - 1)]


@dataclass
class RequestTelemetry:
    """Per-request serving telemetry (times from the batch's arrival at
    the serve call, so queue wait is included)."""

    rid: int
    ttft_s: float        # time to first token (prefill emits it)
    latency_s: float     # arrival -> retire
    new_tokens: int
    tokens_per_s: float  # new_tokens / latency_s
    retries: int         # failed attempts that re-queued this request


@dataclass
class ServingMetrics:
    """Batch-level serving telemetry returned on ServedBatch.metrics (the
    JAX package's fields)."""

    requests: int = 0
    wall_s: float = 0.0
    new_tokens: int = 0
    tokens_per_s: float = 0.0     # aggregate: new_tokens / wall_s
    steps: int = 0                # decode step_fn dispatches
    prefills: int = 0             # successful refills
    requeues: int = 0             # failure-path restarts
    peer_requeues: int = 0        # requeues from peer loss (uncharged)
    slots_shed: int = 0           # slots retired to match lost capacity
    slots_revived: int = 0        # shed slots returned after a fleet join
    hang_dumps: int = 0           # flight dumps written on step failure
    rejections: int = 0           # typed admission rejections
    rejection_reasons: Dict[str, int] = field(default_factory=dict)
    preemptions: int = 0          # paged: page-pressure evictions
    prefix_hits: int = 0          # paged: radix-cache prompt matches
    prefix_evictions: int = 0     # paged: trie pages evicted under pressure
    prefix_pages_reused: int = 0  # paged: prompt pages seated from the trie
    pages_hwm: int = 0            # paged: pool pages-in-use high-water mark
    slo_deferrals: int = 0        # paged: refills deferred by the SLO gate
    ttft_p50_s: float = 0.0
    ttft_p99_s: float = 0.0
    itl_p50_s: float = 0.0        # inter-token latency (per decoded token)
    itl_p99_s: float = 0.0
    queue_depth_max: int = 0
    queue_depth_mean: float = 0.0
    slot_occupancy_mean: float = 0.0  # fraction of slots owned per step
    per_request: List[RequestTelemetry] = field(default_factory=list)


@dataclass
class RequestRejected:
    """Typed admission rejection at a request's index in the ServedBatch
    (``reason``: ``exceeds_max_len``, ``exceeds_model_ceiling`` or
    ``exceeds_page_budget``; ``detail``: the arithmetic)."""

    rid: int
    reason: str
    detail: str = ""


def _admission_check(rid, prompt, n, chunk, max_len, max_seq,
                     page_budget=None, page_tokens=None
                     ) -> Optional[RequestRejected]:
    """A request needs ``len(prompt) + n + chunk`` cache positions (a slot
    finishing mid-chunk keeps writing until the chunk boundary); the paged
    server adds the pool bound (``page_budget`` pages of
    ``page_tokens``)."""
    total = len(prompt) + n + chunk
    if total > max_len:
        return RequestRejected(
            rid, "exceeds_max_len",
            f"len(prompt)={len(prompt)} + n_new={n} + chunk={chunk} "
            f"= {total} > max_len={max_len}")
    if total > max_seq:
        return RequestRejected(
            rid, "exceeds_model_ceiling",
            f"len(prompt)={len(prompt)} + n_new={n} + chunk={chunk} "
            f"= {total} > cfg.max_seq={max_seq}")
    if page_budget is not None:
        need = -(-total // page_tokens)
        if need > page_budget:
            return RequestRejected(
                rid, "exceeds_page_budget",
                f"ceil({total} / {page_tokens}) = {need} pages > "
                f"pool n_pages={page_budget}")
    return None


def _count_reasons(rejections) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for rej in rejections:
        out[rej.reason] = out.get(rej.reason, 0) + 1
    return out


class ServedBatch(list):
    """serve_greedy result: a plain list of per-request ``prompt +
    generated`` arrays carrying the batch telemetry as ``.metrics``. A
    call over a slot cache that keeps device-side step counters
    (``'counts'``, cumulative; models/deepseek_v2.py: per MoE layer, the
    experts touched and the pairs routed) also carries
    ``.round_counters``: their value at the call's start and after each
    decode round, read back once at the call's end."""

    def __init__(self, outputs, metrics: ServingMetrics):
        super().__init__(outputs)
        self.metrics = metrics


def _peer_dead(exc: BaseException) -> bool:
    """True iff ``exc`` is shaped like peer loss: the runtime's
    ``AcxPeerDeadError``, anything carrying ``error == ERR_PEER_DEAD``, or
    a message naming the condition. Losing a rank is not the request's
    fault, so the scheduler requeues its victims uncharged."""
    from mpi_acx_torch.runtime import ERR_PEER_DEAD, AcxPeerDeadError
    if isinstance(exc, AcxPeerDeadError):
        return True
    if getattr(exc, "error", None) == ERR_PEER_DEAD:
        return True
    msg = str(exc).lower()
    return "peer dead" in msg or "peer_dead" in msg


def _loaded_lib():
    """The native library if the port's binding has already loaded it,
    else None: the hooks below never build or load it."""
    from mpi_acx_torch import runtime
    return runtime._lib


def _fleet_active() -> Optional[int]:
    """The count of ACTIVE rank slots in this process's fleet view, or None
    when the native library is not loaded. The server polls it to see
    capacity return (a replacement rank joined) and revive shed slots."""
    lib = _loaded_lib()
    if lib is None:
        return None
    out = (ctypes.c_uint64 * 5)()
    lib.acx_fleet_stats(out)
    return int(out[4])


def _flight_dump_best_effort() -> bool:
    """Write this rank's flight-recorder dump when ``ACX_FLIGHT`` names a
    prefix and the native library is loaded (tools/acx_doctor.py reads it
    to say which op wedged). Returns True iff a dump was written."""
    if not os.environ.get("ACX_FLIGHT"):
        return False
    lib = _loaded_lib()
    return lib is not None and lib.acx_flight_dump(None) == 0


def _tseries_lib():
    """The native library when ``ACX_TSERIES`` sampling is armed in it,
    else None."""
    if not os.environ.get("ACX_TSERIES"):
        return None
    lib = _loaded_lib()
    if lib is None or not lib.acx_tseries_enabled():
        return None
    return lib


def _tseries_annotate_best_effort(slo: "RollingSLO") -> bool:
    """Hand ``slo``'s live SLOs to the native telemetry sampler (they ride
    under ``"app"`` in every later ``ACX_TSERIES`` sample) when the library
    is loaded and sampling is armed; they are not even computed otherwise.
    Returns True iff the sampler took them."""
    lib = _tseries_lib()
    if lib is None:
        return False
    lib.acx_tseries_annotate(
        json.dumps(slo.live_slos(), separators=(",", ":")).encode())
    return True


def _span_app_begin_best_effort(request_id: int) -> bool:
    """Open a causal-tracing bracket for ``request_id`` (``ACX_TRACE``
    armed, library loaded): every native op enqueued until the matching
    end is tied to the request, so tools/acx_critpath.py can split its
    TTFT. The span id is ``request_id + 1`` (0 means no span). Returns True
    iff the bracket was opened; the caller must then close it."""
    if not os.environ.get("ACX_TRACE"):
        return False
    lib = _loaded_lib()
    if lib is None:
        return False
    lib.acx_span_app_begin(request_id + 1)
    return True


def _span_app_end_best_effort() -> None:
    lib = _loaded_lib()
    if lib is not None:
        lib.acx_span_app_end()


class _FleetSlots:
    """Slot shedding and revival of one serve call over its ``owner``
    list (-1 idle, -2 shed, else the request id): a peer loss sheds an
    idle slot, and a rise of the fleet's ACTIVE count revives the shed
    ones."""

    def __init__(self, owner: List[int]):
        self.owner = owner
        self.active_seen = _fleet_active()
        self.shed = 0
        self.revived = 0

    def check_rejoin(self) -> List[int]:
        """Revive the shed slots when the fleet view shows capacity back;
        returns them, so the caller refills exactly those. A drop only
        lowers the watermark, so the next join revives."""
        if self.active_seen is None:
            return []
        act = _fleet_active()
        if act is None:
            return []
        revived = []
        if act > self.active_seen:
            for b, o in enumerate(self.owner):
                if o == -2:
                    self.owner[b] = -1
                    revived.append(b)
            self.revived += len(revived)
        self.active_seen = act
        return revived

    def shed_one(self) -> None:
        """Retire one idle slot for good: a lost rank shrank the job, so
        the batch shrinks with it. At least one slot always stays."""
        alive = [b for b, o in enumerate(self.owner) if o != -2]
        idle = [b for b in alive if self.owner[b] == -1]
        if len(alive) <= 1 or not idle:
            return
        self.owner[max(idle)] = -2
        self.shed += 1


class RollingSLO:
    """Sliding-window serving SLOs: TTFT and inter-token-latency samples
    kept in a time-bounded window (default 30 s) plus queue-depth and
    slot-occupancy gauges; ``live_slos()`` returns the rolling p50/p99."""

    def __init__(self, window_s: float = 30.0):
        self.window_s = float(window_s)
        self._ttft: deque = deque()  # (monotonic t, seconds)
        self._itl: deque = deque()
        self.queue_depth = 0
        self.slot_occupancy = 0.0
        # Lifecycle counters, cumulative over the serve call (not windowed).
        self.rejects: Dict[str, int] = {}
        self.preemptions = 0
        self.resumes = 0

    def note_reject(self, reason: str) -> None:
        self.rejects[reason] = self.rejects.get(reason, 0) + 1

    def note_preempt(self) -> None:
        self.preemptions += 1

    def note_resume(self) -> None:
        self.resumes += 1

    def _trim(self, dq: deque, now: float) -> None:
        cutoff = now - self.window_s
        while dq and dq[0][0] < cutoff:
            dq.popleft()

    def note_ttft(self, seconds: float) -> None:
        now = time.monotonic()
        self._ttft.append((now, float(seconds)))
        self._trim(self._ttft, now)

    def note_itl(self, seconds: float) -> None:
        now = time.monotonic()
        self._itl.append((now, float(seconds)))
        self._trim(self._itl, now)

    def note_gauges(self, queue_depth: int, slot_occupancy: float) -> None:
        self.queue_depth = int(queue_depth)
        self.slot_occupancy = float(slot_occupancy)

    def live_slos(self) -> dict:
        """Rolling-window percentiles + live gauges, JSON-ready."""
        now = time.monotonic()
        self._trim(self._ttft, now)
        self._trim(self._itl, now)
        ttft = [v for _, v in self._ttft]
        itl = [v for _, v in self._itl]
        return {
            "window_s": self.window_s,
            "ttft_p50_s": _pct(ttft, 0.50),
            "ttft_p99_s": _pct(ttft, 0.99),
            "ttft_n": len(ttft),
            "itl_p50_s": _pct(itl, 0.50),
            "itl_p99_s": _pct(itl, 0.99),
            "itl_n": len(itl),
            "queue_depth": self.queue_depth,
            "slot_occupancy": self.slot_occupancy,
            "rejections": sum(self.rejects.values()),
            "rejects": dict(self.rejects),
            "preemptions": self.preemptions,
            "resumes": self.resumes,
        }


_CACHE_KEYS = ("k", "v", "ks", "vs")


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _bucketed(prompt, max_len: int, max_seq: int) -> np.ndarray:
    """``prompt`` right-padded to its power-of-two bucket, [1, bucket]. The
    bucket is capped at ``max_len`` (the rows must fit the slot) and at
    the model's position ceiling ``max_seq``. The disaggregated servers
    ship every prompt this way: the KV wire keeps one channel and one tag
    per power-of-two bucket (parallel/kv_ship.py)."""
    out = np.zeros((1, min(_bucket(len(prompt)), max_len, max_seq)),
                   np.int32)
    out[0, :len(prompt)] = prompt
    return out


def _padded(prompt, max_len: int, max_seq: int) -> np.ndarray:
    """The tokens of ``prompt``'s pass, [1, S]: bucketed
    (:func:`_bucketed`) up to ``decoding.PREFILL_CAPTURE_MAX`` tokens, the
    longest pass replayed from a capture; a longer prompt at its own
    length, eagerly, since past the cap the pad rows cost more device time
    than a replay saves host time (the constant's comment has the
    measured trade)."""
    if len(prompt) > decoding.PREFILL_CAPTURE_MAX:
        return np.asarray(prompt, np.int32)[None]
    return _bucketed(prompt, max_len, max_seq)


def make_server_fns(params, cfg, family, chunk: int = 1,
                    kv_int8: bool = False, sample_cfg=None):
    """The serve loop's closures: returns (prefill_fn, step_fn, scatter_fn,
    chunk, kv_int8, sample_cfg) as a :class:`ServerFns`, which also owns
    the slot cache its serve calls decode in (:class:`OwnedSlots`), so a
    result reused across calls keeps one cache and one captured decode
    step; the trailing values let the serve call refuse a tuple built for
    another chunk, cache type or sampling setting. ``family`` is the model
    module (models.transformer, models.llama or models.moe_transformer, or
    any module exposing prefill (with ``seat``, ``decoding.run_prefill``),
    decode_step and init_kv_cache with the shared cache layout: [L, B,
    max_len, heads, Dh] per key, where Llama's heads are its KV groups, or
    a latent cache whose 'k' [L, B, max_len, 1, row] stands alone, as
    models.deepseek_v2's).

    ``chunk`` > 1 runs that many decode steps per host round trip,
    returning the [chunk, B] token block; the scheduler then reacts every
    ``chunk`` tokens. The tokens are identical to stepwise decoding; the
    cost is scheduling granularity (a finished slot idles until the chunk
    boundary).

    ``sample_cfg`` = (temperature, top_k, top_p) makes the step sample
    instead of taking the argmax: ``step_fn(cache, tok, keys)`` then takes
    one ``torch.Generator`` per slot (``None`` for an idle slot) and each
    slot draws its ``[1, vocab]`` Gumbel noise from its own generator at
    every step, as a solo ``sample_generate`` run with that generator
    does."""

    def prefill_fn(tokens, last, seat=None):
        """[1, S_bucket], real last index -> (logits [1, 1, vocab],
        cache); the unembedding runs on the real prompt's final row. With
        ``seat = (slot cache, b)`` the rows land in slot b of the serve
        loop's cache, which is the cache returned."""
        return family.prefill(params, cfg, tokens, tokens.shape[1],
                              kv_int8=kv_int8, last_index=last, seat=seat)

    if sample_cfg is None:
        def pick(logits, keys):
            return logits.argmax(dim=-1).to(torch.int32)
    else:
        temperature, top_k, top_p = sample_cfg

        def pick(logits, keys):
            if temperature == 0.0:
                return logits.argmax(dim=-1).to(torch.int32)
            f = filter_logits(logits.float(), temperature, top_k, top_p)
            row = (1, f.shape[-1])
            g = torch.cat([gumbel(row, k) if k is not None
                           else f.new_zeros(row) for k in keys])
            return (f + g).argmax(dim=-1).to(torch.int32)

    def step_fn(cache, tok, keys=None):
        toks = []
        for _ in range(chunk):
            logits, cache = family.decode_step(params, cfg, cache, tok)
            tok = pick(logits, keys)
            toks.append(tok)
        return cache, torch.stack(toks)                # toks [chunk, B]

    def scatter_fn(slots, one, slot_idx, new_pos):
        """Land a freshly prefilled single-request cache (``one``, B=1,
        bucket-length) in slot ``slot_idx`` of the slot cache, in place;
        rows past the bucket keep the slot's old contents (never attended:
        they lie beyond ``new_pos`` until decode overwrites them). Int8
        slot caches carry their scale buffers ('ks'/'vs') the same way."""
        for key in [k for k in _CACHE_KEYS if k in slots]:
            src = one[key][:, 0]                    # [L, S_bucket, H, *]
            slots[key][:, slot_idx, :src.shape[1]] = src
        slots["pos"][slot_idx] = new_pos
        return slots

    fns = ServerFns((prefill_fn, step_fn, scatter_fn, chunk, kv_int8,
                     sample_cfg))
    fns.slots = OwnedSlots(family, cfg, kv_int8)
    return fns


class ServerFns(tuple):
    """:func:`make_server_fns`' result: the tuple ``(prefill_fn, step_fn,
    scatter_fn, chunk, kv_int8, sample_cfg)``, with ``slots``, the
    :class:`OwnedSlots` its serve calls decode in (one call at a time).
    The serve loop hands its ``prefill_fn`` the target slot (``seat=``);
    a plain tuple's gets the tokens and the last index alone."""


class OwnedSlots:
    """The slot cache a :func:`make_server_fns` result owns: drawn by the
    first serve call for its ``(n_slots, max_len, device)``, then handed to
    each later call with ``pos`` reset to 0, neither drawn anew nor zeroed
    (rows past a slot's position are never read), and with it the decode
    step's and the prefills' capture state (``decoding.SlotCache``)."""

    def __init__(self, family, cfg, kv_int8: bool):
        self.family, self.cfg, self.kv_int8 = family, cfg, kv_int8
        self.cache: Optional[SlotCache] = None
        self._shape = None

    def seat(self, n_slots: int, max_len: int, dev,
             rebuild: bool = False) -> SlotCache:
        """The slot cache for a call, ``pos`` at 0; ``rebuild`` drops its
        captures (after a failed step)."""
        if self._shape != (n_slots, max_len, dev):
            self.cache = None       # free the old cache before the new one
            self.cache = seat_slots(self.family.init_kv_cache(
                self.cfg, n_slots, max_len, kv_int8=self.kv_int8,
                device=dev))
            self._shape = (n_slots, max_len, dev)
        elif rebuild:
            self.cache.drop_captures()
        self.cache["pos"].zero_()
        return self.cache


def seat_slots(cache) -> SlotCache:
    """A fresh cache of ``init_kv_cache`` as the serve loop's slot cache:
    ``pos`` one zero a slot, and the decode step's capture state."""
    cache = SlotCache(cache)
    cache["pos"] = torch.zeros((cache["k"].shape[1],), dtype=torch.int32,
                               device=cache["k"].device)
    return cache


def _family_on(family, params, device):
    """``(family, device)``: the model module (``None`` means
    models.transformer) and the resolved device, which the parameters
    must already be on."""
    dev = resolve_device(device)
    if family is None:
        from mpi_acx_torch.models import transformer as family  # noqa: N813
    family.check_device(params, dev)
    return family, dev


def _normalize_requests(prompts, n_new):
    """Check the request list; returns ``n_new`` as one int per prompt."""
    if not prompts:
        raise ValueError("no requests")
    if not all(len(p) > 0 for p in prompts):
        raise ValueError("zero-length prompt (prefill needs at least one "
                         "token to attend)")
    n_new = ([int(n_new)] * len(prompts) if np.ndim(n_new) == 0
             else [int(n) for n in n_new])
    if len(n_new) != len(prompts):
        raise ValueError(f"{len(n_new)} n_new values for {len(prompts)} "
                         "prompts")
    if not all(n >= 1 for n in n_new):
        raise ValueError("n_new >= 1 per request (the prefill itself emits "
                         "the first token)")
    return n_new


def _server_fns(server_fns, params, cfg, family, chunk, kv_int8,
                sample_cfg):
    """``server_fns``, or a :func:`make_server_fns` result when it is None;
    a tuple built for another chunk, cache type or sampling setting than
    the call's is refused."""
    if server_fns is None:
        return make_server_fns(params, cfg, family, chunk=chunk,
                               kv_int8=kv_int8, sample_cfg=sample_cfg)
    names = ("chunk", "kv_int8", "sampling settings")
    differ = [f"{n} {b} (this call: {c})" for n, b, c in
              zip(names, server_fns[3:], (chunk, kv_int8, sample_cfg))
              if b != c]
    if differ:
        raise ValueError("server_fns built for " + ", ".join(differ))
    return server_fns


class _Loop:
    """The continuous-batching scheduler that every single-process server
    runs (:func:`serve_greedy`, :func:`serve_sample`,
    :func:`serve_paged_greedy`, models/disagg.py's loopback); a disagg
    decode rank drives its pieces from its own intake loop. What a server
    does over its slot cache is its :class:`_Slots`. ``owner`` holds the
    request id per slot: -1 idle, -2 shed after a peer loss (never
    refilled until the fleet shows capacity back)."""

    def __init__(self, prompts, n_new, n_slots, eos, chunk, dev,
                 max_request_retries, admit=None, rids=None, on_token=None,
                 feed_slo=False):
        self.n_new = n_new = _normalize_requests(prompts, n_new)
        self.prompts, self.n_slots = prompts, n_slots
        self.eos, self.chunk, self.dev = eos, chunk, dev
        self.max_request_retries = max_request_retries
        self.done: List[Optional[object]] = [None] * len(prompts)
        self.slo = RollingSLO()
        # Typed admission (:func:`_admission_check`, ``admit`` its limits),
        # each request journaled as admitted or rejected. A decode rank
        # takes its requests from the prefill rank's admission.
        self.rejected: Dict[int, RequestRejected] = {}
        for rid, (p, n) in enumerate(zip(prompts, n_new) if admit else ()):
            rej = _admission_check(rid, p, n, chunk, **admit)
            if rej is not None:
                self.rejected[rid] = self.done[rid] = rej
                self.slo.note_reject(rej.reason)
                reqlog.emit("reject", rid, reason=rej.reason)
            else:
                reqlog.emit("admit", rid, prompt_len=len(p), n_new=n)
        # The requests this call serves (a disagg decode rank: its own).
        self.rids = list(range(len(prompts))) if rids is None else rids
        self.on_token = on_token
        self.queue = deque((rid, np.asarray(prompts[rid], np.int32))
                           for rid in self.rids if rid not in self.rejected)
        self.owner = [-1] * n_slots
        self.fleet = _FleetSlots(self.owner)
        self.emitted: List[List[int]] = [[] for _ in prompts]
        self.last_tok = np.zeros((n_slots,), np.int32)
        self.attempts = [0] * len(prompts)
        self.ttft: List[Optional[float]] = [None] * len(prompts)
        self.finish: List[Optional[float]] = [None] * len(prompts)
        # The rolling SLOs feed the telemetry sampler (and the paged
        # server's refill gate): kept when one is on as the call starts.
        self.feed_slo = feed_slo or _tseries_lib() is not None
        self.itl_samples: List[float] = []
        self.qd_samples: List[int] = []
        self.occ_samples: List[float] = []
        self.steps = self.prefills = self.requeues = 0
        self.peer_requeues = self.hang_dumps = 0
        self.server: Optional[_Slots] = None
        self.t0 = time.perf_counter()

    def busy(self) -> bool:
        return any(o >= 0 for o in self.owner)

    def run(self, server: "_Slots") -> ServedBatch:
        self.server = server
        for depth, (rid, _p) in enumerate(self.queue):
            reqlog.emit("queue", rid, depth=depth)
        # All requests arrive at entry, so queue wait counts toward TTFT.
        with profiling.annotate("acx.serve.call"):
            self.t0 = time.perf_counter()
            self.qd_samples.append(len(self.queue))
            self.seed_idle_slots()
            stalls = 0
            while self.busy() or self.queue:
                with profiling.annotate("acx.serve.round"):
                    stalls = self._round(stalls)
            if any(self.done[rid] is None for rid in self.rids):
                raise RuntimeError("scheduler exited with unfinished "
                                   "requests")
            batch = ServedBatch(self.done, server.metrics(self.fields()))
            server.finish(batch)
            return batch

    def _round(self, stalls: int) -> int:
        """One scheduler turn; returns the count of turns in a row that
        found every slot idle and could seat nothing."""
        self.note_gauges()
        if self.queue:
            # Capacity may have returned (a replacement rank joined):
            # revive shed slots and refill exactly those.
            for b in self.fleet.check_rejoin():
                if self.queue and self.refill(b) and self.slot_finished(b):
                    self.retire(b)
        if not self.busy():
            # All slots idle with requests queued (failure requeues, a
            # deferred seed, total preemption): reseed. The paged gate
            # never defers an empty server and admission bounds every
            # request, so a stall here is a bug: bound it instead of
            # spinning.
            stalls = 0 if self.seed_idle_slots() else stalls + 1
            if stalls > len(self.prompts) + self.n_slots + 2:
                raise RuntimeError("scheduler stalled: requests queued, no "
                                   "slot seatable")
            return stalls
        self.advance()
        return 0

    def advance(self, refill: bool = True) -> None:
        """The round after its seats: ready the slots, step them, take the
        token block and retire each finished slot, refilling it from the
        queue. A decode rank's queue is seated by its handoffs alone
        (``refill=False``): it neither refills here nor requeues after a
        failed step, since no handoff would come back for the request."""
        self.server.before_step()
        if not self.busy():
            return                  # the paged server preempted every slot
        try:
            block, step_dt = self.step()
        except Exception as exc:  # noqa: BLE001 — any device failure
            if not refill:
                raise
            # The slot cache is updated in place, so after a failed step
            # it cannot be trusted: requeue every active request (bit-equal
            # restart, bounded by max_request_retries) and have the server
            # start its cache over. Peer loss charges no victim and sheds
            # a slot (the job shrank). The flight dump records the comm
            # plane as the failure left it.
            lost_peer = _peer_dead(exc)
            if _flight_dump_best_effort():
                self.hang_dumps += 1
            for b, rid in enumerate(self.owner):
                if rid >= 0:
                    self.owner[b] = -1
                    self._requeue(rid, exc, charge=not lost_peer)
            if lost_peer:
                self.fleet.shed_one()
            self.server.reset()
            self.last_tok[:] = 0
            return
        self.consume(block, step_dt)
        for b in range(self.n_slots):
            while self.owner[b] >= 0 and self.slot_finished(b):
                self.retire(b)
                if refill and self.queue:
                    self.refill(b)

    def note_gauges(self) -> None:
        self.qd_samples.append(len(self.queue))
        self.occ_samples.append(sum(o >= 0 for o in self.owner)
                                / self.n_slots)
        if self.feed_slo:
            self.slo.note_gauges(self.qd_samples[-1], self.occ_samples[-1])
            _tseries_annotate_best_effort(self.slo)

    def refill(self, b: int) -> Optional[bool]:
        """Seat the queue head in slot b; True iff the slot now owns it. A
        failed seat requeues the request by the retry rules instead of
        killing the server (False); a seat the server defers puts it back
        at the head (None)."""
        rid, prompt = self.queue.popleft()
        with profiling.annotate("acx.serve.refill"):
            spanned = _span_app_begin_best_effort(rid)
            try:
                first = self.server.seat(b, rid, prompt)
            except Exception as exc:  # noqa: BLE001 — any device failure
                self._requeue(rid, exc, charge=not _peer_dead(exc))
                return False
            finally:
                if spanned:
                    _span_app_end_best_effort()
            if first is None:
                self.queue.appendleft((rid, prompt))
                return None
            self.take_seat(b, rid, first)
            return True

    def take_seat(self, b: int, rid: int, first: int) -> None:
        """Slot b now holds request ``rid``, whose prefill gave ``first``:
        its TTFT ends here."""
        self.owner[b] = rid
        self.emitted[rid].append(first)
        if self.on_token is not None:
            self.on_token(rid, first)
        self.last_tok[b] = first
        self.prefills += 1
        self.ttft[rid] = time.perf_counter() - self.t0
        if self.feed_slo:
            self.slo.note_ttft(self.ttft[rid])
        reqlog.emit("stream", rid, n=1, ttft_s=self.ttft[rid])

    def seed_idle_slots(self, refill=None) -> bool:
        """Seat queued requests in idle slots, each by ``refill`` (a decode
        rank's: its next handoff) or :meth:`refill`; True iff any was
        seated. 1-token requests retire on the spot, so a slot never enters
        the decode loop already finished. A deferred seat ends the pass."""
        progressed = False
        while self.queue and -1 in self.owner:
            b = self.owner.index(-1)
            seated = (refill or self.refill)(b)
            if seated is None:
                break
            if seated:
                progressed = True
                if self.slot_finished(b):
                    self.retire(b)
        return progressed

    def slot_finished(self, b: int) -> bool:
        emitted = self.emitted[self.owner[b]]
        return (len(emitted) >= self.n_new[self.owner[b]]
                or (self.eos is not None and emitted
                    and emitted[-1] == self.eos))

    def retire(self, b: int) -> None:
        rid = self.owner[b]
        self.done[rid] = np.concatenate(
            [np.asarray(self.prompts[rid], np.int32),
             np.asarray(self.emitted[rid], np.int32)])
        self.finish[rid] = time.perf_counter() - self.t0
        reqlog.emit("finish", rid, new_tokens=len(self.emitted[rid]),
                    latency_s=self.finish[rid])
        self.owner[b] = -1
        self.server.release(b)

    def restart(self, rid: int) -> None:
        """Back on the queue with its tokens dropped: the next seat replays
        the request from its prompt."""
        self.emitted[rid] = []
        self.ttft[rid] = None
        self.queue.append((rid, np.asarray(self.prompts[rid], np.int32)))

    def _requeue(self, rid: int, exc: BaseException, charge=True) -> None:
        """Put a failed request back on the queue for a restart, or
        re-raise past the retry budget. ``charge=False`` (peer loss)
        leaves the budget alone."""
        if charge:
            self.attempts[rid] += 1
            if self.attempts[rid] > self.max_request_retries:
                raise RuntimeError(
                    f"request {rid} failed {self.attempts[rid]} time(s), "
                    f"past max_request_retries={self.max_request_retries}"
                ) from exc
        else:
            self.peer_requeues += 1
        self.requeues += 1
        reqlog.emit("requeue", rid, charged=bool(charge))
        self.restart(rid)

    def step(self):
        """One step of every slot from its last token: ``(block, dt)``, the
        ``[chunk, B]`` tokens read back and the seconds it took."""
        step_t0 = time.perf_counter()
        with profiling.annotate("acx.serve.issue"):
            toks = self.server.issue(
                torch.from_numpy(self.last_tok).to(self.dev))
        with profiling.annotate("acx.serve.wait"):
            block = toks.cpu().numpy()       # [chunk, B]; syncs
        # The copy to the host waited for the device, so this dt covers
        # the device step; the chunk's tokens share it evenly.
        step_dt = time.perf_counter() - step_t0
        self.steps += 1
        reqlog.emit("decode_step", step=self.steps, dt_s=step_dt,
                    active=sum(o >= 0 for o in self.owner))
        return block, step_dt

    def consume(self, block, step_dt: float) -> None:
        """Take a step's token block: each owned slot's tokens up to its
        finish (a slot that finishes mid-chunk idles; its further tokens
        are dropped), each with an inter-token sample."""
        itl = step_dt / self.chunk
        finished, on_token = self.slot_finished, self.on_token
        for b in range(self.n_slots):
            self.last_tok[b] = block[-1, b]
            rid = self.owner[b]
            if rid < 0:
                continue
            got = 0
            for c in range(block.shape[0]):
                if finished(b):
                    break
                tok = int(block[c, b])
                self.emitted[rid].append(tok)
                if on_token is not None:
                    on_token(rid, tok)
                self.itl_samples.append(itl)
                if self.feed_slo:
                    self.slo.note_itl(itl)
                got += 1
            if got:
                reqlog.emit("stream", rid, n=got, itl_s=itl)

    def fields(self) -> dict:
        wall = time.perf_counter() - self.t0
        per_request = []
        for rid in self.rids:
            if rid in self.rejected:
                continue
            nt = len(self.emitted[rid])
            lat = self.finish[rid] if self.finish[rid] is not None else wall
            per_request.append(RequestTelemetry(
                rid=rid,
                ttft_s=self.ttft[rid] if self.ttft[rid] is not None else lat,
                latency_s=lat,
                new_tokens=nt,
                tokens_per_s=nt / lat if lat > 0 else 0.0,
                retries=self.attempts[rid]))
        total_new = sum(r.new_tokens for r in per_request)
        qd, occ = self.qd_samples, self.occ_samples
        return dict(
            requests=len(self.rids),
            wall_s=wall,
            new_tokens=total_new,
            tokens_per_s=total_new / wall if wall > 0 else 0.0,
            steps=self.steps,
            prefills=self.prefills,
            requeues=self.requeues,
            peer_requeues=self.peer_requeues,
            slots_shed=self.fleet.shed,
            slots_revived=self.fleet.revived,
            hang_dumps=self.hang_dumps,
            rejections=len(self.rejected),
            rejection_reasons=_count_reasons(self.rejected.values()),
            ttft_p50_s=_pct([r.ttft_s for r in per_request], 0.50),
            ttft_p99_s=_pct([r.ttft_s for r in per_request], 0.99),
            itl_p50_s=_pct(self.itl_samples, 0.50),
            itl_p99_s=_pct(self.itl_samples, 0.99),
            queue_depth_max=max(qd) if qd else 0,
            queue_depth_mean=sum(qd) / len(qd) if qd else 0.0,
            slot_occupancy_mean=sum(occ) / len(occ) if occ else 1.0,
            per_request=per_request)


class _Slots:
    """A server's slot cache as :class:`_Loop` drives it. Subclasses give
    ``seat(b, rid, prompt)``: request ``rid`` prefilled into slot ``b``,
    returning its first token, or None to defer it (it goes back to the
    queue's head), or raising with its own partial state undone (the loop
    requeues it); ``issue(tok)``: one step of every slot from ``tok`` [B],
    returning the ``[chunk, B]`` tokens on the device; ``release(b)``:
    park a freed slot; ``reset()``: start the cache over after a failed
    step."""

    def before_step(self) -> None:
        """Ready every owned slot for the step's writes."""

    def metrics(self, fields: dict) -> ServingMetrics:
        return ServingMetrics(**fields)

    def finish(self, batch: ServedBatch) -> None:
        """The call served every request; ``batch`` is its result."""


class _FixedSlots(_Slots):
    """Fixed slots: one row of the slot cache a slot. A :class:`ServerFns`
    prefill writes a prompt's rows straight into its slot (``seat=``) and
    reuses the result's own cache; a plain tuple's (as
    ``make_tp_server_fns`` returns) gives a cache that ``scatter_fn``
    lands there. Sampling gives each seated request its generator."""

    def __init__(self, loop: _Loop, server_fns, family, cfg, max_len,
                 kv_int8, sample_cfg=None, key=None):
        self.prefill_fn, self.step_fn, self.scatter_fn = server_fns[:3]
        self.seated = isinstance(server_fns, ServerFns)
        self.owned = getattr(server_fns, "slots", None)
        self.family, self.cfg, self.kv_int8 = family, cfg, kv_int8
        self.n_slots, self.max_len, self.dev = loop.n_slots, max_len, loop.dev
        self.sample_cfg, self.key = sample_cfg, key
        self.slots = self.fresh()
        self.counter_log = ([self.slots["counts"].clone()]
                            if "counts" in self.slots else None)
        # Each seated request's generator (sampling); None for an idle slot.
        self.keys: List[Optional[torch.Generator]] = [None] * self.n_slots

    def fresh(self, rebuild=False):
        """The slot cache, ``pos`` at 0: the result's own, its captures
        dropped on ``rebuild`` (after a failed step), else a new one."""
        owned = self.owned or OwnedSlots(self.family, self.cfg, self.kv_int8)
        return owned.seat(self.n_slots, self.max_len, self.dev, rebuild)

    def seat(self, b, rid, prompt):
        slots, S = self.slots, len(prompt)
        padded = _padded(prompt, self.max_len, self.cfg.max_seq)
        reqlog.emit("prefill_start", rid, prompt_len=S,
                    bucket=padded.shape[1])
        try:
            tokens = torch.from_numpy(padded).to(self.dev)
            if self.seated:         # the pass writes its rows into slot b
                logits, one = self.prefill_fn(tokens, S - 1, seat=(slots, b))
                if one is not slots:
                    raise TypeError("a seated prefill returned another "
                                    "cache than the slot cache")
            else:
                logits, one = self.prefill_fn(tokens, S - 1)
            with profiling.annotate("acx.serve.first_token"):
                if self.sample_cfg is None:
                    first = int(logits[0, 0].argmax())
                else:
                    self.keys[b] = key_generator(fold_in(self.key, rid),
                                                 self.dev)
                    first = int(sample_logits(
                        logits[0, 0][None].float(), self.keys[b],
                        *self.sample_cfg)[0])
            if self.seated:
                slots["pos"][b] = S
            else:
                self.slots = self.scatter_fn(slots, one, b, S)
        except Exception:
            # A failed pass may have left a capture half made.
            if isinstance(self.slots, SlotCache):
                self.slots.drop_captures()
            raise
        reqlog.emit("prefill_end", rid, first_token=first)
        reqlog.emit("seat", rid, slot=b, pos=S)
        return first

    def issue(self, tok):
        self.slots, toks = self.step_fn(self.slots, tok, self.keys)
        if self.counter_log is not None:
            self.counter_log.append(self.slots["counts"].clone())
        return toks

    def release(self, b):
        self.keys[b] = None
        # Park the freed slot at pos 0: an idle slot keeps stepping in the
        # batch, and a stale pos would walk toward max_len.
        self.slots["pos"][b] = 0

    def reset(self):
        self.slots = self.fresh(rebuild=True)
        self.keys = [None] * self.n_slots

    def finish(self, batch):
        if self.counter_log is not None:
            batch.round_counters = torch.stack(self.counter_log).tolist()


def _serve(params, cfg, prompts, n_new, n_slots, max_len, family, eos,
           chunk, server_fns, kv_int8, sample_cfg, key, device,
           max_request_retries=2):
    """serve_greedy and serve_sample over fixed slots. Sampling changes
    only how a token is picked (the step's ``pick``, the refill's first
    draw) and gives each seated request its generator, seeded anew when a
    failure requeues it, so the restart replays the same path."""
    family, dev = _family_on(family, params, device)
    loop = _Loop(prompts, n_new, n_slots, eos, chunk, dev,
                 max_request_retries,
                 dict(max_len=max_len, max_seq=cfg.max_seq))
    server_fns = _server_fns(server_fns, params, cfg, family, chunk,
                             kv_int8, sample_cfg)
    return loop.run(_FixedSlots(loop, server_fns, family, cfg, max_len,
                                kv_int8, sample_cfg, key))


def serve_greedy(params, cfg, prompts: Sequence[np.ndarray], n_new,
                 n_slots: int, max_len: int, family=None,
                 eos: Optional[int] = None, chunk: int = 1,
                 server_fns=None, kv_int8: bool = False,
                 max_request_retries: int = 2, device=None) -> ServedBatch:
    """Serve ``prompts`` (1-D int arrays, any lengths) through ``n_slots``
    continuously-batched cache slots on ``device`` (``None`` means the GPU;
    the parameters must already be there). Each request decodes greedily
    for ``n_new`` tokens (an int, or one per request) or until ``eos``.
    ``family`` is the model module (``None`` means models.transformer;
    models.llama, models.moe_transformer and models.deepseek_v2 serve
    their families; keep an
    MoE config's ``capacity_factor >= n_experts``, or a decode step may
    drop a token its solo run seats). Returns, per request, ``prompt +
    generated`` as a numpy array — equal to that request's solo
    ``family.generate`` run — or a
    :class:`RequestRejected` for a request that cannot fit. ``chunk``
    trades scheduling granularity for fewer host round trips; outputs are
    identical for any chunk. ``server_fns`` (a :func:`make_server_fns`
    result for the same params/cfg/family/chunk) may be reused across
    calls, one call at a time: the calls then share its slot cache and
    the decode step captured over it. ``kv_int8`` serves from int8 slot
    caches (ops/kvquant.py); outputs then equal the solo ``generate(...,
    kv_int8=True)`` runs.
    ``max_request_retries`` bounds per-request restarts after a failed
    prefill or step.

    The result is a ``ServedBatch``: a list of outputs carrying
    ``.metrics`` (per-request TTFT and tokens/s, inter-token latency
    percentiles, queue depth, slot occupancy, requeues)."""
    return _serve(params, cfg, prompts, n_new, n_slots, max_len, family,
                  eos, chunk, server_fns, kv_int8, None, None, device,
                  max_request_retries=max_request_retries)


def serve_sample(params, cfg, prompts: Sequence[np.ndarray], n_new,
                 n_slots: int, max_len: int, key: int, family=None,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, eos: Optional[int] = None,
                 chunk: int = 1, server_fns=None, kv_int8: bool = False,
                 max_request_retries: int = 2, device=None) -> ServedBatch:
    """Stochastic continuous batching (temperature / top-k / top-p).

    ``key`` is an integer (the JAX function's PRNG key). Request ``rid``
    draws from its own generator on ``device``, seeded
    ``decoding.fold_in(key, rid)``: its first token at refill, one more at
    each step, in the order of the solo run. So each output equals the solo
    ``family.generate_sample(params, cfg, prompt[None], n, key=
    decoding.key_generator(decoding.fold_in(key, rid), device), ...)`` run
    (up to floating-point ties between its batched and solo logits), and
    the scheduler (slots, refill order, chunk) cannot perturb any
    request's sample path. ``temperature=0`` is the argmax. Everything
    else (parameters, the ``ServedBatch`` and its telemetry) as
    :func:`serve_greedy`."""
    return _serve(params, cfg, prompts, n_new, n_slots, max_len, family,
                  eos, chunk, server_fns, kv_int8, (temperature, top_k, top_p),
                  operator.index(key), device,
                  max_request_retries=max_request_retries)


def _slo_admit_targets(slo_admit) -> tuple:
    """The SLO admission gate's targets: ``slo_admit`` is (ttft_s, itl_s)
    rolling-p50 targets (either may be None), or None to read the JAX
    package's ``ACX_SERVE_ADMIT_TTFT_MS`` / ``ACX_SERVE_ADMIT_ITL_MS``
    knobs (unset or 0: gate off, the default, which keeps paged schedules
    those of the fixed-slot server)."""
    if slo_admit is not None:
        ttft_t, itl_t = slo_admit
        return (float(ttft_t) if ttft_t else None,
                float(itl_t) if itl_t else None)
    ttft_ms = float(os.environ.get("ACX_SERVE_ADMIT_TTFT_MS", "0") or 0)
    itl_ms = float(os.environ.get("ACX_SERVE_ADMIT_ITL_MS", "0") or 0)
    return (ttft_ms / 1e3 if ttft_ms > 0 else None,
            itl_ms / 1e3 if itl_ms > 0 else None)


class _PagedSlots(_Slots):
    """Paged slots (models/kvpage.py): the slots share a pool of pages
    through block tables. Its own policies: the SLO refill gate, radix
    prefix hits, lazy page growth with preemption of the latest arrival
    and the copy-on-write guard (page-budget admission is at the call's
    entry)."""

    def __init__(self, loop: _Loop, params, cfg, family, max_len, kv_int8,
                 page_tokens, n_pages, prefix_cache, slo_targets=(None, None)):
        self.loop, self.params, self.cfg, self.family = (loop, params, cfg,
                                                         family)
        self.max_len, self.pt, self.kv_int8 = max_len, page_tokens, kv_int8
        self.chunk, self.dev = loop.chunk, loop.dev
        self.ttft_target, self.itl_target = slo_targets
        self.pkv = kvpage.PagedKV(cfg, family, loop.n_slots, max_len,
                                  page_tokens, n_pages, kv_int8=kv_int8,
                                  prefix_cache=prefix_cache, device=loop.dev)
        self.step_fn = kvpage.make_paged_step_fn(params, cfg, family,
                                                 loop.chunk, page_tokens)
        # Requests evicted by page pressure: their next seat is a "resume".
        self.preempted: set = set()
        self.slo_deferrals = 0

    def _slo_defers(self) -> bool:
        """With a target set, a violating rolling window defers refills
        while work is in flight (an empty server always admits)."""
        if self.ttft_target is None and self.itl_target is None:
            return False
        if not self.loop.busy():
            return False
        live = self.loop.slo.live_slos()
        if (self.itl_target is not None and live["itl_n"]
                and live["itl_p50_s"] > self.itl_target):
            return True
        return bool(self.ttft_target is not None and live["ttft_n"]
                    and live["ttft_p50_s"] > self.ttft_target)

    def _prefill(self, prompt, S, hit_pages):
        """(logits, the prompt's cache rows to scatter): the whole prompt
        cold, or on a prefix hit only the suffix against the cached pages'
        gathered history."""
        cfg = self.cfg
        if not hit_pages:
            tokens = torch.from_numpy(
                _padded(prompt, self.max_len, cfg.max_seq)).to(self.dev)
            return self.family.prefill(
                self.params, cfg, tokens, tokens.shape[1],
                kv_int8=self.kv_int8, last_index=S - 1)
        P = len(hit_pages) * self.pt
        suffix = prompt[P:]
        padded = _padded(suffix, self.max_len - P, cfg.max_seq - P)
        hk, hv = self.pkv.gather_history(hit_pages)
        logits, sk, sv = kvpage.prefill_with_history(
            self.params, cfg, torch.from_numpy(padded).to(self.dev), hk, hv,
            len(suffix) - 1)
        one = {"k": sk, "v": sv}
        if self.kv_int8:
            one["k"], one["ks"] = kv_quant(sk)
            one["v"], one["vs"] = kv_quant(sv)
        return logits, one

    def seat(self, b, rid, prompt):
        """Deferred while the SLO gate holds or the pool cannot cover the
        prompt (the request keeps the queue's head)."""
        pkv = self.pkv
        if self._slo_defers():
            self.slo_deferrals += 1
            return None
        S = len(prompt)
        hit_pages = (pkv.prefix.match(prompt) if pkv.prefix is not None
                     else [])
        if hit_pages:
            reqlog.emit("prefix_hit", rid, pages=len(hit_pages))
        fresh = pkv.alloc_evicting(kvpage.pages_needed(S, self.pt)
                                   - len(hit_pages))
        if fresh is None:
            # Page pressure at admission: back to the head (arrival order
            # kept), the match's references released; a retire frees pages.
            for p in hit_pages:
                pkv.alloc.decref(p)
            return None
        reqlog.emit("prefill_start", rid, prompt_len=S,
                    hit_pages=len(hit_pages), fresh_pages=len(fresh))
        try:
            logits, one = self._prefill(prompt, S, hit_pages)
            with profiling.annotate("acx.serve.first_token"):
                first = int(logits[0, 0].argmax())
        except Exception:
            for p in hit_pages + fresh:
                pkv.alloc.decref(p)
            raise
        reqlog.emit("prefill_end", rid, first_token=first)
        self._place(b, rid, one, S, hit_pages, fresh)
        if pkv.prefix is not None:
            pkv.prefix.insert(prompt, pkv.pages[b])
        if rid in self.preempted:
            self.preempted.discard(rid)
            self.loop.slo.note_resume()
            reqlog.emit("resume", rid, slot=b)
        return first

    def land(self, b, rid, one, S):
        """Seat a handoff's rows (on the device) in slot ``b``, in fresh
        pages that reserve the request's whole budget (prompt + n_new +
        chunk), so that a later arrival cannot starve it."""
        need = kvpage.pages_needed(S + self.loop.n_new[rid] + self.chunk,
                                   self.pt)
        pages = self.pkv.alloc_evicting(need)
        if pages is None:
            raise RuntimeError(
                f"page pool dry seating rid={rid} (need {need} pages, "
                f"{self.pkv.alloc.free_count} free): size n_pages to "
                "n_slots*max_len/page_tokens")
        self._place(b, rid, one, S, [], pages,
                    kvpage.pages_needed(S, self.pt))

    def _place(self, b, rid, one, S, hit_pages, pages, n_rows=None):
        """Scatter the prompt's rows ``one`` into the first ``n_rows`` of
        ``pages`` (all by default) and give slot b ``hit_pages + pages``
        at position S; a failure drops their references."""
        try:
            self.pkv.scatter_prompt(one, pages[:n_rows])
            self.pkv.seat(b, hit_pages, pages, S, rid=rid)
        except Exception:
            for p in hit_pages + pages:
                self.pkv.alloc.decref(p)
            raise

    def _preempt(self, b):
        """Page-pressure eviction: slot b's request requeues uncharged
        (pressure is the server's doing, not the request's) with its pages
        freed; the replay gives the same tokens."""
        loop = self.loop
        rid = loop.owner[b]
        loop.owner[b] = -1
        self.pkv.release(b)
        loop.restart(rid)
        self.pkv.preemptions += 1
        self.preempted.add(rid)
        loop.slo.note_preempt()
        reqlog.emit("preempt", rid, slot=b)

    def _publish(self):
        pkv = self.pkv
        kvpage.publish_page_stats_best_effort(
            pkv.alloc.free_count, pkv.alloc.shared_count(),
            pkv.prefix.hits if pkv.prefix else 0,
            pkv.prefix.evictions if pkv.prefix else 0, pkv.preemptions)

    def before_step(self):
        """Publish the pool's stats; then every active slot's table must
        cover the chunk's writes (positions pos..pos+chunk-1) with pages
        of its own. A pool dry even after trie eviction preempts the
        latest arrival and rescans; admission guarantees a lone request
        fits, so this ends."""
        pkv, owner, pt = self.pkv, self.loop.owner, self.pt
        self._publish()
        while True:
            for b, rid in enumerate(owner):
                if rid < 0:
                    continue
                if not pkv.grow(b, (int(pkv.pos[b]) + self.chunk - 1) // pt
                                + 1):
                    victims = [s for s, o in enumerate(owner) if o >= 0]
                    if len(victims) <= 1:
                        raise RuntimeError(
                            "page pool dry for a lone request (admission "
                            "should have rejected it)")
                    self._preempt(max(victims, key=lambda s: owner[s]))
                    break
            else:
                break
        # Copy-on-write guard (unreachable under the radix policy): the
        # pages this chunk writes must be privately owned.
        for b, rid in enumerate(owner):
            if rid < 0:
                continue
            for j in range(int(pkv.pos[b]) // pt,
                           (int(pkv.pos[b]) + self.chunk - 1) // pt + 1):
                if j < len(pkv.pages[b]):
                    pkv.ensure_writable(b, j)

    def issue(self, tok):
        state, toks = self.step_fn(self.pkv.device_state(), tok)
        self.pkv.absorb(state, self.chunk)
        return toks

    def release(self, b):
        self.pkv.release(b)         # pages back to the pool, slot parked

    def reset(self):
        # The prefix cache's pages lived in the pool too.
        self.pkv.reset_pool()

    def metrics(self, fields):
        pkv, prefix = self.pkv, self.pkv.prefix
        return ServingMetrics(
            **fields, preemptions=pkv.preemptions,
            prefix_hits=prefix.hits if prefix else 0,
            prefix_evictions=prefix.evictions if prefix else 0,
            prefix_pages_reused=prefix.pages_reused if prefix else 0,
            pages_hwm=pkv.pages_hwm, slo_deferrals=self.slo_deferrals)

    def finish(self, batch):
        self._publish()


def serve_paged_greedy(params, cfg, prompts: Sequence[np.ndarray], n_new,
                       n_slots: int, max_len: int, family=None,
                       eos: Optional[int] = None, chunk: int = 1,
                       kv_int8: bool = False,
                       page_tokens: Optional[int] = None,
                       n_pages: Optional[int] = None,
                       prefix_cache: bool = False,
                       slo_admit=None,
                       on_token=None,
                       max_request_retries: int = 2,
                       return_paged_state: bool = False,
                       device=None) -> ServedBatch:
    """Greedy continuous batching over a paged KV cache (models/kvpage.py)
    on ``device`` (``None`` means the GPU; the parameters must already be
    there): the slots share a pool of ``page_tokens``-sized pages through
    per-slot block tables, so the KV bytes held scale with live tokens,
    not ``n_slots * max_len``. On the schedules of the defaults (no prefix
    cache, no SLO gate, enough pages) the outputs equal fixed-slot
    :func:`serve_greedy`'s token for token, bf16/f32 and int8 alike.

    Beyond the fixed-slot server:

    * **Typed admission**: a request that cannot fit ``max_len``,
      ``cfg.max_seq`` or the page budget becomes a :class:`RequestRejected`.
    * **Lazy page growth and preemption**: a slot owns only the pages its
      live tokens need, grown at chunk boundaries; when the pool runs dry
      the latest arrival (highest request id) is preempted: its pages are
      freed and it requeues uncharged, replaying the same tokens when
      reseated.
    * **Radix prefix sharing** (``prefix_cache=True``): full-page prompt
      prefixes are cached in a refcounted trie; a hit seats the shared
      pages and prefills only the suffix. A hit's outputs are deterministic
      but not pinned to the cold path's (other shapes), hence opt-in.
    * **SLO-aware refill**: ``slo_admit=(ttft_s, itl_s)`` (or the
      ``ACX_SERVE_ADMIT_*_MS`` knobs) defers refills while the rolling p50
      misses a target and a request is in flight.
    * **Streaming**: ``on_token(rid, token)`` fires for every token as it
      is consumed, the prefill's first token included; a preempted or
      requeued request replays its stream from the start.

    ``page_tokens`` defaults to ``kvpage.default_page_tokens(max_len)``;
    ``n_pages`` to ``n_slots * max_len / page_tokens`` (the fixed-slot
    cache's capacity). The metrics carry the paged counters (preemptions,
    prefix_hits, prefix_evictions, prefix_pages_reused, pages_hwm,
    slo_deferrals); ``return_paged_state=True`` exposes the
    :class:`~mpi_acx_torch.models.kvpage.PagedKV` as ``.paged_state``."""
    family, dev = _family_on(family, params, device)
    if getattr(family, "LATENT_CACHE", False):
        raise ValueError(f"serve_paged_greedy: {family.__name__} keeps a "
                         f"latent cache, which is not served from pages")
    pt = page_tokens or kvpage.default_page_tokens(max_len)
    if n_pages is None:
        n_pages = n_slots * (max_len // pt)
    targets = _slo_admit_targets(slo_admit)
    loop = _Loop(prompts, n_new, n_slots, eos, chunk, dev,
                 max_request_retries,
                 dict(max_len=max_len, max_seq=cfg.max_seq,
                      page_budget=n_pages, page_tokens=pt),
                 on_token=on_token, feed_slo=targets != (None, None))
    server = _PagedSlots(loop, params, cfg, family, max_len, kv_int8, pt,
                         n_pages, prefix_cache, targets)
    batch = loop.run(server)
    if return_paged_state:
        batch.paged_state = server.pkv
    return batch
