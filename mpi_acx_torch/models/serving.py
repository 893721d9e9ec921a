"""Continuous-batching serving loop (single device): the fixed-slot and
paged servers of the JAX package's ``models/serving.py``.

B cache slots decode in lockstep as one batched step while a host-side
scheduler swaps finished requests out and queued prompts in mid-stream,
so the device never waits for the slowest request. The mechanism is
per-slot positions: each slot's fresh K/V lands at its own ``pos[b]`` and
decode attention masks each slot at ``cols <= pos[b]``, so every slot's
math is its solo run's and greedy outputs equal per-request
``generate()``. Prompts are right-padded to a power-of-two bucket; pad
rows are never attended (they sit past ``pos[b]`` until decode overwrites
them).

Slot caches are bf16/f32 or int8 (``kv_int8``, ops/kvquant.py).
:func:`serve_sample` samples (temperature / top-k / top-p) where
:func:`serve_greedy` takes the argmax: request ``rid`` draws from its own
generator, seeded ``decoding.fold_in(key, rid)``, so its tokens equal its
solo ``generate_sample`` run's whatever the schedule.
:func:`serve_paged_greedy` serves the same way over a paged KV cache
(models/kvpage.py): slots share a pool of fixed-size pages through block
tables, with typed admission against the page budget, lazy page growth and
preemption, radix prefix sharing, an SLO admission gate and per-token
streaming.

Both servers report to the native runtime (``mpi_acx_torch.runtime``) as
the JAX package's do, and only when the binding has already loaded the
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
from mpi_acx_torch.models.decoding import (filter_logits, fold_in, gumbel,
                                           key_generator, sample_logits)
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
    generated`` arrays carrying the batch telemetry as ``.metrics``."""

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


def make_server_fns(params, cfg, family, chunk: int = 1,
                    kv_int8: bool = False, sample_cfg=None):
    """The serve loop's closures: returns (prefill_fn, step_fn, scatter_fn,
    chunk, kv_int8, sample_cfg); the trailing values let the serve call
    refuse a tuple built for another chunk, cache type or sampling
    setting. ``family`` is the model module (models.transformer,
    models.llama or models.moe_transformer, or any module exposing
    prefill/decode_step/init_kv_cache with the shared cache layout: [L, B,
    max_len, heads, Dh] per key, where Llama's heads are its KV groups).

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

    def prefill_fn(tokens, last):
        """[1, S_bucket], real last index -> (logits [1, 1, vocab],
        cache); the unembedding runs on the real prompt's final row."""
        return family.prefill(params, cfg, tokens, tokens.shape[1],
                              kv_int8=kv_int8, last_index=last)

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

    return prefill_fn, step_fn, scatter_fn, chunk, kv_int8, sample_cfg


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


def _serve(params, cfg, prompts, n_new, n_slots, max_len, family, eos,
           chunk, server_fns, kv_int8, sample_cfg, key, dev,
           max_request_retries=2):
    """The scheduler shared by serve_greedy and serve_sample: queue, slot
    ownership, chunk-block consumption, retire/refill. Sampling changes
    only how a token is picked (the step's ``pick``, the refill's first
    draw) and gives each seated request its generator. A request whose
    prefill or step raised is re-queued from scratch (emitted tokens
    discarded and its generator seeded anew, so the restart replays the
    same path) up to ``max_request_retries`` times before the failure is
    re-raised with the request id attached."""
    n_new = _normalize_requests(prompts, n_new)

    rejected: Dict[int, RequestRejected] = {}
    for rid, (p, n) in enumerate(zip(prompts, n_new)):
        rej = _admission_check(rid, p, n, chunk, max_len, cfg.max_seq)
        if rej is not None:
            rejected[rid] = rej
            reqlog.emit("reject", rid, reason=rej.reason)
        else:
            reqlog.emit("admit", rid, prompt_len=len(p), n_new=n)

    if server_fns is None:
        server_fns = make_server_fns(params, cfg, family, chunk=chunk,
                                     kv_int8=kv_int8, sample_cfg=sample_cfg)
    (prefill_fn, step_fn, scatter_fn, fns_chunk, fns_int8,
     fns_sample) = server_fns
    if fns_chunk != chunk:
        raise ValueError(f"server_fns built for chunk={fns_chunk}, this call "
                         f"uses chunk={chunk}")
    if fns_int8 != kv_int8:
        raise ValueError("server_fns built with a different kv_int8 than "
                         "this call")
    if fns_sample != sample_cfg:
        raise ValueError(f"server_fns built for different sampling settings "
                         f"({fns_sample} vs {sample_cfg})")

    def fresh_slots():
        s = family.init_kv_cache(cfg, n_slots, max_len, kv_int8=kv_int8,
                                 device=dev)
        s["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return s

    slots = fresh_slots()
    queue = deque((rid, np.asarray(p, np.int32))
                  for rid, p in enumerate(prompts) if rid not in rejected)
    for depth, (rid, _p) in enumerate(queue):
        reqlog.emit("queue", rid, depth=depth)
    # Request id per slot; -1 = idle, -2 = shed after a peer loss (never
    # refilled until the fleet shows capacity back).
    owner = [-1] * n_slots
    fleet = _FleetSlots(owner)
    emitted: List[List[int]] = [[] for _ in prompts]
    done: List[Optional[object]] = [None] * len(prompts)
    for rid, rej in rejected.items():
        done[rid] = rej
    last_tok = np.zeros((n_slots,), np.int32)
    # Each seated request's generator (sampling); None for an idle slot.
    keys: List[Optional[torch.Generator]] = [None] * n_slots
    attempts = [0] * len(prompts)

    ttft = [None] * len(prompts)      # type: List[Optional[float]]
    finish = [None] * len(prompts)    # type: List[Optional[float]]
    slo = RollingSLO()
    for rej in rejected.values():
        slo.note_reject(rej.reason)
    # The rolling SLOs feed only the telemetry sampler: kept when it is
    # armed as the call starts.
    feed_slo = _tseries_lib() is not None
    itl_samples: List[float] = []
    qd_samples: List[int] = []
    occ_samples: List[float] = []
    n_steps = n_prefills = n_requeues = n_peer_requeues = n_hang_dumps = 0

    def _requeue(rid, prompt, exc, charge=True):
        """Put a failed request back on the queue for a restart, or
        re-raise past the retry budget. ``charge=False`` (peer loss)
        leaves the budget alone."""
        nonlocal n_requeues, n_peer_requeues
        if charge:
            attempts[rid] += 1
            if attempts[rid] > max_request_retries:
                raise RuntimeError(
                    f"request {rid} failed {attempts[rid]} time(s), past "
                    f"max_request_retries={max_request_retries}") from exc
        else:
            n_peer_requeues += 1
        emitted[rid] = []
        ttft[rid] = None
        n_requeues += 1
        reqlog.emit("requeue", rid, charged=bool(charge))
        queue.append((rid, prompt))

    def refill(b):
        """Returns True iff slot b now owns a request; a failed prefill
        re-queues the request instead of killing the server."""
        nonlocal slots, n_prefills
        rid, prompt = queue.popleft()
        with profiling.annotate("acx.serve.refill"):
            S = len(prompt)
            # Bucket capped at max_len (the scatter must fit the slot) and
            # at the model's position ceiling.
            padded = np.zeros((1, min(_bucket(S), max_len, cfg.max_seq)),
                              np.int32)
            padded[0, :S] = prompt
            spanned = _span_app_begin_best_effort(rid)
            reqlog.emit("prefill_start", rid, prompt_len=S,
                        bucket=padded.shape[1])
            try:
                logits, one = prefill_fn(torch.from_numpy(padded).to(dev),
                                         S - 1)
                with profiling.annotate("acx.serve.first_token"):
                    if sample_cfg is None:
                        first = int(logits[0, 0].argmax())
                    else:
                        keys[b] = key_generator(fold_in(key, rid), dev)
                        first = int(sample_logits(
                            logits[0, 0][None].float(), keys[b],
                            *sample_cfg)[0])
                slots = scatter_fn(slots, one, b, S)
            except Exception as exc:  # noqa: BLE001 — any device failure
                _requeue(rid, prompt, exc, charge=not _peer_dead(exc))
                return False
            finally:
                if spanned:
                    _span_app_end_best_effort()
            owner[b] = rid
            emitted[rid].append(first)
            last_tok[b] = first
            n_prefills += 1
            reqlog.emit("prefill_end", rid, first_token=first)
            reqlog.emit("seat", rid, slot=b, pos=S)
            ttft[rid] = time.perf_counter() - t0
            if feed_slo:
                slo.note_ttft(ttft[rid])
            reqlog.emit("stream", rid, n=1, ttft_s=ttft[rid])
            return True

    def retire(b):
        rid = owner[b]
        done[rid] = np.concatenate(
            [np.asarray(prompts[rid], np.int32),
             np.asarray(emitted[rid], np.int32)])
        finish[rid] = time.perf_counter() - t0
        reqlog.emit("finish", rid, new_tokens=len(emitted[rid]),
                    latency_s=finish[rid])
        owner[b] = -1
        keys[b] = None
        # Park the freed slot at pos 0: an idle slot keeps stepping in the
        # batch, and a stale pos would walk toward max_len.
        slots["pos"][b] = 0

    def slot_finished(b):
        rid = owner[b]
        return (len(emitted[rid]) >= n_new[rid]
                or (eos is not None and emitted[rid]
                    and emitted[rid][-1] == eos))

    def seed_idle_slots():
        # Retire 1-token requests on the spot so a slot never enters the
        # decode loop already finished.
        while queue and any(o == -1 for o in owner):
            b = owner.index(-1)
            if refill(b) and slot_finished(b):
                retire(b)

    # All requests arrive at entry, so queue wait counts toward TTFT.
    with profiling.annotate("acx.serve.call"):
        t0 = time.perf_counter()
        qd_samples.append(len(queue))
        seed_idle_slots()
        while any(o >= 0 for o in owner) or queue:
            with profiling.annotate("acx.serve.round"):
                qd_samples.append(len(queue))
                occ_samples.append(sum(o >= 0 for o in owner) / n_slots)
                if feed_slo:
                    slo.note_gauges(qd_samples[-1], occ_samples[-1])
                    _tseries_annotate_best_effort(slo)
                if queue:
                    # Capacity may have returned (a replacement rank joined):
                    # revive shed slots and refill exactly those.
                    for b in fleet.check_rejoin():
                        if queue and refill(b) and slot_finished(b):
                            retire(b)
                if not any(o >= 0 for o in owner):
                    # All slots idle with requests queued: only reachable
                    # after a failure re-queued them — reseed and keep
                    # serving.
                    seed_idle_slots()
                    continue
                step_t0 = time.perf_counter()
                try:
                    with profiling.annotate("acx.serve.issue"):
                        slots, toks = step_fn(
                            slots, torch.from_numpy(last_tok).to(dev), keys)
                    with profiling.annotate("acx.serve.wait"):
                        block = toks.cpu().numpy()   # [chunk, B]; syncs
                except Exception as exc:  # noqa: BLE001 — any device failure
                    # The slot cache is updated in place, so after a failed
                    # step it cannot be trusted: re-queue every active
                    # request (bit-equal restart, bounded by
                    # max_request_retries) and rebuild it. Peer loss charges
                    # no victim and sheds a slot (the job shrank).
                    lost_peer = _peer_dead(exc)
                    # The flight dump records the comm plane as the
                    # failure left it.
                    if _flight_dump_best_effort():
                        n_hang_dumps += 1
                    for b in range(n_slots):
                        if owner[b] >= 0:
                            rid = owner[b]
                            owner[b] = -1
                            _requeue(rid, np.asarray(prompts[rid], np.int32),
                                     exc, charge=not lost_peer)
                    if lost_peer:
                        fleet.shed_one()
                    slots = fresh_slots()
                    keys = [None] * n_slots
                    last_tok = np.zeros((n_slots,), np.int32)
                    continue
                # The copy to the host waited for the device, so this dt
                # covers the device step; the chunk's tokens share it
                # evenly.
                step_dt = time.perf_counter() - step_t0
                n_steps += 1
                reqlog.emit("decode_step", step=n_steps, dt_s=step_dt,
                            active=sum(o >= 0 for o in owner))
                for b in range(n_slots):
                    last_tok[b] = block[-1, b]
                    if owner[b] < 0:
                        continue
                    got = 0
                    for c in range(block.shape[0]):
                        # A slot that finishes mid-chunk idles; its further
                        # tokens are dropped.
                        if slot_finished(b):
                            break
                        emitted[owner[b]].append(int(block[c, b]))
                        itl_samples.append(step_dt / chunk)
                        if feed_slo:
                            slo.note_itl(step_dt / chunk)
                        got += 1
                    if got:
                        reqlog.emit("stream", owner[b], n=got,
                                    itl_s=step_dt / chunk)
                for b in range(n_slots):
                    while owner[b] >= 0 and slot_finished(b):
                        retire(b)
                        if queue:
                            refill(b)

        if any(d is None for d in done):
            raise RuntimeError("scheduler exited with unfinished requests")
        return ServedBatch(done, _batch_metrics(
            prompts, rejected, emitted, ttft, finish, attempts, t0,
            itl_samples, qd_samples, occ_samples, steps=n_steps,
            prefills=n_prefills, requeues=n_requeues,
            peer_requeues=n_peer_requeues, slots_shed=fleet.shed,
            slots_revived=fleet.revived, hang_dumps=n_hang_dumps))


def _batch_metrics(prompts, rejected, emitted, ttft, finish, attempts, t0,
                   itl_samples, qd_samples, occ_samples, **counters
                   ) -> ServingMetrics:
    """The batch's ServingMetrics from the scheduler's per-request records
    and samples; ``counters`` are the loop's own counts (steps, prefills,
    requeues, and the paged server's)."""
    wall = time.perf_counter() - t0
    per_request = []
    total_new = 0
    for rid in range(len(prompts)):
        if rid in rejected:
            continue
        nt = len(emitted[rid])
        total_new += nt
        lat = finish[rid] if finish[rid] is not None else wall
        per_request.append(RequestTelemetry(
            rid=rid,
            ttft_s=ttft[rid] if ttft[rid] is not None else lat,
            latency_s=lat,
            new_tokens=nt,
            tokens_per_s=nt / lat if lat > 0 else 0.0,
            retries=attempts[rid]))
    return ServingMetrics(
        requests=len(prompts),
        wall_s=wall,
        new_tokens=total_new,
        tokens_per_s=total_new / wall if wall > 0 else 0.0,
        rejections=len(rejected),
        rejection_reasons=_count_reasons(rejected.values()),
        ttft_p50_s=_pct([r.ttft_s for r in per_request], 0.50),
        ttft_p99_s=_pct([r.ttft_s for r in per_request], 0.99),
        itl_p50_s=_pct(itl_samples, 0.50),
        itl_p99_s=_pct(itl_samples, 0.99),
        queue_depth_max=max(qd_samples) if qd_samples else 0,
        queue_depth_mean=(sum(qd_samples) / len(qd_samples)
                          if qd_samples else 0.0),
        slot_occupancy_mean=(sum(occ_samples) / len(occ_samples)
                             if occ_samples else 1.0),
        per_request=per_request, **counters)


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
    models.llama and models.moe_transformer serve their families; keep an
    MoE config's ``capacity_factor >= n_experts``, or a decode step may
    drop a token its solo run seats). Returns, per request, ``prompt +
    generated`` as a numpy array — equal to that request's solo
    ``family.generate`` run — or a
    :class:`RequestRejected` for a request that cannot fit. ``chunk``
    trades scheduling granularity for fewer host round trips; outputs are
    identical for any chunk. ``server_fns`` (a :func:`make_server_fns`
    result for the same params/cfg/family/chunk) may be reused across
    calls. ``kv_int8`` serves from int8 slot caches (ops/kvquant.py);
    outputs then equal the solo ``generate(..., kv_int8=True)`` runs.
    ``max_request_retries`` bounds per-request restarts after a failed
    prefill or step.

    The result is a ``ServedBatch``: a list of outputs carrying
    ``.metrics`` (per-request TTFT and tokens/s, inter-token latency
    percentiles, queue depth, slot occupancy, requeues)."""
    dev = resolve_device(device)
    fam = family
    if fam is None:
        from mpi_acx_torch.models import transformer as fam  # noqa: N813
    fam.check_device(params, dev)
    return _serve(params, cfg, prompts, n_new, n_slots, max_len, fam, eos,
                  chunk, server_fns, kv_int8, None, None, dev,
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
    dev = resolve_device(device)
    fam = family
    if fam is None:
        from mpi_acx_torch.models import transformer as fam  # noqa: N813
    fam.check_device(params, dev)
    return _serve(params, cfg, prompts, n_new, n_slots, max_len, fam, eos,
                  chunk, server_fns, kv_int8, (temperature, top_k, top_p),
                  operator.index(key), dev,
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
    from mpi_acx_torch.models import kvpage

    dev = resolve_device(device)
    if family is None:
        from mpi_acx_torch.models import transformer as family  # noqa: N813
    family.check_device(params, dev)
    n_new = _normalize_requests(prompts, n_new)
    pt = page_tokens or kvpage.default_page_tokens(max_len)
    if max_len % pt:
        raise ValueError(f"page_tokens={pt} must divide max_len={max_len}")
    if n_pages is None:
        n_pages = n_slots * (max_len // pt)
    ttft_target, itl_target = _slo_admit_targets(slo_admit)

    rejected: Dict[int, RequestRejected] = {}
    for rid, (p, n) in enumerate(zip(prompts, n_new)):
        rej = _admission_check(rid, p, n, chunk, max_len, cfg.max_seq,
                               page_budget=n_pages, page_tokens=pt)
        if rej is not None:
            rejected[rid] = rej
            reqlog.emit("reject", rid, reason=rej.reason)
        else:
            reqlog.emit("admit", rid, prompt_len=len(p), n_new=n)

    pkv = kvpage.PagedKV(cfg, family, n_slots, max_len, pt, n_pages,
                         kv_int8=kv_int8, prefix_cache=prefix_cache,
                         device=dev)
    step_fn = kvpage.make_paged_step_fn(params, cfg, family, chunk, pt)

    queue = deque((rid, np.asarray(p, np.int32))
                  for rid, p in enumerate(prompts) if rid not in rejected)
    for depth, (rid, _p) in enumerate(queue):
        reqlog.emit("queue", rid, depth=depth)
    owner = [-1] * n_slots          # -1 idle, -2 shed (as _serve)
    fleet = _FleetSlots(owner)
    emitted: List[List[int]] = [[] for _ in prompts]
    done: List[Optional[object]] = [None] * len(prompts)
    for rid, rej in rejected.items():
        done[rid] = rej
    last_tok = np.zeros((n_slots,), np.int32)
    attempts = [0] * len(prompts)

    t0 = time.perf_counter()
    ttft = [None] * len(prompts)      # type: List[Optional[float]]
    finish = [None] * len(prompts)    # type: List[Optional[float]]
    slo = RollingSLO()
    for rej in rejected.values():
        slo.note_reject(rej.reason)
    # The rolling SLOs feed the refill gate and the telemetry sampler:
    # kept when either is on as the call starts.
    feed_slo = (ttft_target is not None or itl_target is not None
                or _tseries_lib() is not None)
    itl_samples: List[float] = []
    qd_samples: List[int] = []
    occ_samples: List[float] = []
    n_steps = n_prefills = n_requeues = n_preempts = n_slo_defer = 0
    n_peer_requeues = n_hang_dumps = 0
    # Requests evicted by page pressure: their next seat is a "resume".
    preempted_rids: set = set()

    def _requeue(rid, prompt, exc, charge=True):
        nonlocal n_requeues, n_peer_requeues
        if charge:
            attempts[rid] += 1
            if attempts[rid] > max_request_retries:
                raise RuntimeError(
                    f"request {rid} failed {attempts[rid]} time(s), past "
                    f"max_request_retries={max_request_retries}") from exc
        else:
            n_peer_requeues += 1
        emitted[rid] = []
        ttft[rid] = None
        n_requeues += 1
        reqlog.emit("requeue", rid, charged=bool(charge))
        queue.append((rid, prompt))

    def _slo_defers() -> bool:
        """With a target set, a violating rolling window defers refills
        while work is in flight (an empty server always admits)."""
        if ttft_target is None and itl_target is None:
            return False
        if not any(o >= 0 for o in owner):
            return False
        live = slo.live_slos()
        if (itl_target is not None and live["itl_n"]
                and live["itl_p50_s"] > itl_target):
            return True
        return bool(ttft_target is not None and live["ttft_n"]
                    and live["ttft_p50_s"] > ttft_target)

    def prefill(prompt, S, hit_pages):
        """(first token, the prompt's cache rows to scatter): the whole
        prompt cold, or on a prefix hit only the suffix against the cached
        pages' gathered history."""
        if not hit_pages:
            padded = np.zeros((1, min(_bucket(S), max_len, cfg.max_seq)),
                              np.int32)
            padded[0, :S] = prompt
            logits, one = family.prefill(
                params, cfg, torch.from_numpy(padded).to(dev),
                padded.shape[1], kv_int8=kv_int8, last_index=S - 1)
            one.pop("pos")
            return int(logits[0, 0].argmax()), one
        P = len(hit_pages) * pt
        suffix = prompt[P:]
        Sb = min(_bucket(len(suffix)), max_len - P, cfg.max_seq - P)
        padded = np.zeros((1, Sb), np.int32)
        padded[0, :len(suffix)] = suffix
        hk, hv = pkv.gather_history(hit_pages)
        logits, sk, sv = kvpage.prefill_with_history(
            params, cfg, torch.from_numpy(padded).to(dev), hk, hv,
            len(suffix) - 1)
        one = {"k": sk, "v": sv}
        if kv_int8:
            one["k"], one["ks"] = kv_quant(sk)
            one["v"], one["vs"] = kv_quant(sv)
        return int(logits[0, 0].argmax()), one

    def refill(b):
        """Seat the queue head in slot b. True iff the slot now owns a
        request; False when the SLO gate deferred or the pool cannot cover
        the prompt (the request stays at the queue head) or the prefill
        failed (the request is requeued by the retry rules)."""
        nonlocal n_prefills, n_slo_defer
        if _slo_defers():
            n_slo_defer += 1
            return False
        rid, prompt = queue.popleft()
        S = len(prompt)
        hit_pages = (pkv.prefix.match(prompt) if pkv.prefix is not None
                     else [])
        if hit_pages:
            reqlog.emit("prefix_hit", rid, pages=len(hit_pages))
        fresh = pkv.alloc_evicting(kvpage.pages_needed(S, pt)
                                   - len(hit_pages))
        if fresh is None:
            # Page pressure at admission: back to the head (arrival order
            # kept), the match's references released; a retire frees pages.
            for p in hit_pages:
                pkv.alloc.decref(p)
            queue.appendleft((rid, prompt))
            return False
        spanned = _span_app_begin_best_effort(rid)
        reqlog.emit("prefill_start", rid, prompt_len=S,
                    hit_pages=len(hit_pages), fresh_pages=len(fresh))
        try:
            first, one = prefill(prompt, S, hit_pages)
            pkv.scatter_prompt(one, fresh)
        except Exception as exc:  # noqa: BLE001 — any device failure
            for p in hit_pages + fresh:
                pkv.alloc.decref(p)
            _requeue(rid, prompt, exc, charge=not _peer_dead(exc))
            return False
        finally:
            if spanned:
                _span_app_end_best_effort()
        reqlog.emit("prefill_end", rid, first_token=first)
        pkv.seat(b, hit_pages, fresh, S, rid=rid)
        if pkv.prefix is not None:
            pkv.prefix.insert(prompt, pkv.pages[b])
        owner[b] = rid
        if rid in preempted_rids:
            preempted_rids.discard(rid)
            slo.note_resume()
            reqlog.emit("resume", rid, slot=b)
        emitted[rid].append(first)
        if on_token is not None:
            on_token(rid, first)
        last_tok[b] = first
        n_prefills += 1
        ttft[rid] = time.perf_counter() - t0
        if feed_slo:
            slo.note_ttft(ttft[rid])
        reqlog.emit("stream", rid, n=1, ttft_s=ttft[rid])
        return True

    def retire(b):
        rid = owner[b]
        done[rid] = np.concatenate(
            [np.asarray(prompts[rid], np.int32),
             np.asarray(emitted[rid], np.int32)])
        finish[rid] = time.perf_counter() - t0
        reqlog.emit("finish", rid, new_tokens=len(emitted[rid]),
                    latency_s=finish[rid])
        owner[b] = -1
        pkv.release(b)              # pages back to the pool, slot parked

    def preempt(b):
        """Page-pressure eviction: slot b's request requeues uncharged
        (pressure is the server's doing, not the request's) with its pages
        freed; the replay gives the same tokens."""
        nonlocal n_preempts
        rid = owner[b]
        owner[b] = -1
        pkv.release(b)
        emitted[rid] = []
        ttft[rid] = None
        queue.append((rid, np.asarray(prompts[rid], np.int32)))
        n_preempts += 1
        pkv.preemptions += 1
        preempted_rids.add(rid)
        slo.note_preempt()
        reqlog.emit("preempt", rid, slot=b)

    def grow_for_chunk():
        """Before each step every active slot's table must cover the
        chunk's writes (positions pos..pos+chunk-1). A pool dry even after
        trie eviction preempts the latest arrival and rescans; admission
        guarantees a lone request fits, so this ends."""
        while True:
            for b in range(n_slots):
                if owner[b] < 0:
                    continue
                if not pkv.grow(b, (int(pkv.pos[b]) + chunk - 1) // pt + 1):
                    victims = [s for s in range(n_slots) if owner[s] >= 0]
                    if len(victims) <= 1:
                        raise RuntimeError(
                            "page pool dry for a lone request (admission "
                            "should have rejected it)")
                    preempt(max(victims, key=lambda s: owner[s]))
                    break
            else:
                return

    def slot_finished(b):
        rid = owner[b]
        return (len(emitted[rid]) >= n_new[rid]
                or (eos is not None and emitted[rid]
                    and emitted[rid][-1] == eos))

    def publish():
        kvpage.publish_page_stats_best_effort(
            pkv.alloc.free_count, pkv.alloc.shared_count(),
            pkv.prefix.hits if pkv.prefix else 0,
            pkv.prefix.evictions if pkv.prefix else 0, pkv.preemptions)

    def seed_idle_slots() -> bool:
        """Seat queued requests in idle slots until one cannot be seated;
        True iff any was."""
        progressed = False
        while queue and any(o == -1 for o in owner):
            b = owner.index(-1)
            if not refill(b):
                break
            progressed = True
            if slot_finished(b):
                retire(b)
        return progressed

    qd_samples.append(len(queue))
    seed_idle_slots()
    stalls = 0
    while any(o >= 0 for o in owner) or queue:
        qd_samples.append(len(queue))
        occ_samples.append(sum(o >= 0 for o in owner) / n_slots)
        if feed_slo:
            slo.note_gauges(qd_samples[-1], occ_samples[-1])
            _tseries_annotate_best_effort(slo)
        publish()
        if queue:
            for b in fleet.check_rejoin():
                if queue and refill(b) and slot_finished(b):
                    retire(b)
        if not any(o >= 0 for o in owner):
            # All slots idle with requests queued (failure requeues, a
            # deferred seed, total preemption): reseed. The gate never
            # defers an empty server and admission bounds every request,
            # so a stall here is a bug: bound it instead of spinning.
            stalls = 0 if seed_idle_slots() else stalls + 1
            if stalls > len(prompts) + n_slots + 2:
                raise RuntimeError(
                    "paged scheduler stalled: requests queued, no slot "
                    "seatable")
            continue
        stalls = 0
        grow_for_chunk()
        if not any(o >= 0 for o in owner):
            continue                # grow_for_chunk preempted everyone
        # Copy-on-write guard (unreachable under the radix policy): the
        # pages this chunk writes must be privately owned.
        for b in range(n_slots):
            if owner[b] < 0:
                continue
            for j in range(int(pkv.pos[b]) // pt,
                           (int(pkv.pos[b]) + chunk - 1) // pt + 1):
                if j < len(pkv.pages[b]):
                    pkv.ensure_writable(b, j)
        step_t0 = time.perf_counter()
        try:
            state, toks = step_fn(pkv.device_state(),
                                  torch.from_numpy(last_tok).to(dev))
            block = toks.cpu().numpy()               # [chunk, B]; syncs
            pkv.absorb(state, chunk)
        except Exception as exc:  # noqa: BLE001 — any device failure
            # The pool is written in place, so after a failed step it
            # cannot be trusted: requeue every active request and start
            # the pool over (the prefix cache's pages lived in it too).
            lost_peer = _peer_dead(exc)
            if _flight_dump_best_effort():
                n_hang_dumps += 1
            for b in range(n_slots):
                if owner[b] >= 0:
                    rid = owner[b]
                    owner[b] = -1
                    _requeue(rid, np.asarray(prompts[rid], np.int32), exc,
                             charge=not lost_peer)
            if lost_peer:
                fleet.shed_one()
            pkv.reset_pool()
            last_tok = np.zeros((n_slots,), np.int32)
            continue
        step_dt = time.perf_counter() - step_t0
        n_steps += 1
        reqlog.emit("decode_step", step=n_steps, dt_s=step_dt,
                    active=sum(o >= 0 for o in owner))
        for b in range(n_slots):
            last_tok[b] = block[-1, b]
            if owner[b] < 0:
                continue
            got = 0
            for c in range(block.shape[0]):
                if slot_finished(b):
                    break
                tok = int(block[c, b])
                emitted[owner[b]].append(tok)
                if on_token is not None:
                    on_token(owner[b], tok)
                itl_samples.append(step_dt / chunk)
                if feed_slo:
                    slo.note_itl(step_dt / chunk)
                got += 1
            if got:
                reqlog.emit("stream", owner[b], n=got, itl_s=step_dt / chunk)
        for b in range(n_slots):
            while owner[b] >= 0 and slot_finished(b):
                retire(b)
                if queue:
                    refill(b)

    publish()
    if any(d is None for d in done):
        raise RuntimeError("scheduler exited with unfinished requests")
    batch = ServedBatch(done, _batch_metrics(
        prompts, rejected, emitted, ttft, finish, attempts, t0, itl_samples,
        qd_samples, occ_samples, steps=n_steps, prefills=n_prefills,
        requeues=n_requeues, peer_requeues=n_peer_requeues,
        slots_shed=fleet.shed, slots_revived=fleet.revived,
        hang_dumps=n_hang_dumps, preemptions=n_preempts,
        prefix_hits=pkv.prefix.hits if pkv.prefix else 0,
        prefix_evictions=pkv.prefix.evictions if pkv.prefix else 0,
        prefix_pages_reused=pkv.prefix.pages_reused if pkv.prefix else 0,
        pages_hwm=pkv.pages_hwm, slo_deferrals=n_slo_defer))
    if return_paged_state:
        batch.paged_state = pkv
    return batch
