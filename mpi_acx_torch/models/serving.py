"""Continuous-batching serving loop (single device): the greedy path of the
JAX package's ``models/serving.py``.

B cache slots decode in lockstep as one batched step while a host-side
scheduler swaps finished requests out and queued prompts in mid-stream,
so the device never waits for the slowest request. The mechanism is
per-slot positions: each slot's fresh K/V lands at its own ``pos[b]`` and
decode attention masks each slot at ``cols <= pos[b]``, so every slot's
math is its solo run's and greedy outputs equal per-request
``generate()``. Prompts are right-padded to a power-of-two bucket; pad
rows are never attended (they sit past ``pos[b]`` until decode overwrites
them).

Not ported yet (each raises ``NotImplementedError`` or is absent, and is
listed in ROADMAP.md): ``kv_int8`` slot caches, ``serve_sample``,
``serve_paged_greedy``, and the native-runtime hooks (flight dumps, fleet
membership, telemetry annotation, causal spans), which return with the
port's own runtime binding. Without them a failed step charges every
victim's retry budget and no slot is ever shed.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from mpi_acx_torch import reqlog
from mpi_acx_torch.device import resolve_device


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
    JAX package's fields; the paged, fleet and hang-dump counters stay 0
    until those paths are ported)."""

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
    (``reason``: ``exceeds_max_len`` or ``exceeds_model_ceiling``;
    ``detail``: the arithmetic)."""

    rid: int
    reason: str
    detail: str = ""


def _admission_check(rid, prompt, n, chunk, max_len, max_seq
                     ) -> Optional[RequestRejected]:
    """A request needs ``len(prompt) + n + chunk`` cache positions (a slot
    finishing mid-chunk keeps writing until the chunk boundary)."""
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
        self.rejects: Dict[str, int] = {}
        self.preemptions = 0      # paged serving's counters: 0 until ported
        self.resumes = 0

    def note_reject(self, reason: str) -> None:
        self.rejects[reason] = self.rejects.get(reason, 0) + 1

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


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def make_server_fns(params, cfg, family, chunk: int = 1):
    """The serve loop's closures: returns (prefill_fn, step_fn, scatter_fn,
    chunk). ``family`` is the model module (models.transformer, or any
    module exposing prefill/decode_step/init_kv_cache with the shared cache
    layout).

    ``chunk`` > 1 runs that many decode steps per host round trip,
    returning the [chunk, B] token block; the scheduler then reacts every
    ``chunk`` tokens. The tokens are identical to stepwise decoding; the
    cost is scheduling granularity (a finished slot idles until the chunk
    boundary)."""

    def prefill_fn(tokens, last):
        """[1, S_bucket], real last index -> (logits [1, 1, vocab],
        cache); the unembedding runs on the real prompt's final row."""
        return family.prefill(params, cfg, tokens, tokens.shape[1],
                              last_index=last)

    def step_fn(cache, tok):
        toks = []
        for _ in range(chunk):
            logits, cache = family.decode_step(params, cfg, cache, tok)
            tok = logits.argmax(dim=-1).to(torch.int32)
            toks.append(tok)
        return cache, torch.stack(toks)                # toks [chunk, B]

    def scatter_fn(slots, one, slot_idx, new_pos):
        """Land a freshly prefilled single-request cache (``one``, B=1,
        bucket-length) in slot ``slot_idx`` of the slot cache, in place;
        rows past the bucket keep the slot's old contents (never attended:
        they lie beyond ``new_pos`` until decode overwrites them)."""
        for key in ("k", "v"):
            src = one[key][:, 0]                    # [L, S_bucket, H, D]
            slots[key][:, slot_idx, :src.shape[1]] = src
        slots["pos"][slot_idx] = new_pos
        return slots

    return prefill_fn, step_fn, scatter_fn, chunk


def _serve(params, cfg, prompts, n_new, n_slots, max_len, family, eos,
           chunk, server_fns, dev, max_request_retries=2):
    """The scheduler: queue, slot ownership, chunk-block consumption,
    retire/refill. A request whose prefill or step raised is re-queued
    from scratch (emitted tokens discarded, so the restart replays the
    same greedy path) up to ``max_request_retries`` times before the
    failure is re-raised with the request id attached."""
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

    rejected: Dict[int, RequestRejected] = {}
    for rid, (p, n) in enumerate(zip(prompts, n_new)):
        rej = _admission_check(rid, p, n, chunk, max_len, cfg.max_seq)
        if rej is not None:
            rejected[rid] = rej
            reqlog.emit("reject", rid, reason=rej.reason)
        else:
            reqlog.emit("admit", rid, prompt_len=len(p), n_new=n)

    if server_fns is None:
        server_fns = make_server_fns(params, cfg, family, chunk=chunk)
    prefill_fn, step_fn, scatter_fn, fns_chunk = server_fns
    if fns_chunk != chunk:
        raise ValueError(f"server_fns built for chunk={fns_chunk}, this call "
                         f"uses chunk={chunk}")

    def fresh_slots():
        s = family.init_kv_cache(cfg, n_slots, max_len, device=dev)
        s["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return s

    slots = fresh_slots()
    queue = deque((rid, np.asarray(p, np.int32))
                  for rid, p in enumerate(prompts) if rid not in rejected)
    for depth, (rid, _p) in enumerate(queue):
        reqlog.emit("queue", rid, depth=depth)
    owner = [-1] * n_slots          # request id per slot; -1 = idle
    emitted: List[List[int]] = [[] for _ in prompts]
    done: List[Optional[object]] = [None] * len(prompts)
    for rid, rej in rejected.items():
        done[rid] = rej
    last_tok = np.zeros((n_slots,), np.int32)
    attempts = [0] * len(prompts)

    # All requests arrive at entry, so queue wait counts toward TTFT.
    t0 = time.perf_counter()
    ttft = [None] * len(prompts)      # type: List[Optional[float]]
    finish = [None] * len(prompts)    # type: List[Optional[float]]
    slo = RollingSLO()
    for rej in rejected.values():
        slo.note_reject(rej.reason)
    itl_samples: List[float] = []
    qd_samples: List[int] = []
    occ_samples: List[float] = []
    n_steps = 0
    n_prefills = 0
    n_requeues = 0

    def _requeue(rid, prompt, exc):
        """Put a failed request back on the queue for a restart, or
        re-raise past the retry budget."""
        nonlocal n_requeues
        attempts[rid] += 1
        if attempts[rid] > max_request_retries:
            raise RuntimeError(
                f"request {rid} failed {attempts[rid]} time(s), past "
                f"max_request_retries={max_request_retries}") from exc
        emitted[rid] = []
        ttft[rid] = None
        n_requeues += 1
        reqlog.emit("requeue", rid, charged=True)
        queue.append((rid, prompt))

    def refill(b):
        """Returns True iff slot b now owns a request; a failed prefill
        re-queues the request instead of killing the server."""
        nonlocal slots, n_prefills
        rid, prompt = queue.popleft()
        S = len(prompt)
        # Bucket capped at max_len (the scatter must fit the slot) and at
        # the model's position ceiling.
        padded = np.zeros((1, min(_bucket(S), max_len, cfg.max_seq)),
                          np.int32)
        padded[0, :S] = prompt
        reqlog.emit("prefill_start", rid, prompt_len=S,
                    bucket=padded.shape[1])
        try:
            logits, one = prefill_fn(torch.from_numpy(padded).to(dev), S - 1)
            first = int(logits[0, 0].argmax())
            slots = scatter_fn(slots, one, b, S)
        except Exception as exc:  # noqa: BLE001 — any device failure
            _requeue(rid, prompt, exc)
            return False
        owner[b] = rid
        emitted[rid].append(first)
        last_tok[b] = first
        n_prefills += 1
        reqlog.emit("prefill_end", rid, first_token=first)
        reqlog.emit("seat", rid, slot=b, pos=S)
        ttft[rid] = time.perf_counter() - t0
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

    qd_samples.append(len(queue))
    seed_idle_slots()

    while any(o >= 0 for o in owner) or queue:
        qd_samples.append(len(queue))
        occ_samples.append(sum(o >= 0 for o in owner) / n_slots)
        slo.note_gauges(qd_samples[-1], occ_samples[-1])
        if not any(o >= 0 for o in owner):
            # All slots idle with requests queued: only reachable after a
            # failure re-queued them — reseed and keep serving.
            seed_idle_slots()
            continue
        step_t0 = time.perf_counter()
        try:
            slots, toks = step_fn(slots, torch.from_numpy(last_tok).to(dev))
            block = toks.cpu().numpy()               # [chunk, B]; syncs
        except Exception as exc:  # noqa: BLE001 — any device failure
            # The slot cache is updated in place, so after a failed step it
            # cannot be trusted: re-queue every active request (bit-equal
            # restart, bounded by max_request_retries) and rebuild it.
            for b in range(n_slots):
                if owner[b] >= 0:
                    rid = owner[b]
                    owner[b] = -1
                    _requeue(rid, np.asarray(prompts[rid], np.int32), exc)
            slots = fresh_slots()
            last_tok = np.zeros((n_slots,), np.int32)
            continue
        # The copy to the host waited for the device, so this dt covers
        # the device step; the chunk's tokens share it evenly.
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
                # A slot that finishes mid-chunk idles; its further tokens
                # are dropped.
                if slot_finished(b):
                    break
                emitted[owner[b]].append(int(block[c, b]))
                itl_samples.append(step_dt / chunk)
                slo.note_itl(step_dt / chunk)
                got += 1
            if got:
                reqlog.emit("stream", owner[b], n=got, itl_s=step_dt / chunk)
        for b in range(n_slots):
            while owner[b] >= 0 and slot_finished(b):
                retire(b)
                if queue:
                    refill(b)

    if any(d is None for d in done):
        raise RuntimeError("scheduler exited with unfinished requests")
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
    metrics = ServingMetrics(
        requests=len(prompts),
        wall_s=wall,
        new_tokens=total_new,
        tokens_per_s=total_new / wall if wall > 0 else 0.0,
        steps=n_steps,
        prefills=n_prefills,
        requeues=n_requeues,
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
        per_request=per_request)
    return ServedBatch(done, metrics)


def serve_greedy(params, cfg, prompts: Sequence[np.ndarray], n_new,
                 n_slots: int, max_len: int, family=None,
                 eos: Optional[int] = None, chunk: int = 1,
                 server_fns=None, kv_int8: bool = False,
                 max_request_retries: int = 2, device=None) -> ServedBatch:
    """Serve ``prompts`` (1-D int arrays, any lengths) through ``n_slots``
    continuously-batched cache slots on ``device`` (``None`` means the GPU;
    the parameters must already be there). Each request decodes greedily
    for ``n_new`` tokens (an int, or one per request) or until ``eos``.
    Returns, per request, ``prompt + generated`` as a numpy array — equal
    to that request's solo ``family.generate`` run — or a
    :class:`RequestRejected` for a request that cannot fit. ``chunk``
    trades scheduling granularity for fewer host round trips; outputs are
    identical for any chunk. ``server_fns`` (a :func:`make_server_fns`
    result for the same params/cfg/family/chunk) may be reused across
    calls. ``max_request_retries`` bounds per-request restarts after a
    failed prefill or step.

    The result is a ``ServedBatch``: a list of outputs carrying
    ``.metrics`` (per-request TTFT and tokens/s, inter-token latency
    percentiles, queue depth, slot occupancy, requeues)."""
    if kv_int8:
        raise NotImplementedError("int8 KV slot caches are not ported yet")
    dev = resolve_device(device)
    fam = family
    if fam is None:
        from mpi_acx_torch.models import transformer as fam  # noqa: N813
    fam.check_device(params, dev)
    return _serve(params, cfg, prompts, n_new, n_slots, max_len, fam, eos,
                  chunk, server_fns, dev,
                  max_request_retries=max_request_retries)


def serve_sample(*args, **kwargs):
    """Stochastic continuous batching: not ported yet."""
    raise NotImplementedError("serve_sample is not ported yet")


def serve_paged_greedy(*args, **kwargs):
    """Continuous batching over a paged KV cache: not ported yet."""
    raise NotImplementedError("serve_paged_greedy is not ported yet")
