"""Disaggregated prefill/decode serving with a per-layer KV handoff (the JAX
package's ``models/disagg.py``).

Monolithic continuous batching (models/serving.py) runs prefill and decode
on one rank, so every prompt pass stalls the decode batch behind it. Here
the fleet splits by role (``ACX_ROLE``): prefill ranks run the prompt pass
and ship each layer's KV as soon as that layer is done (one partitioned
send per request, one partition per layer, MPIX_Pready from inside the
layer loop while later layers still run); decode ranks poll MPIX_Parrived,
splice the arrivals into their slot caches through the same ``scatter_fn``
as the monolithic server, and generate. The wire mechanics (packing,
persistent channels, tags) are in parallel/kv_ship.py.

Wire form: int8 codes and f32 scales are the only form KV takes on the
wire, so decode slot caches are always int8, and a disagg serve gives the
monolithic ``serve_greedy(..., kv_int8=True)``'s tokens exactly, for both
prefill-side cache variants (``prefill_kv_int8``): quantize-at-compute and
quantize-at-wire give the same bytes, because prefill attention runs on the
exact K/V either way and ops/kvquant.py is deterministic. The layer loop is
the op sequence of ``transformer.prefill``, so on the GPU K1 runs at the
same shapes and gives the same bits.

Handoff protocol, per request (a descriptor and one partitioned round):

  prefill                           decode
  -------                           ------
  HDR isend {rid, prompt_len,
             bucket}         ---->  irecv HDR; channel(peer, bucket);
                                    MPIX_Start recv round
  MPIX_Start send round
  layer 0; quant; copy to host;
  pack; Pready(0)            ---->  Parrived(0) -> splice layer 0
  layer 1 ...                ---->  ... (arrivals overlap the prefill of
  ...                               later layers)
  head -> first token
  FIN isend {rid, first,
             prefill_us}     ---->  irecv FIN; every layer arrived;
  wait round                        wait round; scatter_fn -> slot seated

Failure: a handoff that dies mid-round is requeued; the decode side drops
the partial splice, and peer loss does not charge the request's retry
budget (serving.py's ``_peer_dead`` rule). A respawned prefill rank
re-ships every handoff it owns; the decode side drops duplicates of
requests it already has by rid. The send side completes an aborted round by
publishing its remaining partitions with stale staging bytes
(``abort_fill``), so the persistent channel stays restartable.

Telemetry: each handoff records its TTFT split (prefill compute, ship from
FIN to the last arrival, decode pickup) as a ``HandoffTelemetry`` row on
``DisaggMetrics.handoffs``; ``overlap=False`` (ship only after the full
prompt pass) is the baseline that per-layer Pready is compared with.

Only the dense transformer family has a layerwise prefill; Llama and MoE
are refused by name, as in the JAX package.
"""

from __future__ import annotations

import atexit
import os
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mpi_acx_torch import profiling, reqlog
from mpi_acx_torch.models.serving import (
    ServedBatch, ServingMetrics, _family_on, _FixedSlots, _Loop,
    _PagedSlots, _bucketed, _flight_dump_best_effort, _pct, _peer_dead,
    _server_fns, _span_app_begin_best_effort, _span_app_end_best_effort,
    seat_slots)
from mpi_acx_torch.parallel.kv_ship import (DESC_FIN_TAG, DESC_HDR_TAG,
                                            KvReceiver, KvShipper)

# Descriptor magics ("ACXH"/"ACXF"): a handoff stream that desyncs fails at
# the magic check instead of splicing garbage into a slot cache.
_HDR_MAGIC = 0x41435848
_FIN_MAGIC = 0x41435846


def _hdr_wire(rid: int, prompt_len: int, bucket: int) -> np.ndarray:
    return np.array([_HDR_MAGIC, rid, prompt_len, bucket], np.int64)


def _fin_wire(rid: int, first_token: int, prefill_us: int,
              expose_us: int) -> np.ndarray:
    return np.array([_FIN_MAGIC, rid, first_token, prefill_us, expose_us],
                    np.int64)


def fleet_roles(size: int) -> List[str]:
    """Role of every rank, from ``$ACX_ROLE``: a comma list with one
    ``prefill``/``decode`` per rank (the form acxrun passes on, all ranks
    sharing one environment), a single role token (the map is then the
    default: rank 0 prefill, the rest decode), or unset (the default;
    ``serve_disagg_greedy`` then serves in loopback)."""
    spec = os.environ.get("ACX_ROLE", "").strip()
    default = ["prefill"] + ["decode"] * max(size - 1, 0)
    if not spec:
        return default
    if "," in spec:
        roles = [t.strip() for t in spec.split(",") if t.strip()]
        if len(roles) != size or any(r not in ("prefill", "decode")
                                     for r in roles):
            raise ValueError(f"ACX_ROLE={spec!r}: need one prefill|decode "
                             f"per rank ({size})")
        if "prefill" not in roles or "decode" not in roles:
            raise ValueError(f"ACX_ROLE={spec!r}: need at least one prefill "
                             "and one decode rank")
        return roles
    if spec not in ("prefill", "decode"):
        raise ValueError(f"ACX_ROLE={spec!r}: prefill|decode|comma-list")
    return default


@dataclass
class HandoffTelemetry:
    """One handoff's TTFT split (a ``DisaggMetrics.handoffs`` row)."""

    rid: int
    layers: int
    wire_bytes: int      # partitioned payload (codes + scales)
    prefill_s: float     # embed -> first token (with per-layer publishes)
    ship_s: float        # FIN seen -> last partition arrived + round done
    pickup_s: float      # assembled arrays -> scatter -> slot seated
    overlap: bool        # per-layer Pready (True) or ship-after-prefill
    expose_s: float = 0.0  # publish time left after the head: ~0 with
    #                        per-layer Pready, the whole pack + publish
    #                        without it


@dataclass
class DisaggMetrics(ServingMetrics):
    """ServingMetrics with the handoff rows of a disagg serve."""

    handoffs: List[HandoffTelemetry] = field(default_factory=list)
    handoff_prefill_p50_s: float = 0.0
    handoff_ship_p50_s: float = 0.0
    handoff_pickup_p50_s: float = 0.0


def _disagg_metrics(fields: dict, hs: List[HandoffTelemetry]):
    """The serve loop's metrics fields with the handoff rows and their
    medians."""
    return DisaggMetrics(
        **fields, handoffs=hs,
        handoff_prefill_p50_s=_pct([h.prefill_s for h in hs], 0.5),
        handoff_ship_p50_s=_pct([h.ship_s for h in hs], 0.5),
        handoff_pickup_p50_s=_pct([h.pickup_s for h in hs], 0.5))


def _check_dense(family) -> None:
    from mpi_acx_torch.models import transformer as tfm
    if family is not None and family is not tfm:
        raise NotImplementedError(
            f"layerwise prefill: dense transformer family only "
            f"(models.transformer), not {family.__name__}")


def make_layerwise_prefill_fns(params, cfg, family=None):
    """Per-layer prefill closures ``(embed_fn, layer_fn, head_fn,
    quant_fn)``. The layer loop runs on the host so the caller can publish
    layer l's KV as soon as ``layer_fn`` returns. Each closure is the
    dense family's own block pieces (``_qkv``/``_attend``/``_mlp``/
    ``wread``) in ``transformer.prefill``'s order, so the loop gives its
    logits, codes and scales bit for bit.

    * ``embed_fn(tokens [1, S]) -> x [1, S, d]``
    * ``layer_fn(x, layer) -> (x, k, v)``, k/v [1, S, H, Dh]
    * ``head_fn(x, last_index) -> logits [1, 1, vocab]`` (f32)
    * ``quant_fn(k, v) -> (kq, ks, vq, vs)`` (ops/kvquant.py)"""
    from mpi_acx_torch.models import transformer as tfm
    from mpi_acx_torch.ops.kvquant import kv_quant
    from mpi_acx_torch.ops.wquant import wread
    _check_dense(family)

    def embed_fn(tokens):
        S = tokens.shape[1]
        return (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)

    def layer_fn(x, layer):
        lp = tfm._layer(params, layer)
        q, k, v = tfm._qkv(cfg, lp, x)
        x = x + tfm._attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
        return tfm._mlp(cfg, lp, x), k, v

    def head_fn(x, last_index):
        x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
        return tfm._unembed(x[:, last_index:last_index + 1], params["embed"])

    def quant_fn(k, v):
        kq, ks = kv_quant(k)
        vq, vs = kv_quant(v)
        return kq, ks, vq, vs

    return embed_fn, layer_fn, head_fn, quant_fn


def _to_host(codes):
    """(kq, ks, vq, vs) copied to the host (each copy waits for the layer
    that produced it)."""
    return tuple(a.cpu() for a in codes)


def _prefill_ship(rt, ch, dst, rid, padded, S, pfns, cfg, overlap,
                  prefill_kv_int8, ship_fault=None, recv_ch=None):
    """The prefill side of one handoff to rank ``dst`` over channel ``ch``:
    the HDR descriptor, the channel round and the FIN descriptor around
    the layerwise prompt pass, which publishes layer l's partition as it
    completes (``overlap``) or all of them after the head (the
    ship-after-prefill baseline).

    ``prefill_kv_int8`` picks the prefill-side cache variant:
    quantize-at-compute (the prefill holds int8 codes, as a prefill rank
    serving with int8 KV would) or quantize-at-wire (the K/V stay in the
    compute dtype until the pack). The wire bytes are the same.

    ``ship_fault(rid, layer)`` is a test hook called before layer
    ``layer``'s publish: raising from it models a prefill rank dying
    mid-handoff.

    With ``recv_ch`` (loopback: ``dst`` is this rank) this rank takes the
    descriptors and the round too: each descriptor's receive is posted
    before its send and both are waited, so a later failure never leaves
    a dangling descriptor in the stream.

    Returns ``(first_token, prefill_s, expose_s)``; ``expose_s`` is the
    publish time left after the head finished (~0 with per-layer overlap,
    the serialized pack and publish without it)."""
    embed_fn, layer_fn, head_fn, quant_fn = pfns
    reqlog.emit("prefill_start", rid, prompt_len=S, bucket=padded.shape[1])
    side = ({"side": "send", "dst": dst} if recv_ch is None
            else {"side": "loopback"})

    def descriptor(wire, tag):
        if recv_ch is None:
            rt.wait(rt.isend_enqueue(wire, dest=dst, tag=tag))
            return
        got = np.zeros_like(wire)
        req = rt.irecv_enqueue(got, source=dst, tag=tag)
        rt.wait(rt.isend_enqueue(wire, dest=dst, tag=tag))
        rt.wait(req)
        assert got[0] == wire[0] and got[1] == rid, got

    descriptor(_hdr_wire(rid, S, padded.shape[1]), DESC_HDR_TAG)
    reqlog.emit("ship_hdr", rid, bucket=padded.shape[1], **side)
    if recv_ch is not None:
        recv_ch.begin()
    ch.begin()
    t0 = time.perf_counter()
    x = embed_fn(padded)
    staged = []
    for layer in range(cfg.n_layers):
        x, k, v = layer_fn(x, layer)
        reqlog.emit("prefill_layer", rid, layer=layer)
        codes = _to_host(quant_fn(k, v)) if prefill_kv_int8 else None
        if ship_fault is not None:
            ship_fault(rid, layer)
        if overlap:
            kq, ks, vq, vs = codes or _to_host(quant_fn(k, v))
            ch.publish(layer, kq[0], ks[0], vq[0], vs[0])
            reqlog.emit("ship_pready", rid, part=layer, overlap=True)
        else:
            staged.append(codes or (k, v))
    with profiling.annotate("acx.serve.first_token"):
        first = int(head_fn(x, S - 1)[0, 0].argmax())
    t_head = time.perf_counter()
    for layer, st in enumerate(staged):
        kq, ks, vq, vs = st if len(st) == 4 else _to_host(quant_fn(*st))
        ch.publish(layer, kq[0], ks[0], vq[0], vs[0])
        reqlog.emit("ship_pready", rid, part=layer, overlap=False)
    t1 = time.perf_counter()
    prefill_s, expose_s = t1 - t0, t1 - t_head
    reqlog.emit("prefill_end", rid, first_token=first, prefill_s=prefill_s)
    descriptor(_fin_wire(rid, first, int(prefill_s * 1e6),
                         int(expose_s * 1e6)), DESC_FIN_TAG)
    reqlog.emit("ship_fin", rid, **side)
    return first, prefill_s, expose_s


def _splice_poll(ch, bucket, heads, head_dim, timeout_s=30.0):
    """Poll every layer partition, splicing arrivals (in arrival order)
    into the assembled [L, 1, bucket, ...] host cache. Raises
    ``AcxTimeoutError`` past ``timeout_s``, so a decode rank never spins
    forever on a prefill rank that died before heartbeats could tell."""
    from mpi_acx_torch.runtime import ERR_TIMEOUT, AcxTimeoutError
    L = ch.geom.n_layers
    kq = np.zeros((L, 1, bucket, heads, head_dim), np.int8)
    vq = np.zeros_like(kq)
    ks = np.zeros((L, 1, bucket, heads, 1), np.float32)
    vs = np.zeros_like(ks)
    pending = set(range(L))
    deadline = time.monotonic() + timeout_s
    while pending:
        for layer in sorted(pending):
            if ch.poll(layer):
                (kq[layer, 0], ks[layer, 0], vq[layer, 0],
                 vs[layer, 0]) = ch.take(layer)
                pending.discard(layer)
        if pending and time.monotonic() > deadline:
            raise AcxTimeoutError(
                f"handoff: {len(pending)} layer partition(s) never arrived "
                f"within {timeout_s}s", ERR_TIMEOUT, ch.geom.peer, -1)
    return {"k": kq, "ks": ks, "v": vq, "vs": vs}


def _abort_rounds(send_ch, recv_ch, drain_s: float = 5.0) -> None:
    """Close both ends of a failed handoff round so the persistent channels
    stay restartable: the send side publishes its remaining partitions with
    stale bytes, the receive side drains the arrivals (error-completed
    partitions read arrived too) and closes. Never raises: it runs on the
    requeue path, where the original exception is the one that matters."""
    try:
        if send_ch is not None and send_ch.open_round:
            send_ch.abort_fill()
            send_ch.finish()
    except Exception:  # noqa: BLE001 — cleanup must not mask the cause
        send_ch.open_round = False
    try:
        if recv_ch is not None and recv_ch.open_round:
            deadline = time.monotonic() + drain_s
            while (not all(recv_ch.poll(p)
                           for p in range(recv_ch.geom.n_layers))
                   and time.monotonic() < deadline):
                pass
            recv_ch.finish()
    except Exception:  # noqa: BLE001 — cleanup must not mask the cause
        recv_ch.open_round = False


_loopback_runtime = None


def _loopback_rt():
    """The process's loopback ``Runtime`` (rank 0 of 1) for single-process
    disagg serving, finalized at interpreter exit. A caller under acxrun,
    or one that finalizes its runtime itself, passes its own."""
    global _loopback_runtime
    if _loopback_runtime is None:
        from mpi_acx_torch.runtime import Runtime
        _loopback_runtime = Runtime()
        atexit.register(_loopback_runtime.finalize)
    return _loopback_runtime


def _host_to(one, dev):
    """The assembled host cache on ``dev``, one copy per array."""
    return {k: torch.from_numpy(v).to(dev) for k, v in one.items()}


def serve_disagg_greedy(params, cfg, prompts: Sequence[np.ndarray], n_new,
                        n_slots: int, max_len: int, family=None,
                        eos: Optional[int] = None, chunk: int = 1,
                        server_fns=None, prefill_kv_int8: bool = False,
                        max_request_retries: int = 2, rt=None,
                        overlap: bool = True,
                        ship_fault: Optional[Callable] = None,
                        poll_timeout_s: float = 30.0,
                        device=None) -> ServedBatch:
    """Disaggregated greedy serving on ``device`` (``None`` means the GPU;
    the parameters must already be there).

    With ``$ACX_ROLE`` unset: loopback. This process plays both roles over
    a channel to itself, so the whole wire path (descriptors, the
    partitioned round, per-layer Pready and Parrived, the splice) runs in
    one process; the outputs equal ``serve_greedy(..., kv_int8=True)``'s.
    With ``$ACX_ROLE`` set (under acxrun, ``rt`` required): this rank's
    role worker runs; a prefill rank returns an empty batch, a decode rank
    its requests' outputs (None elsewhere).

    ``server_fns`` must be a ``make_server_fns(..., kv_int8=True)`` tuple:
    decode slots are always int8, the wire form. ``prefill_kv_int8`` picks
    the prefill-side variant (see ``_prefill_ship``); ``overlap=False``
    ships only after the full prompt pass. ``ship_fault(rid, layer)`` is a
    failure-injection hook (see ``_prefill_ship``)."""
    fam, dev = _family_on(family, params, device)
    _check_dense(fam)
    if os.environ.get("ACX_ROLE", "").strip():
        if rt is None:
            raise ValueError("fleet mode needs an explicit Runtime")
        if fleet_roles(rt.size)[rt.rank] == "prefill":
            run_prefill_worker(rt, params, cfg, prompts, max_len,
                               family=fam, overlap=overlap,
                               prefill_kv_int8=prefill_kv_int8, device=dev)
            return ServedBatch([None] * len(prompts), DisaggMetrics())
        return run_decode_worker(
            rt, params, cfg, prompts, n_new, n_slots, max_len, family=fam,
            eos=eos, chunk=chunk, server_fns=server_fns,
            max_request_retries=max_request_retries,
            poll_timeout_s=poll_timeout_s, device=dev)
    # Loopback: models/serving.py's serve loop over wire-seated slots. A
    # request that cannot fit refuses the call instead of being typed.
    loop = _Loop(prompts, n_new, n_slots, eos, chunk, dev,
                 max_request_retries,
                 dict(max_len=max_len, max_seq=cfg.max_seq))
    if loop.rejected:
        raise ValueError("; ".join(r.detail for r in loop.rejected.values()))
    fns = _server_fns(server_fns, params, cfg, fam, chunk, True, None)
    return loop.run(_LoopbackSlots(
        loop, fns, params, cfg, fam, max_len,
        rt if rt is not None else _loopback_rt(), overlap, prefill_kv_int8,
        ship_fault, poll_timeout_s))


class _WireSlots(_FixedSlots):
    """Fixed int8 slots seated from the wire: a handoff's assembled rows
    land in their slot by ``scatter_fn``. The slot cache is a plain dict,
    so the step runs eagerly."""

    def fresh(self, rebuild=False):
        return dict(seat_slots(self.family.init_kv_cache(
            self.cfg, self.n_slots, self.max_len, kv_int8=True,
            device=self.dev)))

    def land(self, b, rid, one, S):
        """Scatter a handoff's rows (on the device) into slot ``b``."""
        self.slots = self.scatter_fn(self.slots, one, b, S)
        reqlog.emit("seat", rid, slot=b, pos=S)


class _LoopbackSlots(_WireSlots):
    """The loopback server's slots: each seat is a real wire handoff
    (descriptor exchange and partitioned round over the loopback
    transport). The decode step is the monolithic one, and the wire
    carries the codes the monolithic prefill would have made: hence the
    equal tokens."""

    def __init__(self, loop, server_fns, params, cfg, family, max_len, rt,
                 overlap, prefill_kv_int8, ship_fault, poll_timeout_s):
        super().__init__(loop, server_fns, family, cfg, max_len, True)
        self.pfns = make_layerwise_prefill_fns(params, cfg, family)
        self.shipper = KvShipper(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)
        self.receiver = KvReceiver(rt, cfg.n_layers, cfg.n_heads,
                                   cfg.head_dim)
        self.rt, self.overlap = rt, overlap
        self.prefill_kv_int8, self.ship_fault = prefill_kv_int8, ship_fault
        self.poll_timeout_s = poll_timeout_s
        self.handoffs: List[HandoffTelemetry] = []

    def seat(self, b, rid, prompt):
        """The prefill side's layer loop publishes into the loopback
        channel, the decode side splices and scatters (the role-split
        fleet's wire path, serialized in one process)."""
        rt, cfg = self.rt, self.cfg
        S = len(prompt)
        tokens = torch.from_numpy(
            _bucketed(prompt, self.max_len, cfg.max_seq)).to(self.dev)
        send_ch = self.shipper.channel(rt.rank, tokens.shape[1])
        recv_ch = self.receiver.channel(rt.rank, tokens.shape[1])
        try:
            first, prefill_s, expose_s = _prefill_ship(
                rt, send_ch, rt.rank, rid, tokens, S, self.pfns, cfg,
                self.overlap, self.prefill_kv_int8, self.ship_fault,
                recv_ch)
            t_ship = time.perf_counter()
            one = _splice_poll(recv_ch, tokens.shape[1], cfg.n_heads,
                               cfg.head_dim, timeout_s=self.poll_timeout_s)
            send_ch.finish()
            recv_ch.finish()
            ship_s = time.perf_counter() - t_ship
            t_pick = time.perf_counter()
            self.land(b, rid, _host_to(one, self.dev), S)
            pickup_s = time.perf_counter() - t_pick
        except Exception:
            _abort_rounds(send_ch, recv_ch)
            raise
        self.handoffs.append(HandoffTelemetry(
            rid=rid, layers=cfg.n_layers,
            wire_bytes=cfg.n_layers * send_ch.geom.part_bytes,
            prefill_s=prefill_s, ship_s=ship_s, pickup_s=pickup_s,
            overlap=self.overlap, expose_s=expose_s))
        return first

    def metrics(self, fields):
        return _disagg_metrics(fields, self.handoffs)

    def finish(self, batch):
        self.shipper.close()
        self.receiver.close()


# -- fleet-mode role workers (under acxrun, $ACX_ROLE set) -------------------


def _fleet_split(rt):
    roles = fleet_roles(rt.size)
    return ([r for r, ro in enumerate(roles) if ro == "prefill"],
            [r for r, ro in enumerate(roles) if ro == "decode"])


def run_prefill_worker(rt, params, cfg, prompts, max_len, family=None,
                       overlap: bool = True, prefill_kv_int8: bool = False,
                       device=None) -> int:
    """A prefill rank's loop on ``device`` (``None`` means the GPU): for
    every request it owns (rid -> prefill rank ``rid % n_prefill``, decode
    rank ``rid % n_decode``), run the layerwise prompt pass and ship it. A
    respawned rank reruns the loop from rid 0; the decode side drops the
    duplicates. Returns the number of handoffs shipped."""
    family, dev = _family_on(family, params, device)
    prefill_ranks, decode_ranks = _fleet_split(rt)
    me = prefill_ranks.index(rt.rank)
    pfns = make_layerwise_prefill_fns(params, cfg, family)
    shipper = KvShipper(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)
    my_rids = [rid for rid in range(len(prompts))
               if rid % len(prefill_ranks) == me]
    for depth, rid in enumerate(my_rids):
        # The prefill rank is the fleet's entry: its admit/queue events
        # open the journeys the decode rank's finish closes.
        reqlog.emit("admit", rid, prompt_len=len(prompts[rid]))
        reqlog.emit("queue", rid, depth=depth)
    shipped = 0
    for rid in my_rids:
        dst = decode_ranks[rid % len(decode_ranks)]
        tokens = torch.from_numpy(
            _bucketed(prompts[rid], max_len, cfg.max_seq)).to(dev)
        ch = shipper.channel(dst, tokens.shape[1])
        spanned = _span_app_begin_best_effort(rid)
        try:
            _prefill_ship(rt, ch, dst, rid, tokens, len(prompts[rid]), pfns,
                          cfg, overlap, prefill_kv_int8)
            ch.finish()
            shipped += 1
        finally:
            if spanned:
                _span_app_end_best_effort()
    shipper.close()
    return shipped


def run_decode_worker(rt, params, cfg, prompts, n_new, n_slots, max_len,
                      family=None, eos=None, chunk: int = 1,
                      server_fns=None, max_request_retries: int = 2,
                      poll_timeout_s: float = 30.0,
                      page_tokens: int = None, n_pages: int = None,
                      device=None) -> ServedBatch:
    """A decode rank's loop on ``device`` (``None`` means the GPU): take
    the prefill rank's handoffs, splice them into slot caches, generate.
    Returns a ServedBatch with this rank's requests (None elsewhere).

    ``page_tokens`` serves from the paged pool (models/kvpage.py) instead
    of fixed slots: a handoff's bucket rows land in fresh pages (the wire
    already carries the pool's int8 codes and f32 scales, so the splice is
    a page scatter) and the request's whole page budget (prompt + n_new +
    chunk) is reserved when it is seated, so a later arrival cannot starve
    it. The outputs equal the fixed-slot worker's.

    A handoff that dies mid-flight (the prefill rank killed) is requeued,
    uncharged when the failure is shaped like peer loss, and a respawned
    prefill rank's re-ship satisfies it; re-shipped duplicates of requests
    already served are drained and dropped."""
    family, dev = _family_on(family, params, device)
    prefill_ranks, decode_ranks = _fleet_split(rt)
    if len(prefill_ranks) != 1:
        raise NotImplementedError("a decode rank takes handoffs from one "
                                  "prefill rank")
    src = prefill_ranks[0]
    my_rids = [rid for rid in range(len(prompts))
               if decode_ranks[rid % len(decode_ranks)] == rt.rank]
    # The serve loop's queue holds the requests awaiting their handoff;
    # they are seated in the order the wire brings them.
    loop = _Loop(prompts, n_new, n_slots, eos, chunk, dev,
                 max_request_retries, rids=my_rids)
    if page_tokens is None:
        store = _WireSlots(loop, _server_fns(server_fns, params, cfg, family,
                                             chunk, True, None),
                           family, cfg, max_len, True)
    else:
        pt = int(page_tokens)
        store = _PagedSlots(loop, params, cfg, family, max_len, True, pt,
                            n_slots * (max_len // pt) if n_pages is None
                            else n_pages, False)
    loop.server = store
    receiver = KvReceiver(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)
    handoffs: List[HandoffTelemetry] = []

    def awaiting(rid):
        return rid in [r for r, _ in loop.queue]

    def intake(b) -> bool:
        """Take the next inbound handoff and seat it in slot ``b`` (True);
        False for a dropped duplicate or a failed handoff (requeued: the
        re-ship will satisfy it)."""
        hdr = np.zeros(4, np.int64)
        recv_ch = None
        rid = -1
        try:
            rt.wait(rt.irecv_enqueue(hdr, source=src, tag=DESC_HDR_TAG))
            assert int(hdr[0]) == _HDR_MAGIC, hdr
            rid, S, bucket = int(hdr[1]), int(hdr[2]), int(hdr[3])
            reqlog.emit("ship_hdr", rid, side="recv", bucket=bucket, src=src)
            recv_ch = receiver.channel(src, bucket)
            recv_ch.begin()
            one = _splice_poll(recv_ch, bucket, cfg.n_heads, cfg.head_dim,
                               timeout_s=poll_timeout_s)
            fin = np.zeros(5, np.int64)
            rt.wait(rt.irecv_enqueue(fin, source=src, tag=DESC_FIN_TAG))
            assert (int(fin[0]) == _FIN_MAGIC
                    and int(fin[1]) == rid), (fin, rid)
            reqlog.emit("ship_fin", rid, side="recv", src=src)
            recv_ch.finish()
            if not awaiting(rid):
                return False      # a re-ship's duplicate: drained, dropped
            t_pick = time.perf_counter()
            store.land(b, rid, _host_to(one, dev), S)
            pickup_s = time.perf_counter() - t_pick
        except Exception as exc:  # noqa: BLE001 — any handoff failure
            # The flight dump is the trail tools/acx_doctor.py reads the
            # dead link from: take it before healing.
            if loop.hang_dumps == 0 and _flight_dump_best_effort():
                loop.hang_dumps += 1
            _abort_rounds(None, recv_ch)
            if awaiting(rid):
                del loop.queue[[r for r, _ in loop.queue].index(rid)]
                loop._requeue(rid, exc, charge=not _peer_dead(exc))
            elif rid < 0 and not _peer_dead(exc):
                raise
            return False
        del loop.queue[[r for r, _ in loop.queue].index(rid)]
        loop.take_seat(b, rid, int(fin[2]))
        handoffs.append(HandoffTelemetry(
            rid=rid, layers=cfg.n_layers,
            wire_bytes=cfg.n_layers * recv_ch.geom.part_bytes,
            prefill_s=int(fin[3]) / 1e6, ship_s=0.0, pickup_s=pickup_s,
            overlap=True, expose_s=int(fin[4]) / 1e6))
        return True

    with profiling.annotate("acx.serve.call"):
        loop.t0 = time.perf_counter()
        while loop.busy() or loop.queue:
            with profiling.annotate("acx.serve.round"):
                loop.note_gauges()
                # Seat inbound handoffs on every free slot before stepping.
                # Paged: the growth finds the whole budget reserved there.
                loop.seed_idle_slots(intake)
                if loop.busy():
                    loop.advance(refill=False)
    receiver.close()
    return ServedBatch(loop.done, _disagg_metrics(loop.fields(), handoffs))
