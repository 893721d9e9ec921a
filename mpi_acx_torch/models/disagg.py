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
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mpi_acx_torch import reqlog
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models.serving import (
    RequestTelemetry, RollingSLO, ServedBatch, ServingMetrics,
    _bucket, _flight_dump_best_effort, _normalize_requests, _pct,
    _peer_dead, _span_app_begin_best_effort, _span_app_end_best_effort,
    _tseries_annotate_best_effort, make_server_fns)
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


def _finish_handoff_metrics(m: DisaggMetrics) -> DisaggMetrics:
    m.handoff_prefill_p50_s = _pct([h.prefill_s for h in m.handoffs], 0.5)
    m.handoff_ship_p50_s = _pct([h.ship_s for h in m.handoffs], 0.5)
    m.handoff_pickup_p50_s = _pct([h.pickup_s for h in m.handoffs], 0.5)
    return m


def _disagg_metrics(rids, emitted, ttft, finish, attempts, t0, itl_samples,
                    handoffs, **counters) -> DisaggMetrics:
    """The metrics of the requests ``rids`` (the per-request records are
    indexed by rid)."""
    wall = time.perf_counter() - t0
    per_request = []
    for rid in rids:
        nt = len(emitted[rid])
        lat = finish[rid] if finish[rid] is not None else wall
        per_request.append(RequestTelemetry(
            rid=rid, ttft_s=ttft[rid] if ttft[rid] is not None else lat,
            latency_s=lat, new_tokens=nt,
            tokens_per_s=nt / lat if lat > 0 else 0.0,
            retries=attempts[rid]))
    total_new = sum(r.new_tokens for r in per_request)
    return _finish_handoff_metrics(DisaggMetrics(
        requests=len(rids), wall_s=wall, new_tokens=total_new,
        tokens_per_s=total_new / wall if wall > 0 else 0.0,
        ttft_p50_s=_pct([r.ttft_s for r in per_request], 0.50),
        ttft_p99_s=_pct([r.ttft_s for r in per_request], 0.99),
        itl_p50_s=_pct(itl_samples, 0.50),
        itl_p99_s=_pct(itl_samples, 0.99),
        per_request=per_request, handoffs=handoffs, **counters))


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


def _prefill_ship(ch, pfns, cfg, padded, last_index, overlap,
                  prefill_kv_int8, ship_fault=None, rid=0):
    """Run the layerwise prompt pass, publishing layer l's partition as it
    completes (``overlap``) or all of them after the head (the
    ship-after-prefill baseline). The caller has begun the channel round.

    ``prefill_kv_int8`` picks the prefill-side cache variant:
    quantize-at-compute (the prefill holds int8 codes, as a prefill rank
    serving with int8 KV would) or quantize-at-wire (the K/V stay in the
    compute dtype until the pack). The wire bytes are the same.

    ``ship_fault(rid, layer)`` is a test hook called before layer
    ``layer``'s publish: raising from it models a prefill rank dying
    mid-handoff.

    Returns ``(first_token, prefill_s, expose_s)``; ``expose_s`` is the
    publish time left after the head finished (~0 with per-layer overlap,
    the serialized pack and publish without it)."""
    embed_fn, layer_fn, head_fn, quant_fn = pfns
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
    first = int(head_fn(x, last_index)[0, 0].argmax())
    t_head = time.perf_counter()
    for layer, st in enumerate(staged):
        kq, ks, vq, vs = st if len(st) == 4 else _to_host(quant_fn(*st))
        ch.publish(layer, kq[0], ks[0], vq[0], vs[0])
        reqlog.emit("ship_pready", rid, part=layer, overlap=False)
    t1 = time.perf_counter()
    return first, t1 - t0, t1 - t_head


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


def _family(family):
    if family is None:
        from mpi_acx_torch.models import transformer as family  # noqa: N813
    return family


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
    dev = resolve_device(device)
    fam = _family(family)
    _check_dense(fam)
    fam.check_device(params, dev)
    if os.environ.get("ACX_ROLE", "").strip():
        if rt is None:
            raise ValueError("fleet mode needs an explicit Runtime")
        if fleet_roles(rt.size)[rt.rank] == "prefill":
            run_prefill_worker(rt, params, cfg, prompts, max_len,
                               family=fam, overlap=overlap,
                               prefill_kv_int8=prefill_kv_int8, device=dev)
            return ServedBatch([None] * len(prompts),
                               _finish_handoff_metrics(DisaggMetrics()))
        return run_decode_worker(
            rt, params, cfg, prompts, n_new, n_slots, max_len, family=fam,
            eos=eos, chunk=chunk, server_fns=server_fns,
            max_request_retries=max_request_retries,
            poll_timeout_s=poll_timeout_s, device=dev)
    return _serve_disagg_loopback(
        params, cfg, prompts, n_new, n_slots, max_len, fam, eos, chunk,
        server_fns, prefill_kv_int8, max_request_retries,
        rt if rt is not None else _loopback_rt(), overlap, ship_fault,
        poll_timeout_s, dev)


def _check_server_fns(server_fns, params, cfg, family, chunk):
    if server_fns is None:
        server_fns = make_server_fns(params, cfg, family, chunk=chunk,
                                     kv_int8=True)
    (_, step_fn, scatter_fn, fns_chunk, fns_int8, fns_sample) = server_fns
    if fns_chunk != chunk:
        raise ValueError(f"server_fns built for chunk={fns_chunk}, this call "
                         f"uses chunk={chunk}")
    if not fns_int8:
        raise ValueError("disagg decode slots are int8 (the wire form): "
                         "build server_fns with kv_int8=True")
    if fns_sample is not None:
        raise ValueError("disagg serving is greedy")
    return step_fn, scatter_fn


def _serve_disagg_loopback(params, cfg, prompts, n_new, n_slots, max_len,
                           family, eos, chunk, server_fns, prefill_kv_int8,
                           max_request_retries, rt, overlap, ship_fault,
                           poll_timeout_s, dev):
    """The single-process disagg scheduler: models/serving.py's ``_serve``
    with the refill replaced by a real wire handoff (descriptor exchange
    and partitioned round over the loopback transport). The decode loop is
    the monolithic one, and the wire carries the codes the monolithic
    prefill would have made: hence the equal tokens."""
    n_new = _normalize_requests(prompts, n_new)
    for p, n in zip(prompts, n_new):
        if len(p) + n + chunk > min(max_len, cfg.max_seq):
            raise ValueError(f"request of {len(p)} + {n} + chunk {chunk} "
                             f"positions exceeds max_len {max_len} or "
                             f"max_seq {cfg.max_seq}")
    step_fn, scatter_fn = _check_server_fns(server_fns, params, cfg, family,
                                            chunk)
    pfns = make_layerwise_prefill_fns(params, cfg, family)
    shipper = KvShipper(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)
    receiver = KvReceiver(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)

    def fresh_slots():
        s = family.init_kv_cache(cfg, n_slots, max_len, kv_int8=True,
                                 device=dev)
        s["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)
        return s

    slots = fresh_slots()
    queue = deque(enumerate(np.asarray(p, np.int32) for p in prompts))
    for depth, (rid, p) in enumerate(queue):
        reqlog.emit("admit", rid, prompt_len=len(p), n_new=n_new[rid])
        reqlog.emit("queue", rid, depth=depth)
    owner = [-1] * n_slots
    emitted: List[List[int]] = [[] for _ in prompts]
    done: List[Optional[np.ndarray]] = [None] * len(prompts)
    last_tok = np.zeros((n_slots,), np.int32)
    attempts = [0] * len(prompts)

    t0 = time.perf_counter()
    ttft = [None] * len(prompts)
    finish = [None] * len(prompts)
    slo = RollingSLO()
    itl_samples: List[float] = []
    qd_samples: List[int] = []
    occ_samples: List[float] = []
    handoffs: List[HandoffTelemetry] = []
    n_steps = n_prefills = n_requeues = n_peer_requeues = n_hang_dumps = 0

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

    def refill(b):
        """The handoff refill: the prefill side's layer loop publishes
        into the loopback channel, the decode side splices and scatters
        (the role-split fleet's wire path, serialized in one process)."""
        nonlocal slots, n_prefills
        rid, prompt = queue.popleft()
        S = len(prompt)
        bucket = min(_bucket(S), max_len, cfg.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = prompt
        send_ch = shipper.channel(rt.rank, bucket)
        recv_ch = receiver.channel(rt.rank, bucket)
        spanned = _span_app_begin_best_effort(rid)
        reqlog.emit("prefill_start", rid, prompt_len=S, bucket=bucket)
        try:
            # The descriptor: receive posted first, both waited, so a later
            # failure never leaves a dangling descriptor in the stream.
            hdr = np.zeros(4, np.int64)
            hr = rt.irecv_enqueue(hdr, source=rt.rank, tag=DESC_HDR_TAG)
            rt.wait(rt.isend_enqueue(_hdr_wire(rid, S, bucket),
                                     dest=rt.rank, tag=DESC_HDR_TAG))
            rt.wait(hr)
            assert int(hdr[0]) == _HDR_MAGIC and int(hdr[1]) == rid, hdr
            reqlog.emit("ship_hdr", rid, side="loopback", bucket=bucket)
            recv_ch.begin()
            send_ch.begin()
            first, prefill_s, expose_s = _prefill_ship(
                send_ch, pfns, cfg, torch.from_numpy(padded).to(dev), S - 1,
                overlap, prefill_kv_int8, ship_fault=ship_fault, rid=rid)
            reqlog.emit("prefill_end", rid, first_token=first,
                        prefill_s=prefill_s)
            fin = np.zeros(5, np.int64)
            fr = rt.irecv_enqueue(fin, source=rt.rank, tag=DESC_FIN_TAG)
            rt.wait(rt.isend_enqueue(
                _fin_wire(rid, first, int(prefill_s * 1e6),
                          int(expose_s * 1e6)),
                dest=rt.rank, tag=DESC_FIN_TAG))
            rt.wait(fr)
            assert int(fin[0]) == _FIN_MAGIC and int(fin[1]) == rid, fin
            reqlog.emit("ship_fin", rid, side="loopback")
            t_ship = time.perf_counter()
            one = _splice_poll(recv_ch, bucket, cfg.n_heads, cfg.head_dim,
                               timeout_s=poll_timeout_s)
            send_ch.finish()
            recv_ch.finish()
            ship_s = time.perf_counter() - t_ship
            t_pick = time.perf_counter()
            slots = scatter_fn(slots, _host_to(one, dev), b, S)
            pickup_s = time.perf_counter() - t_pick
        except Exception as exc:  # noqa: BLE001 — any handoff failure
            _abort_rounds(send_ch, recv_ch)
            _requeue(rid, prompt, exc, charge=not _peer_dead(exc))
            return False
        finally:
            if spanned:
                _span_app_end_best_effort()
        owner[b] = rid
        reqlog.emit("seat", rid, slot=b, pos=S)
        emitted[rid].append(int(fin[2]))
        last_tok[b] = int(fin[2])
        n_prefills += 1
        ttft[rid] = time.perf_counter() - t0
        slo.note_ttft(ttft[rid])
        reqlog.emit("stream", rid, n=1, ttft_s=ttft[rid])
        handoffs.append(HandoffTelemetry(
            rid=rid, layers=cfg.n_layers,
            wire_bytes=cfg.n_layers * send_ch.geom.part_bytes,
            prefill_s=prefill_s, ship_s=ship_s, pickup_s=pickup_s,
            overlap=overlap, expose_s=expose_s))
        return True

    def retire(b):
        rid = owner[b]
        done[rid] = np.concatenate([np.asarray(prompts[rid], np.int32),
                                    np.asarray(emitted[rid], np.int32)])
        finish[rid] = time.perf_counter() - t0
        reqlog.emit("finish", rid, new_tokens=len(emitted[rid]),
                    latency_s=finish[rid])
        owner[b] = -1
        slots["pos"][b] = 0

    def slot_finished(b):
        rid = owner[b]
        return (len(emitted[rid]) >= n_new[rid]
                or (eos is not None and emitted[rid]
                    and emitted[rid][-1] == eos))

    def seed_idle_slots():
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
        _tseries_annotate_best_effort(slo.live_slos())
        if not any(o >= 0 for o in owner):
            seed_idle_slots()
            continue
        step_t0 = time.perf_counter()
        try:
            slots, toks = step_fn(slots, torch.from_numpy(last_tok).to(dev))
            block = toks.cpu().numpy()               # [chunk, B]; syncs
        except Exception as exc:  # noqa: BLE001 — any device failure
            lost_peer = _peer_dead(exc)
            if _flight_dump_best_effort():
                n_hang_dumps += 1
            for b in range(n_slots):
                if owner[b] >= 0:
                    rid = owner[b]
                    owner[b] = -1
                    _requeue(rid, np.asarray(prompts[rid], np.int32), exc,
                             charge=not lost_peer)
            slots = fresh_slots()
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
    shipper.close()
    receiver.close()
    metrics = _disagg_metrics(
        range(len(prompts)), emitted, ttft, finish, attempts, t0,
        itl_samples, handoffs, steps=n_steps, prefills=n_prefills,
        requeues=n_requeues, peer_requeues=n_peer_requeues,
        hang_dumps=n_hang_dumps, queue_depth_max=max(qd_samples),
        queue_depth_mean=sum(qd_samples) / len(qd_samples),
        slot_occupancy_mean=(sum(occ_samples) / len(occ_samples)
                             if occ_samples else 1.0))
    return ServedBatch(done, metrics)


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
    dev = resolve_device(device)
    family = _family(family)
    family.check_device(params, dev)
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
        prompt = np.asarray(prompts[rid], np.int32)
        S = len(prompt)
        bucket = min(_bucket(S), max_len, cfg.max_seq)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :S] = prompt
        ch = shipper.channel(dst, bucket)
        spanned = _span_app_begin_best_effort(rid)
        reqlog.emit("prefill_start", rid, prompt_len=S, bucket=bucket)
        try:
            rt.wait(rt.isend_enqueue(_hdr_wire(rid, S, bucket), dest=dst,
                                     tag=DESC_HDR_TAG))
            reqlog.emit("ship_hdr", rid, side="send", bucket=bucket,
                        dst=dst)
            ch.begin()
            first, prefill_s, expose_s = _prefill_ship(
                ch, pfns, cfg, torch.from_numpy(padded).to(dev), S - 1,
                overlap, prefill_kv_int8, rid=rid)
            reqlog.emit("prefill_end", rid, first_token=first,
                        prefill_s=prefill_s)
            rt.wait(rt.isend_enqueue(
                _fin_wire(rid, first, int(prefill_s * 1e6),
                          int(expose_s * 1e6)), dest=dst, tag=DESC_FIN_TAG))
            reqlog.emit("ship_fin", rid, side="send", dst=dst)
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
    from mpi_acx_torch.models import kvpage
    dev = resolve_device(device)
    family = _family(family)
    family.check_device(params, dev)
    prefill_ranks, decode_ranks = _fleet_split(rt)
    if len(prefill_ranks) != 1:
        raise NotImplementedError("a decode rank takes handoffs from one "
                                  "prefill rank")
    src = prefill_ranks[0]
    n_new = ([int(n_new)] * len(prompts) if np.ndim(n_new) == 0
             else [int(n) for n in n_new])
    my_rids = [rid for rid in range(len(prompts))
               if decode_ranks[rid % len(decode_ranks)] == rt.rank]

    paged = page_tokens is not None
    slots = None
    if paged:
        pt = int(page_tokens)
        if n_pages is None:
            n_pages = n_slots * (max_len // pt)
        pkv = kvpage.PagedKV(cfg, family, n_slots, max_len, pt, n_pages,
                             kv_int8=True, device=dev)
        step_fn = kvpage.make_paged_step_fn(params, cfg, family, chunk, pt)
    else:
        step_fn, scatter_fn = _check_server_fns(server_fns, params, cfg,
                                                family, chunk)
        slots = family.init_kv_cache(cfg, n_slots, max_len, kv_int8=True,
                                     device=dev)
        slots["pos"] = torch.zeros((n_slots,), dtype=torch.int32, device=dev)

    receiver = KvReceiver(rt, cfg.n_layers, cfg.n_heads, cfg.head_dim)
    owner = [-1] * n_slots
    emitted = {rid: [] for rid in my_rids}
    done: List[Optional[np.ndarray]] = [None] * len(prompts)
    last_tok = np.zeros((n_slots,), np.int32)
    attempts = {rid: 0 for rid in my_rids}
    pending = set(my_rids)       # not yet retired
    seated = set()               # owning a slot now

    t0 = time.perf_counter()
    ttft = {rid: None for rid in my_rids}
    finish = {rid: None for rid in my_rids}
    handoffs: List[HandoffTelemetry] = []
    itl_samples: List[float] = []
    n_steps = n_prefills = n_requeues = n_peer_requeues = n_hang_dumps = 0

    def _note_failure(rid, exc):
        nonlocal n_requeues, n_peer_requeues
        charge = not _peer_dead(exc)
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

    def seat(b, rid, one, S):
        """Land the handoff in slot ``b``: fixed slots by ``scatter_fn``,
        pages by the pool's scatter after reserving the whole budget."""
        nonlocal slots
        if not paged:
            slots = scatter_fn(slots, one, b, S)
            reqlog.emit("seat", rid, slot=b, pos=S)
            return
        need = kvpage.pages_needed(S + n_new[rid] + chunk, pt)
        pages = pkv.alloc_evicting(need)
        if pages is None:
            raise RuntimeError(
                f"decode rank {rt.rank}: page pool dry seating rid={rid} "
                f"(need {need} pages, {pkv.alloc.free_count} free): size "
                "n_pages to n_slots*max_len/page_tokens")
        try:
            pkv.scatter_prompt(one, pages[:kvpage.pages_needed(S, pt)])
            pkv.seat(b, [], pages, S, rid=rid)
        except Exception:
            for p in pages:
                pkv.alloc.decref(p)
            raise

    def intake(b) -> bool:
        """Take the next inbound handoff and seat it in slot ``b`` (True);
        False for a dropped duplicate or a failed handoff (requeued: the
        re-ship will satisfy it)."""
        nonlocal n_prefills, n_hang_dumps
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
            if rid not in pending or rid in seated:
                return False      # a re-ship's duplicate: drained, dropped
            t_pick = time.perf_counter()
            seat(b, rid, _host_to(one, dev), S)
            pickup_s = time.perf_counter() - t_pick
        except Exception as exc:  # noqa: BLE001 — any handoff failure
            # The flight dump is the trail tools/acx_doctor.py reads the
            # dead link from: take it before healing.
            if n_hang_dumps == 0 and _flight_dump_best_effort():
                n_hang_dumps += 1
            _abort_rounds(None, recv_ch)
            if rid in pending and rid not in seated:
                _note_failure(rid, exc)
            elif rid < 0 and not _peer_dead(exc):
                raise
            return False
        owner[b] = rid
        seated.add(rid)
        first = int(fin[2])
        emitted[rid].append(first)
        last_tok[b] = first
        n_prefills += 1
        ttft[rid] = time.perf_counter() - t0
        reqlog.emit("stream", rid, n=1, ttft_s=ttft[rid])
        handoffs.append(HandoffTelemetry(
            rid=rid, layers=cfg.n_layers,
            wire_bytes=cfg.n_layers * recv_ch.geom.part_bytes,
            prefill_s=int(fin[3]) / 1e6, ship_s=0.0, pickup_s=pickup_s,
            overlap=True, expose_s=int(fin[4]) / 1e6))
        return True

    def retire(b):
        rid = owner[b]
        done[rid] = np.concatenate([np.asarray(prompts[rid], np.int32),
                                    np.asarray(emitted[rid], np.int32)])
        finish[rid] = time.perf_counter() - t0
        reqlog.emit("finish", rid, new_tokens=len(emitted[rid]),
                    latency_s=finish[rid])
        pending.discard(rid)
        seated.discard(rid)
        owner[b] = -1
        if paged:
            pkv.release(b)        # pages back to the pool, slot parked
        else:
            slots["pos"][b] = 0

    def slot_finished(b):
        rid = owner[b]
        return (len(emitted[rid]) >= n_new[rid]
                or (eos is not None and emitted[rid]
                    and emitted[rid][-1] == eos))

    while pending:
        # Seat inbound handoffs on every free slot before stepping.
        while len(seated) < len(pending) and any(o == -1 for o in owner):
            b = owner.index(-1)
            if intake(b) and slot_finished(b):
                retire(b)
        if not any(o >= 0 for o in owner):
            continue
        step_t0 = time.perf_counter()
        tok = torch.from_numpy(last_tok).to(dev)
        if paged:
            state, toks = step_fn(pkv.device_state(), tok)
            block = toks.cpu().numpy()               # [chunk, B]; syncs
            pkv.absorb(state, chunk)
            kvpage.publish_page_stats_best_effort(
                pkv.alloc.free_count, pkv.alloc.shared_count(), 0, 0, 0)
        else:
            slots, toks = step_fn(slots, tok)
            block = toks.cpu().numpy()
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
                emitted[owner[b]].append(int(block[c, b]))
                itl_samples.append(step_dt / chunk)
                got += 1
            if got:
                reqlog.emit("stream", owner[b], n=got, itl_s=step_dt / chunk)
        for b in range(n_slots):
            if owner[b] >= 0 and slot_finished(b):
                retire(b)

    receiver.close()
    metrics = _disagg_metrics(
        my_rids, emitted, ttft, finish, attempts, t0, itl_samples, handoffs,
        steps=n_steps, prefills=n_prefills, requeues=n_requeues,
        peer_requeues=n_peer_requeues, hang_dumps=n_hang_dumps)
    return ServedBatch(done, metrics)
