"""Shared decode scaffold (the JAX package's ``models/decoding.py``).

``transformer.generate`` is :func:`greedy_generate` closed over the
model's prefill and decode step; a family's decode step runs its layers
through :func:`run_decode_step`, the tp steps through
:func:`run_decode_layers`. JAX's ``lax.scan`` loops are Python
loops here, and the KV cache is updated IN PLACE: where the JAX functions
return new cache arrays, these write the fresh K/V rows into the caller's
cache tensors with indexed copies and return the same tensors. An int8
cache (``'ks'``/``'vs'`` scale buffers beside int8 ``'k'``/``'v'``) is
quantized as it is written (ops/kvquant.py).

Sampling (:func:`sample_logits`, :func:`sample_generate`) takes an
explicit ``torch.Generator`` where the JAX functions take a PRNG key: the
draws of one generator follow each other as the JAX package's ``split``
chain does. The two packages' random streams differ, so what is held to
the JAX package is the deterministic part, :func:`filter_logits`, and the
draw's formula: the Gumbel-max draw ``argmax(filtered + g)`` with ``g =
-log(-log(u))``, u uniform in ``[tiny, 1)``, as ``jax.random.gumbel``
forms it.
"""

from __future__ import annotations

import contextlib
from types import SimpleNamespace
from typing import Callable, NamedTuple, Optional

import torch

from mpi_acx_torch import profiling
from mpi_acx_torch.ops.flash_decode import (dense_decode_attend,  # noqa: F401
                                            select_decode_attend)
from mpi_acx_torch.ops.kvquant import kv_quant


def grouped_decode_attend(q, kc, vc, pos, max_len, n_rep, flash=None,
                          out=None):
    """W-token grouped-query attention against an un-repeated KV cache:
    q [B, W, Hq, D] at positions pos..pos+W-1, kc/vc [B, max_len, Hkv, D]
    with Hq = Hkv*n_rep -> [B, W, Hq*D], written into ``out`` when given.
    ``flash`` is the ``decode_flash`` config switch
    (:func:`select_decode_attend`): ``True``/``None`` -> the decode kernel
    on a CUDA tensor (its plain version on a CPU tensor), ``False`` ->
    :func:`dense_decode_attend`."""
    return select_decode_attend(flash)(q, kc, vc, pos, max_len, n_rep,
                                       out=out)


def decode_layer_scan(layers, x, kc_all, vc_all, pos, qkv_fn, attend_fn,
                      ksc_all=None, vsc_all=None):
    """The decode layer loop: for each layer i, ``qkv_fn(lp, x, pos) ->
    (q, k, v)`` with k/v [B, W, H, D] (a window of W tokens at positions
    pos..pos+W-1; W = 1 is the one-token step), the fresh k/v rows written
    into ``kc_all[i]``/``vc_all[i]`` ([L, B, max_len, H, D]) at each
    slot's position, then ``attend_fn(lp, x, q, kc_l, vc_l, pos) -> x``
    against the updated layer cache. Returns (x, kc_all, vc_all).

    ``pos`` is a scalar (every row at one position) or [B] (one position
    per slot, continuous-batching serving and the batched speculative
    loop). The writes go in place; as in JAX's ``dynamic_update_slice``,
    a write that would run past the cache starts at ``max_len - W``
    instead (``attend_fn`` still gets the unclamped ``pos``).

    With ``ksc_all``/``vsc_all`` ([L, B, max_len, H, 1] f32) the cache is
    int8 (ops/kvquant.py): the fresh K/V rows are quantized as they are
    written, their scales land beside the codes, ``attend_fn`` receives
    ``(codes, scales)`` tuples, and the return is (x, kc, vc, ksc, vsc)."""
    n_layers = next(iter(layers.values())).shape[0]
    pos = torch.as_tensor(pos, device=x.device)
    slots = torch.arange(kc_all.shape[1], device=x.device)[:, None]
    for i in range(n_layers):
        lp = {name: a[i] for name, a in layers.items()}
        q, k, v = qkv_fn(lp, x, pos)
        kc_l, vc_l = _write_rows(i, k, v, kc_all, vc_all, ksc_all, vsc_all,
                                 pos, slots)
        x = attend_fn(lp, x, q, kc_l, vc_l, pos)
    if ksc_all is not None:
        return x, kc_all, vc_all, ksc_all, vsc_all
    return x, kc_all, vc_all


def _write_rows(i, k, v, kc_all, vc_all, ksc_all, vsc_all, pos, slots):
    """Layer i's fresh K/V rows (k/v [B, W, H, D]) written in place at
    each slot's position (clamped to ``max_len - W``), quantized when the
    cache is int8 (``ksc_all`` given). Returns layer i's cache as the
    decode attention takes it: tensors, or ``(codes, scales)`` pairs. A
    latent cache (``vc_all`` None: one row a token that every head
    shares, models/deepseek_v2.py) takes ``k`` alone and returns
    ``(kc_all[i], None)``."""
    B, max_len, W = kc_all.shape[1], kc_all.shape[2], k.shape[1]
    rows = (pos.clamp(0, max_len - W).reshape(-1, 1).expand(B, 1)
            + torch.arange(W, device=k.device))            # [B, W]
    return _put_rows(i, k, v, kc_all, vc_all, ksc_all, vsc_all, slots, rows)


def _put_rows(i, k, v, kc_all, vc_all, ksc_all, vsc_all, slots, rows):
    """:func:`_write_rows` at given rows: k/v [B, W, H, D] land in layer
    i at ``[slots, rows]`` (index tensors broadcasting to [B, W])."""
    if vc_all is None:
        kc_all[i][slots, rows] = k
        return kc_all[i], None
    if ksc_all is not None:
        k, ks = kv_quant(k)
        v, vs = kv_quant(v)
        ksc_all[i][slots, rows] = ks
        vsc_all[i][slots, rows] = vs
    kc_all[i][slots, rows] = k
    vc_all[i][slots, rows] = v
    if ksc_all is not None:
        return (kc_all[i], ksc_all[i]), (vc_all[i], vsc_all[i])
    return kc_all[i], vc_all[i]


def fill_kv_cache(cache, ks, vs, pos):
    """Land the prefill K/V ([L, B, S, H, D], compute dtype) at the start
    of a fresh cache from ``init_kv_cache`` and set ``pos`` (in place),
    quantizing when the cache is int8 (``'ks'`` present)."""
    S = ks.shape[2]
    if "ks" in cache:
        ks, kscale = kv_quant(ks)
        vs, vscale = kv_quant(vs)
        cache["ks"][:, :, :S] = kscale
        cache["vs"][:, :, :S] = vscale
    cache["k"][:, :, :S] = ks
    cache["v"][:, :, :S] = vs
    cache["pos"] = torch.full((), pos, dtype=torch.int32,
                              device=cache["k"].device)
    return cache


def run_decode_layers(layers, x, cache, qkv_fn, attend_fn):
    """:func:`decode_layer_scan` over a cache dict (bf16/f32 or int8, which
    ``'ks'`` selects), returning ``(x, cache')`` where ``cache'`` shares
    the updated tensors and carries ``pos`` advanced by the one decoded
    token."""
    pos = cache["pos"]
    if "ks" in cache:
        x, kc, vc, ksc, vsc = decode_layer_scan(
            layers, x, cache["k"], cache["v"], pos, qkv_fn, attend_fn,
            ksc_all=cache["ks"], vsc_all=cache["vs"])
        return x, {"k": kc, "v": vc, "ks": ksc, "vs": vsc, "pos": pos + 1}
    x, kc, vc = decode_layer_scan(layers, x, cache["k"], cache["v"], pos,
                                  qkv_fn, attend_fn)
    return x, {"k": kc, "v": vc, "pos": pos + 1}


class StepParts(NamedTuple):
    """A family's decode step in the pieces :func:`run_decode_step` runs:

    * ``embed(token [B], pos) -> x [B, 1, d]``;
    * ``qkv(lp, x, pos) -> (q, k, v)``, k/v ``[B, 1, Hkv, D]``;
    * ``attend(q, kc, vc, pos, out=None) -> o``: the decode attention, K2
      on a CUDA tensor, as the family looks it up when called;
    * ``post(lp, x, o) -> x``: the output projection, residual and FFN;
    * ``head(x) -> logits [B, vocab]`` (f32);
    * ``layers() -> [dict]``: the per-layer parameter dicts the step
      walks, where the family's layers are not one stacked
      ``params['layers']`` (layers of more than one kind,
      models/deepseek_v2.py); ``None`` otherwise. Called only when the
      step runs eagerly or captures, so a replayed step builds none.

    A latent cache (no ``'v'``: one row a token that every head shares)
    has ``qkv`` return ``(q, row, None)`` and ``attend`` take ``vc``
    None."""

    embed: Callable
    qkv: Callable
    attend: Callable
    post: Callable
    head: Callable
    layers: Optional[Callable] = None


def run_decode_step(params, cache, token, parts: StepParts, key):
    """One decode step of a family from its ``parts``: ``(logits [B,
    vocab], cache')``. A slot cache seated by the serve loop
    (:class:`SlotCache`) steps through its :class:`DecodeGraphs`, which
    advances ``pos`` in place and returns that cache; any other cache runs
    the same segments eagerly and gets a new dict that shares the updated
    tensors and carries ``pos + 1``. ``key`` names what a capture rests
    on besides tensors (the config, the FFN)."""
    graphs = getattr(cache, "graphs", None)
    if graphs is not None:
        return graphs.step(params, cache, token, parts, key)
    out = dict(cache)
    out["pos"] = cache["pos"].clone()
    return _eager(_step_layers(params, parts), out, token, parts)[0], out


class SlotCache(dict):
    """A dense slot cache as the serve loop seats it (models/serving.py):
    the cache dict, ``pos`` [B] one position a slot, ``graphs``, the
    capture state of the decode step over it, and ``prefills``, that of
    the prompt passes into its slots. Any other cache is a plain dict and
    decodes eagerly."""

    def __init__(self, cache):
        super().__init__(cache)
        self.graphs = DecodeGraphs()
        self.prefills = PrefillGraphs()

    def drop_captures(self) -> None:
        """Forget the decode and prefill captures (after a failure)."""
        self.graphs.drop()
        self.prefills.drop()


def _layers(layers):
    n = next(iter(layers.values())).shape[0]
    return [{name: a[i] for name, a in layers.items()} for i in range(n)]


def _step_layers(params, parts):
    """The per-layer parameter dicts a step walks."""
    if parts.layers is not None:
        return parts.layers()
    return _layers(params["layers"])


def _eager(lps, cache, tok, parts):
    """The segments of :class:`DecodeGraphs` and their K2 calls in order,
    eagerly: (logits, the last K2 output); advances ``pos`` in place."""
    x = o = None
    with profiling.annotate("acx.model.layers"):
        for i in range(len(lps)):
            x, q = _segment(parts, lps, cache, i, tok, x, o)
            o = parts.attend(q, *_layer_cache(cache, i), cache["pos"])
    with profiling.annotate("acx.model.head"):
        logits = _segment(parts, lps, cache, len(lps), tok, x, o)[1]
    return logits, o


def _ptrs(tree):
    """The data pointers of a dict tree of tensors, in its order."""
    if isinstance(tree, dict):
        return tuple(_ptrs(t) for t in tree.values())
    return tree.data_ptr()


def _layer_cache(cache, i):
    """Layer i of a cache dict as the decode attention takes it."""
    if "v" not in cache:
        return cache["k"][i], None
    if "ks" in cache:
        return ((cache["k"][i], cache["ks"][i]),
                (cache["v"][i], cache["vs"][i]))
    return cache["k"][i], cache["v"][i]


def _segment(parts, lps, cache, i, tok, x, o):
    """Segment i of the step (:class:`DecodeGraphs`): from layer i-1's K2
    output ``o`` (or the token, for i = 0) to ``(x, q)`` ready for layer
    i's K2, or ``(x, logits)`` for i = L, which also advances ``pos``."""
    pos = cache["pos"]
    x = parts.embed(tok, pos) if i == 0 else parts.post(lps[i - 1], x, o)
    if i == len(lps):
        logits = parts.head(x)
        pos.add_(1)
        return x, logits
    q, k, v = parts.qkv(lps[i], x, pos)
    slots = torch.arange(cache["k"].shape[1], device=x.device)[:, None]
    _write_rows(i, k, v, cache["k"], cache.get("v"), cache.get("ks"),
                cache.get("vs"), pos, slots)
    return x, q


class _Captures:
    """What :class:`DecodeGraphs` and :class:`PrefillGraphs` share: the
    counters ``replayed``, ``eager`` and ``captures``, the key a capture
    rests on, and the capture of a pass's segments on a side stream."""

    def __init__(self):
        self.replayed = self.eager = self.captures = 0
        self._side = None
        self.drop()

    @staticmethod
    def _key_of(key, params, cache, t):
        """What a capture rests on: the family's ``key``, the parameters'
        and the cache's pointers and the input's dtype."""
        return (key, _ptrs(params), _ptrs(cache), t.dtype)

    @contextlib.contextmanager
    def _on_side(self, dev):
        """The block on the side stream, after what the current stream
        holds, and the current stream after the block; yields the current
        stream."""
        cur = torch.cuda.current_stream(dev)
        if self._side is None:
            self._side = torch.cuda.Stream(dev)
        self._side.wait_stream(cur)
        try:
            with torch.cuda.stream(self._side):
                yield cur
        finally:
            cur.wait_stream(self._side)

    @staticmethod
    def _capture_segments(n, segment):
        """CUDA graphs of ``segment(i, x) -> (x, y)`` for i = 0..n-1, each
        fed the x of the one before, in a memory pool of their own:
        (graphs, the y of each)."""
        # The graphs replay in the order they were captured, so one may
        # reuse pool memory an earlier one is done with.
        pool = torch.cuda.graph_pool_handle()
        graphs, ys, x = [], [], None
        for i in range(n):
            g = torch.cuda.CUDAGraph()
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                x, y = segment(i, x)
            finally:
                g.capture_end()
            graphs.append(g)
            ys.append(y)
        return graphs, ys


class DecodeGraphs(_Captures):
    """The decode step over one served slot cache, replayed from CUDA
    graphs between its K2 calls, and how often that engaged.

    The step splits at its L decode-attention (K2) calls into L + 1
    segments: segment 0 is the embedding and layer 0's norm, QKV and
    cache write; segment i (0 < i < L) is layer i-1's output projection,
    residual and FFN, then layer i's norm, QKV and cache write; segment L
    is the last layer's output projection and FFN, the final norm, the
    unembedding and the advance of ``pos``, in place. K2 runs eagerly
    between them, on static buffers, through the family's ``attend`` as
    it is looked up at each call, so its launches stay visible one by one
    and its ``out`` is the buffer the next segment reads.

    On a CUDA cache the first step runs the segments eagerly on a side
    stream (the warm step, whose results are the step's), then captures
    each segment into a CUDA graph, all in one memory pool; later steps
    copy the token in and replay. The returned logits are then a buffer
    the next step overwrites. A capture holds while the parameters, the
    cache, ``pos``, the token's shape and dtype and the family's ``key``
    stay the same; :meth:`drop` forgets it. On a CPU cache every step runs
    the segments eagerly, in the same order. ``replayed``, ``eager`` and
    ``captures`` count the steps replayed, the steps run eagerly and the
    captures made."""

    def drop(self) -> None:
        """Forget the capture: the next step on CUDA captures anew."""
        self._key = None
        self._graphs = []
        self._io = None

    def step(self, params, cache, token, parts: StepParts, key):
        with torch.no_grad():
            if not cache["k"].is_cuda:
                self.eager += 1
                return _eager(_step_layers(params, parts), cache, token,
                              parts)[0], cache
            key = self._key_of((key, token.shape), params, cache, token)
            if key != self._key:
                return self._warm_and_capture(params, cache, token, parts,
                                              key), cache
            io, graphs = self._io, self._graphs
            pos = cache["pos"]
            io.tok.copy_(token)
            with profiling.annotate("acx.model.layers"):
                for i, (kc, vc) in enumerate(io.kv):
                    graphs[i].replay()
                    parts.attend(io.y[i], kc, vc, pos, out=io.o)
            with profiling.annotate("acx.model.head"):
                graphs[-1].replay()
            self.replayed += 1
            return io.y[-1], cache

    def _warm_and_capture(self, params, cache, token, parts, key):
        """The warm step, then the capture of every segment; returns the
        warm step's logits."""
        self.drop()
        lps = _step_layers(params, parts)
        with self._on_side(token.device) as cur:
            logits, o = _eager(lps, cache, token, parts)
            self.eager += 1
            io = SimpleNamespace(
                tok=token.clone(), o=torch.empty_like(o),
                kv=[_layer_cache(cache, i) for i in range(len(lps))])
            graphs, io.y = self._capture_segments(
                len(lps) + 1, lambda i, x: _segment(parts, lps, cache, i,
                                                    io.tok, x, io.o))
        for t in (logits, io.tok, io.o):
            t.record_stream(cur)
        self._graphs, self._io, self._key = graphs, io, key
        self.captures += 1
        return logits


# -- the prompt pass ---------------------------------------------------------


class PrefillParts(NamedTuple):
    """A family's prompt pass in the pieces :func:`run_prefill` runs:

    * ``embed(tokens [B, S]) -> x [B, S, d]``;
    * ``qkv(lp, x) -> ((q, k, v), (k_row, v_row))``: the prefill
      attention's operands and the layer's cache rows ``[B, S, Hkv, D]``
      (``v_row`` None for a latent cache, whose rows are ``[B, S, 1,
      row]``);
    * ``attend(q, k, v, out=None) -> o [B, S, H, Dv]``: the prefill
      attention, K1 on a CUDA tensor, as the family looks it up when
      called;
    * ``post(lp, x, o) -> x``: the output projection, residual and FFN;
    * ``head(x, last) -> logits [B, *, vocab]`` (f32): the final norm,
      then :func:`last_rows`, then the unembedding;
    * ``layers``: as :class:`StepParts`'."""

    embed: Callable
    qkv: Callable
    attend: Callable
    post: Callable
    head: Callable
    layers: Optional[Callable] = None


def run_prefill(params, tokens, parts: PrefillParts, key, init_cache,
                last_only: bool = False, last_index: Optional[int] = None,
                seat=None):
    """A family's prompt pass from its ``parts``: tokens [B, S] ->
    (logits [B, S, vocab] f32, cache). ``last_only`` unembeds the final
    row alone, ``last_index`` that row instead.

    Without ``seat`` the rows land at positions 0..S-1 of a fresh cache,
    ``init_cache()``, whose ``pos`` becomes S. ``seat = (slot cache, b)``
    (B = 1) lands them in slot b of the serve loop's cache instead,
    leaving its ``pos`` to the caller, unembeds one row (the final one
    unless ``last_index``) and returns that cache; a :class:`SlotCache`
    runs the pass through its :class:`PrefillGraphs`, which replays it
    on the GPU. ``key`` names what a capture rests on besides tensors
    (the config, the FFN)."""
    S, dev = tokens.shape[1], tokens.device
    last = last_index if last_index is not None else (
        S - 1 if last_only or seat is not None else None)
    if seat is None:
        cache = init_cache()
        slots = torch.arange(tokens.shape[0], device=dev)[:, None]
    else:
        cache, b = seat
        graphs = getattr(cache, "prefills", None)
        if graphs is not None:
            return graphs.run(params, cache, b, tokens, last, parts,
                              key), cache
        slots = torch.full((1, 1), b, device=dev)
    with torch.no_grad():
        logits = _prefill_eager(_step_layers(params, parts), cache, slots,
                                tokens, last, parts)[0]
    if seat is None:
        cache["pos"] = torch.full((), S, dtype=torch.int32, device=dev)
    return logits, cache


def last_rows(x, last):
    """The rows of x [B, S, d] a prompt pass unembeds: row ``last`` (an
    int, or a [1] int64 tensor, as a replayed pass holds it) or every row
    (None) -> [B, 1 or S, d]. (The tensor indexes as the embedding
    lookup does, a kernel already loaded.)"""
    if last is None:
        return x
    if isinstance(last, int):
        return x[:, last:last + 1]
    return x[:, last]


def _prefill_eager(lps, cache, slots, tokens, last, parts):
    """The segments of :class:`PrefillGraphs` and their attention calls in
    order, eagerly: (logits, the last attention's operands, its
    output)."""
    x = o = None
    for i in range(len(lps)):
        x, ops = _prefill_segment(parts, lps, cache, i, tokens, x, o, slots,
                                  last)
        o = parts.attend(*ops)
    logits = _prefill_segment(parts, lps, cache, len(lps), tokens, x, o,
                              slots, last)[1]
    return logits, ops, o


def _prefill_segment(parts, lps, cache, i, tokens, x, o, slots, last,
                     ops_out=None):
    """Segment i of the prompt pass: from layer i-1's attention output
    ``o`` (or the tokens, for i = 0) to ``(x, (q, k, v))``, layer i's
    attention operands (copied into ``ops_out`` when given), its cache
    rows written at positions 0..S-1 of ``slots`` ([B, 1]); or ``(x,
    logits)`` for i = L."""
    x = parts.embed(tokens) if i == 0 else parts.post(lps[i - 1], x, o)
    if i == len(lps):
        return x, parts.head(x, last)
    ops, (k, v) = parts.qkv(lps[i], x)
    rows = torch.arange(k.shape[1], device=k.device)[None]
    _put_rows(i, k, v, cache["k"], cache.get("v"), cache.get("ks"),
              cache.get("vs"), slots, rows)
    if ops_out is not None:
        for buf, t in zip(ops_out, ops):
            buf.copy_(t)
        ops = ops_out
    return x, ops


# The longest prompt pass :class:`PrefillGraphs` captures: the serve loop
# pads a prompt of at most this many tokens to its power-of-two bucket
# and runs a longer one at its own length, eagerly (models/serving.py:
# _padded). The trade is the replay's saved host issue against the pad
# rows' device time. On an H100 (probes/prefill_graphs.py long), a
# Mistral-7B pass of 1025, 1280 and 1536 tokens takes 37, 46 and 57 ms
# at its own length against 66 ms replayed at 2048, and 69 against 67 at
# 2048 itself. DeepSeek-V2-Lite's eager pass waits on its routing each
# layer: 63 ms against 76 at 1025 tokens, but 81-100 against 73-75 from
# 1280 to 2048, so there the rule costs it up to 37% a pass.
PREFILL_CAPTURE_MAX = 1024


class PrefillGraphs(_Captures):
    """The prompt passes into one served slot cache, replayed from CUDA
    graphs between their prefill-attention calls, one capture per prompt
    length (the serve loop's power-of-two bucket), and how often that
    engaged. A pass longer than :data:`PREFILL_CAPTURE_MAX` is never
    captured: it runs the segments eagerly at its own length, counted in
    ``exact``.

    A pass splits at its L attention calls into L + 1 segments as the
    decode step does (:class:`DecodeGraphs`): segment 0 is the embedding
    and layer 0's norm, QKV and cache write; segment i (0 < i < L) is
    layer i-1's output projection, residual and FFN, then layer i's; the
    last is the final norm and the unembedding of the row ``last``. Each
    layer's rows land straight in the seated slot, positions 0..S-1
    (rows past the prompt lie past the slot's ``pos`` and are never
    attended). The attention (K1) runs eagerly between the segments on
    static operand buffers, through the family's ``attend`` as it is
    looked up at each call, into the static buffer the next segment
    reads.

    On a CUDA cache the first pass of a length captures each segment
    into a CUDA graph on a side stream, in a memory pool of the length's
    own (never the decode step's), and replays them; later passes copy
    the tokens in, fill the one-element buffers of the row ``last`` and
    the slot, and replay. The first capture since :meth:`drop` follows a
    warm pass, the segments run eagerly on the side stream (whose
    results are the pass's): it makes what the libraries make at their
    first call on a stream, and gives the operands' shapes, which then
    scale with the length. The returned logits are a buffer the next
    pass overwrites. Captures hold while the parameters, the cache and
    the family's ``key`` stay the same; :meth:`drop` forgets them. On a
    CPU cache every pass runs the segments eagerly, in the same order.
    ``replayed``, ``eager`` and ``captures`` count the passes replayed,
    run eagerly (the warm pass; on a CPU cache every pass of at most the
    cap) and the lengths captured, ``exact`` the passes above the cap;
    ``buckets`` the four by prompt length."""

    def __init__(self):
        self.buckets = {}
        self.exact = 0
        super().__init__()

    def drop(self) -> None:
        """Forget every capture: the next pass of each length on CUDA
        captures anew, the first after a warm pass."""
        self._key = None
        self._caps = {}
        self._shapes = None

    def _count(self, bucket, what):
        setattr(self, what, getattr(self, what) + 1)
        n = self.buckets.setdefault(
            bucket, dict(replayed=0, eager=0, captures=0, exact=0))
        n[what] += 1

    def run(self, params, cache, slot, tokens, last, parts: PrefillParts,
            key):
        """The pass of ``tokens`` [1, S] into slot ``slot``: logits [1, 1,
        vocab] of row ``last``."""
        S, dev = tokens.shape[1], tokens.device
        with torch.no_grad():
            exact = S > PREFILL_CAPTURE_MAX
            if exact or not cache["k"].is_cuda:
                self._count(S, "exact" if exact else "eager")
                return _prefill_eager(
                    _step_layers(params, parts), cache,
                    torch.full((1, 1), slot, device=dev), tokens, last,
                    parts)[0]
            key = self._key_of(key, params, cache, tokens)
            if key != self._key:
                self.drop()
                self._key = key
            io = self._caps.get(S)
            if io is None:
                io, logits = self._capture(params, cache, slot, tokens, last,
                                           parts)
                if logits is not None:
                    return logits
            io.tok.copy_(tokens)
            io.slot.fill_(slot)
            io.last.fill_(last)
            for g in io.graphs[:-1]:
                g.replay()
                parts.attend(*io.ops, out=io.o)
            io.graphs[-1].replay()
            self._count(S, "replayed")
            return io.logits

    def _capture(self, params, cache, slot, tokens, last, parts):
        """The capture of every segment of a pass of this length, after
        the warm pass where one is due: ``(io, the warm pass's logits or
        None)``."""
        S, dev = tokens.shape[1], tokens.device
        lps = _step_layers(params, parts)
        logits = None
        with self._on_side(dev) as cur:
            io = SimpleNamespace(tok=tokens.clone(),
                                 slot=torch.full((1, 1), slot, device=dev),
                                 last=torch.full((1,), last, device=dev))
            if self._shapes is None:
                logits, ops, o = _prefill_eager(lps, cache, io.slot, io.tok,
                                                io.last, parts)
                self._count(S, "eager")
                self._shapes = [(t.shape[2:], t.dtype) for t in (*ops, o)]
            *io.ops, io.o = (torch.empty((1, S) + tail, dtype=dt, device=dev)
                             for tail, dt in self._shapes)
            io.graphs, ys = self._capture_segments(
                len(lps) + 1, lambda i, x: _prefill_segment(
                    parts, lps, cache, i, io.tok, x, io.o, io.slot, io.last,
                    io.ops))
            io.logits = ys[-1]
        for t in (io.tok, io.slot, io.last, io.o, *io.ops) + (
                () if logits is None else (logits,)):
            t.record_stream(cur)
        self._caps[S] = io
        self._count(S, "captures")
        return io, logits


def _decode_loop(prefill_fn, decode_fn, prompt, n_new, max_seq, max_len,
                 pick):
    """The loop of :func:`greedy_generate` and :func:`sample_generate`:
    prefill, then ``pick(logits [B, vocab]) -> tokens [B]`` on the prompt's
    last logits and on each decode step's, n_new tokens in all."""
    B, S = prompt.shape
    if max_len is None:
        max_len = S + n_new
    if S + n_new > max_len:
        raise ValueError(f"prompt {S} + n_new {n_new} > max_len {max_len}")
    # The position table is a hard ceiling: past it every token would
    # reuse the last row.
    if S + n_new > max_seq:
        raise ValueError(f"prompt {S} + n_new {n_new} > max_seq {max_seq}")
    logits, cache = prefill_fn(prompt, max_len, True)
    if n_new == 0:
        return prompt
    tok = pick(logits[:, -1]).to(prompt.dtype)
    toks = [tok]
    for _ in range(n_new - 1):
        logits, cache = decode_fn(cache, tok)
        tok = pick(logits).to(prompt.dtype)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def greedy_generate(prefill_fn: Callable, decode_fn: Callable,
                    prompt, n_new: int, max_seq: int,
                    max_len: Optional[int] = None):
    """prompt [B, S] -> [B, S + n_new] by greedy argmax.

    prefill_fn(tokens, max_len, last_only) -> (logits [B, *, vocab], cache)
    decode_fn(cache, token [B]) -> (logits [B, vocab], cache)
    """
    return _decode_loop(prefill_fn, decode_fn, prompt, n_new, max_seq,
                        max_len, lambda lg: lg.argmax(dim=-1))

# -- sampling ----------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """The seed of stream ``data`` under integer key ``key`` (the
    counterpart of ``jax.random.fold_in``): ``splitmix64(splitmix64(key)
    ^ data)``, cut to 63 bits. The servers give request ``rid`` the
    generator :func:`key_generator` ``(fold_in(key, rid))``."""
    return _splitmix64(_splitmix64(key & _MASK64) ^ (data & _MASK64)) >> 1


def key_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    return torch.Generator(device=device).manual_seed(int(seed))


def split_generator(key: torch.Generator, n: int):
    """``n`` generators on ``key``'s device, seeded from ``n`` draws of
    ``key`` (the counterpart of ``jax.random.split(key, n)``)."""
    seeds = torch.randint(0, 1 << 62, (n,), generator=key,
                          device=key.device).tolist()
    return [key_generator(s, key.device) for s in seeds]


def check_key(key, device) -> None:
    """Raise unless ``key`` is a ``torch.Generator`` on ``device``'s
    type."""
    if not isinstance(key, torch.Generator):
        raise TypeError(f"key must be a torch.Generator, got {type(key)}")
    if torch.device(key.device).type != torch.device(device).type:
        raise ValueError(f"key is a generator on {key.device}, the call "
                         f"runs on {device}")


def gumbel(shape, key: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise of ``shape`` in f32 on ``key``'s device:
    ``-log(-log(u))`` with u uniform in ``[tiny, 1)``, the formula of
    ``jax.random.gumbel``: ``u = r * (1 - tiny) + tiny`` for r uniform in
    [0, 1), whose product is by 1.0 in f32, so ``u = r + tiny`` (and JAX's
    max with tiny changes nothing). Computed in place: the sampled step
    issues one draw per slot."""
    u = torch.rand(shape, generator=key, device=key.device)
    return u.add_(torch.finfo(torch.float32).tiny).log_().neg_().log_().neg_()


def filter_logits(logits, temperature: float, top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
    """The deterministic half of :func:`sample_logits`: [B, vocab] f32
    logits divided by ``temperature`` (> 0), then top-k, then top-p
    (nucleus) over the top-k survivors, each filtered logit set to the
    f32 minimum. One descending sort serves both filters; top-p keeps the
    smallest prefix of the sorted tokens with ``cum - probs < top_p``, the
    top-1 token always. A categorical draw over the result's softmax is
    the sample."""
    logits = logits / temperature
    neg = torch.finfo(logits.dtype).min
    V = logits.shape[-1]
    want_k = top_k is not None and top_k < V
    want_p = top_p is not None and top_p < 1.0
    if not (want_k or want_p):
        return logits
    srt = torch.sort(logits, dim=-1, descending=True).values
    if want_k:
        kth = srt[:, top_k - 1:top_k]
        logits = torch.where(logits < kth, neg, logits)
        srt = torch.where(torch.arange(V, device=srt.device) >= top_k, neg,
                          srt)
    if want_p:
        probs = torch.softmax(srt, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        keep = cum - probs < top_p
        keep[:, 0] = True
        thresh = torch.where(keep, srt, torch.inf).amin(dim=-1,
                                                        keepdim=True)
        logits = torch.where(logits < thresh, neg, logits)
    return logits


def sample_logits(logits, key: torch.Generator, temperature: float = 1.0,
                  top_k: Optional[int] = None, top_p: Optional[float] = None):
    """Token ids [B] sampled from [B, vocab] f32 logits: :func:`filter_logits`
    then the Gumbel-max draw ``argmax(filtered + gumbel(key))``, one draw
    of ``[B, vocab]`` from ``key``. ``temperature == 0`` is argmax and
    draws nothing."""
    if temperature == 0.0:
        return logits.argmax(dim=-1)
    f = filter_logits(logits, temperature, top_k, top_p)
    return (f + gumbel(f.shape, key)).argmax(dim=-1)


def sample_generate(prefill_fn: Callable, decode_fn: Callable,
                    prompt, n_new: int, max_seq: int, key: torch.Generator,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    max_len: Optional[int] = None):
    """prompt [B, S] -> [B, S + n_new] by sampling (temperature / top-k /
    top-p); the contract of :func:`greedy_generate` plus ``key``, from
    which the first token (after the prefill) and each later one draw in
    turn."""
    check_key(key, prompt.device)
    return _decode_loop(
        prefill_fn, decode_fn, prompt, n_new, max_seq, max_len,
        lambda lg: sample_logits(lg.float(), key, temperature, top_k, top_p))
