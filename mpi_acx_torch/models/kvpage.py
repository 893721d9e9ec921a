"""Paged KV cache: block-table allocator and radix prefix sharing (the JAX
package's ``models/kvpage.py``).

Fixed-slot serving gives every slot a private ``[max_len]`` cache row, so a
request at position 40 of a 1024-long cache holds 1024 positions of device
memory. Here the slots share a pool of fixed-size pages:

* **Pool**: ``{'k','v': [L, P, page_tokens, H, Dh]}`` tensors (plus f32
  ``'ks','vs'`` scale pages when the cache is int8, ops/kvquant.py). The
  last ``n_slots`` pages of P are per-slot parking pages: an idle slot's
  table points every entry at its own parking page, so the lockstep decode
  step's writes for idle slots land there.
* **Block tables**: host ``[n_slots, max_pages]`` int32 rows, copied to
  the device only when a row changed, mapping position ``t`` of slot ``b``
  to pool page ``table[b, t // page_tokens]``.
* **Allocator**: :class:`PageAllocator`, a free list plus per-page
  refcounts; pages are shared by refcount and reclaimed at zero.
* **Radix prefix cache**: :class:`RadixPrefixCache`, a trie over full-page
  token chunks, so requests sharing a system prompt store the shared pages
  once; a hit seats the cached pages and prefills only the suffix
  (:func:`prefill_with_history`). The matched depth is capped so the suffix
  starts at a page boundary with at least one token, so shared pages are
  never written; :meth:`PagedKV.ensure_writable` (copy on write) guards
  that defensively.

Where JAX rebuilds the pool from each jitted step's donated result, the
port updates the pool tensors in place: the decode step writes each
layer's fresh K/V rows through the table, and the prompt scatter, the copy
on write and :meth:`PagedKV.reset_pool` write or replace the same tensors.

Equality contract: the plain paged attention gathers each slot's pages into
the fixed-slot layout (``ops/flash_decode.py:paged_gather_attend``) and the
paged kernel runs the fixed kernel's FLOPs in the same order, so on a cold
schedule paged greedy serving equals fixed-slot ``serve_greedy`` token for
token. A prefix hit's prefill runs on other shapes than the cold one, so
its outputs are deterministic but not pinned to the cold path.

The paged decode step closes over the GPT-2 block internals
(``models/transformer.py``); another family raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mpi_acx_torch import reqlog
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.ops.flash_decode import (dense_decode_attend,
                                            select_paged_decode_attend)
from mpi_acx_torch.ops.kvquant import kv_quant
from mpi_acx_torch.ops.wquant import wread


def default_page_tokens(max_len: int) -> int:
    """Default page size: ``$ACX_KV_PAGE_TOKENS`` (the JAX package's knob;
    128 when unset, the decode kernels' tile granularity on the TPU),
    stepped down to the largest divisor of ``max_len`` so the table tiles
    the cache exactly."""
    want = int(os.environ.get("ACX_KV_PAGE_TOKENS", "128") or "128")
    want = max(1, min(want, max_len))
    while max_len % want:
        want -= 1
    return want


def pages_needed(tokens: int, page_tokens: int) -> int:
    return -(-int(tokens) // page_tokens)            # ceil div


# --------------------------------------------------------------------------
# Allocator


class PageAllocator:
    """Host-side page bookkeeping: a deterministic (lowest-id-first) free
    list plus per-page refcounts. All-or-nothing allocation; a page is
    reclaimed exactly when its refcount reaches zero."""

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages={n_pages}")
        self.n_pages = int(n_pages)
        # pop() takes from the end; descending ids hand out page 0 first.
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._ref = [0] * self.n_pages

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return self.n_pages - len(self._free)

    def shared_count(self) -> int:
        """Pages referenced by more than one owner (slot or trie)."""
        return sum(1 for r in self._ref if r > 1)

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages at refcount 1, or None (nothing allocated) when
        fewer than n are free."""
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._ref[p] = 1
        return pages

    def incref(self, page: int) -> None:
        if self._ref[page] <= 0:
            raise ValueError(f"incref of free page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> bool:
        """Drop one reference; True iff the page was reclaimed."""
        if self._ref[page] <= 0:
            raise ValueError(f"decref of free page {page}")
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)
            # Sorted descending, so reclaimed pages re-issue lowest-first.
            self._free.sort(reverse=True)
            return True
        return False


# --------------------------------------------------------------------------
# Radix prefix cache


class _TrieNode:
    __slots__ = ("children", "page", "stamp")

    def __init__(self, page: int = -1):
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.page = page
        self.stamp = 0


class RadixPrefixCache:
    """Trie over full-page token chunks. ``match`` walks the prompt's
    complete pages and increfs every page on the matched path (the caller
    owns those references until it releases the slot); ``insert`` adopts a
    served request's prompt pages (incref: the trie is an owner like any
    slot). Eviction removes least-recently-matched leaves only, so an
    interior page never outlives a cached extension of it.

    ``match`` caps the hit depth at ``(S - 1) // page_tokens``: the suffix
    keeps at least one token and starts at a page boundary, so every
    position a prefill or decode write touches lies in a fresh page."""

    def __init__(self, alloc: PageAllocator, page_tokens: int):
        self.alloc = alloc
        self.page_tokens = page_tokens
        self.root = _TrieNode()
        self._clock = 0
        self.hits = 0            # matches with depth >= 1 page
        self.evictions = 0       # pages evicted (LRU leaves)
        self.pages_reused = 0    # cumulative pages handed out by match

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunk(self, prompt, d: int) -> Tuple[int, ...]:
        pt = self.page_tokens
        return tuple(int(t) for t in prompt[d * pt:(d + 1) * pt])

    def match(self, prompt: np.ndarray) -> List[int]:
        """Longest cached full-page prefix of ``prompt``; increfs and
        returns its pages (possibly none)."""
        max_depth = (len(prompt) - 1) // self.page_tokens
        node, pages = self.root, []
        stamp = self._tick()
        for d in range(max_depth):
            nxt = node.children.get(self._chunk(prompt, d))
            if nxt is None:
                break
            nxt.stamp = stamp
            pages.append(nxt.page)
            node = nxt
        for p in pages:
            self.alloc.incref(p)
        if pages:
            self.hits += 1
            self.pages_reused += len(pages)
        return pages

    def insert(self, prompt: np.ndarray, pages: List[int]) -> int:
        """Adopt the prompt's full pages (``pages[d]`` backs chunk d);
        returns how many pages were newly adopted."""
        node, adopted = self.root, 0
        stamp = self._tick()
        n_full = len(prompt) // self.page_tokens
        for d in range(min(n_full, len(pages))):
            chunk = self._chunk(prompt, d)
            nxt = node.children.get(chunk)
            if nxt is None:
                nxt = _TrieNode(pages[d])
                node.children[chunk] = nxt
                self.alloc.incref(pages[d])
                adopted += 1
            nxt.stamp = stamp
            node = nxt
        return adopted

    def evict_one(self) -> bool:
        """Drop the least-recently-matched leaf (decref its page). False
        when the trie is empty."""
        best = None  # (stamp, parent, key, node)
        stack = [(self.root, None, None)]
        while stack:
            node, parent, key = stack.pop()
            if parent is not None and not node.children:
                if best is None or node.stamp < best[0]:
                    best = (node.stamp, parent, key, node)
            for k, ch in node.children.items():
                stack.append((ch, node, k))
        if best is None:
            return False
        _, parent, key, node = best
        del parent.children[key]
        self.alloc.decref(node.page)
        self.evictions += 1
        return True


# --------------------------------------------------------------------------
# Device pool


_POOL_KEYS = ("k", "v", "ks", "vs")


def init_page_pool(cfg, n_pages: int, page_tokens: int, n_slots: int,
                   kv_int8: bool = False, device=None):
    """Zeroed page pool on ``device`` (``None`` means the GPU): ``{'k','v':
    [L, P, page_tokens, H, Dh]}`` in cfg.dtype, or int8 codes plus f32
    ``'ks','vs'`` [L, P, page_tokens, H, 1] with ``kv_int8``; ``P = n_pages
    + n_slots``, the last ``n_slots`` pages being the parking pages, outside
    the allocator."""
    dev = resolve_device(device)
    P = n_pages + n_slots
    shape = (cfg.n_layers, P, page_tokens, cfg.n_heads, cfg.head_dim)
    kv_dtype = torch.int8 if kv_int8 else cfg.dtype
    pool = {"k": torch.zeros(shape, dtype=kv_dtype, device=dev),
            "v": torch.zeros(shape, dtype=kv_dtype, device=dev)}
    if kv_int8:
        for key in ("ks", "vs"):
            pool[key] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                    device=dev)
    return pool


def _check_family(family) -> None:
    name = getattr(family, "__name__", "").rsplit(".", 1)[-1]
    if family is not None and name != "transformer":
        raise NotImplementedError(
            "paged KV serving closes over the GPT-2 block internals; family "
            f"{name!r} is not wired yet: use models.transformer")


# --------------------------------------------------------------------------
# Paged decode step (transformer family)


def paged_decode_step(params, cfg, state, token, page_tokens: int,
                      ffn=None):
    """One autoregressive step against the page pool; ``transformer.
    decode_step``'s math with the cache writes routed through the block
    table: layer i's fresh K/V for slot b lands, in place, at ``pool[i,
    table[b, pos_b // pt], pos_b % pt]``. ``state`` = pool tensors +
    ``'table'`` [B, max_pages] int32 + ``'pos'`` [B] int32, all on one
    device. Idle slots write their parking page, and the page index is
    clipped so a long-idle slot's walking position never indexes past its
    table row. Attention runs through ``select_paged_decode_attend(
    cfg.decode_flash)``. ``ffn(cfg, lp, x) -> x`` replaces the
    feed-forward half (default the dense MLP), as on
    ``transformer.decode_step``. Returns (logits [B, vocab] f32, state
    with pos + 1)."""
    from mpi_acx_torch.models import transformer as tfm

    ffn = ffn or tfm._mlp
    table, pos = state["table"], state["pos"]
    max_pages = table.shape[1]
    quant = "ks" in state
    # Like JAX's gather, a position past the table reads its last row.
    pe = params["pos"][pos.clamp(0, cfg.max_seq - 1)][:, None, :]
    x = (params["embed"][token][:, None, :] + pe).to(cfg.dtype)
    page_j = (pos // page_tokens).clamp(max=max_pages - 1).long()
    write_page = table.long().gather(1, page_j[:, None])[:, 0]
    off = (pos % page_tokens).long()
    attend = select_paged_decode_attend(cfg.decode_flash)
    for i in range(next(iter(params["layers"].values())).shape[0]):
        lp = {name: a[i] for name, a in params["layers"].items()}
        q, k, v = tfm._qkv(cfg, lp, x)
        if quant:
            k, ks = kv_quant(k)
            v, vs = kv_quant(v)
            state["ks"][i][write_page, off] = ks[:, 0]
            state["vs"][i][write_page, off] = vs[:, 0]
        state["k"][i][write_page, off] = k[:, 0]
        state["v"][i][write_page, off] = v[:, 0]
        kl, vl = state["k"][i], state["v"][i]
        if quant:
            kl, vl = (kl, state["ks"][i]), (vl, state["vs"][i])
        o = attend(q, kl, vl, table, pos, page_tokens, 1)
        x = ffn(cfg, lp, x + o @ wread(lp, "wo", x.dtype))
    out = {key: state[key] for key in _POOL_KEYS if key in state}
    out["table"] = table
    out["pos"] = pos + 1
    x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
    return tfm._unembed(x, params["embed"])[:, 0], out


def make_paged_step_fn(params, cfg, family, chunk: int, page_tokens: int):
    """The chunked greedy decode step over the paged state (the paged
    sibling of ``make_server_fns``' step): ``step_fn(state, tok) ->
    (state, toks [chunk, B])``."""
    _check_family(family)

    def step_fn(state, tok):
        toks = []
        for _ in range(chunk):
            logits, state = paged_decode_step(params, cfg, state, tok,
                                              page_tokens)
            tok = logits.argmax(dim=-1).to(torch.int32)
            toks.append(tok)
        return state, torch.stack(toks)

    return step_fn


# --------------------------------------------------------------------------
# Prefix-hit suffix prefill


def prefill_with_history(params, cfg, suffix, hk, hv, last_index: int,
                         ffn=None):
    """Prefill only the suffix of a prompt whose first ``P`` tokens' K/V
    are already paged in (a radix prefix hit): ``suffix`` [1, S_suf]
    tokens at absolute positions ``P..P+S_suf-1``, ``hk``/``hv`` [L, P, H,
    Dh] the gathered (dequantized) history. Per layer the suffix queries
    attend ``concat(history, suffix)`` through :func:`dense_decode_attend`
    (pos P: row w sees columns <= P + w). Returns (logits [1, 1, vocab] at
    ``last_index``, suffix K/V [L, 1, S_suf, H, Dh] in compute dtype).
    ``ffn`` replaces the feed-forward half as in
    :func:`paged_decode_step`."""
    from mpi_acx_torch.models import transformer as tfm

    ffn = ffn or tfm._mlp
    Sb = suffix.shape[1]
    P = hk.shape[1]
    x = (params["embed"][suffix] + params["pos"][P:P + Sb]).to(cfg.dtype)
    ks, vs = [], []
    for i in range(hk.shape[0]):
        lp = {name: a[i] for name, a in params["layers"].items()}
        q, k, v = tfm._qkv(cfg, lp, x)
        kcat = torch.cat([hk[i][None].to(x.dtype), k], dim=1)
        vcat = torch.cat([hv[i][None].to(x.dtype), v], dim=1)
        o = dense_decode_attend(q, kcat, vcat, P, P + Sb, 1)
        x = x + o @ wread(lp, "wo", x.dtype)
        x = ffn(cfg, lp, x)
        ks.append(k)
        vs.append(v)
    x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
    x = x[:, last_index:last_index + 1]
    return tfm._unembed(x, params["embed"]), torch.stack(ks), torch.stack(vs)


# --------------------------------------------------------------------------
# Host-side paged state manager


class PagedKV:
    """The serving scheduler's view of the page plane: device pool, host
    block tables, allocator and (optional) radix prefix cache. The
    scheduler calls the seat/grow/release methods; the decode step takes
    :meth:`device_state` and hands its result back through
    :meth:`absorb`."""

    def __init__(self, cfg, family, n_slots: int, max_len: int,
                 page_tokens: int, n_pages: int, kv_int8: bool = False,
                 prefix_cache: bool = False, device=None):
        if max_len % page_tokens:
            raise ValueError(f"max_len={max_len} must be a multiple of "
                             f"page_tokens={page_tokens} (the block table "
                             "tiles the cache exactly)")
        _check_family(family)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.max_len = int(max_len)
        self.page_tokens = int(page_tokens)
        self.n_pages = int(n_pages)
        self.max_pages = max_len // page_tokens
        self.kv_int8 = bool(kv_int8)
        # Slot b's parking page sits past the allocator's range.
        self._park = [n_pages + b for b in range(n_slots)]
        self.pages_hwm = 0
        self.preemptions = 0
        self.prefix = None
        self.reset_pool(prefix_cache=prefix_cache)

    # -- device state ------------------------------------------------------

    def device_state(self):
        """The pool tensors plus the table and positions on the device;
        each of the two is copied there only after the host changed it."""
        if self._dev_table is None:
            self._dev_table = torch.tensor(self.table, device=self.device)
        if self._dev_pos is None:
            self._dev_pos = torch.tensor(self.pos, device=self.device)
        state = dict(self.pool)
        state["table"] = self._dev_table
        state["pos"] = self._dev_pos
        return state

    def absorb(self, state, steps: int) -> None:
        """Take back the state of ``steps`` decode steps: the pool tensors
        (updated in place) and the advanced positions, which the host
        mirror follows by the same ``steps`` without reading them back."""
        self.pool = {k: state[k] for k in _POOL_KEYS if k in state}
        self._dev_table = state["table"]
        self._dev_pos = state["pos"]
        self.pos = self.pos + np.int32(steps)

    def reset_pool(self, prefix_cache: Optional[bool] = None) -> None:
        """A zeroed pool on the same device (after a failed step the pool
        written in place cannot be trusted), and every reference dropped:
        allocator, tables and the prefix cache start over (its counters
        carry on)."""
        self.pool = init_page_pool(self.cfg, self.n_pages, self.page_tokens,
                                   self.n_slots, kv_int8=self.kv_int8,
                                   device=self.device)
        self.alloc = PageAllocator(self.n_pages)
        if prefix_cache is None:
            prefix_cache = self.prefix is not None
        old, self.prefix = self.prefix, None
        if prefix_cache:
            self.prefix = RadixPrefixCache(self.alloc, self.page_tokens)
            if old is not None:
                self.prefix.hits, self.prefix.evictions = (old.hits,
                                                           old.evictions)
                self.prefix.pages_reused = old.pages_reused
        self.pages: List[List[int]] = [[] for _ in range(self.n_slots)]
        self.pos = np.zeros((self.n_slots,), np.int32)
        self.table = np.asarray([[self._park[b]] * self.max_pages
                                 for b in range(self.n_slots)], np.int32)
        self._dev_table = None
        self._dev_pos = None

    # -- table bookkeeping -------------------------------------------------

    def _sync_row(self, b: int) -> None:
        row = self.pages[b] + [self._park[b]] * (self.max_pages
                                                 - len(self.pages[b]))
        self.table[b] = np.asarray(row, np.int32)
        self._dev_table = None

    def _set_pos(self, b: int, p: int) -> None:
        self.pos[b] = p
        self._dev_pos = None

    def _note_hwm(self) -> None:
        self.pages_hwm = max(self.pages_hwm, self.alloc.used_count)

    def alloc_evicting(self, n: int) -> Optional[List[int]]:
        """Allocate n pages, evicting prefix-cache LRU leaves to make room;
        None when the pool cannot cover n even fully drained."""
        while self.alloc.free_count < n:
            if self.prefix is None or not self.prefix.evict_one():
                return None
        got = self.alloc.alloc(n)
        if got is not None:
            self._note_hwm()
        return got

    def seat(self, b: int, prompt_pages: List[int], fresh_pages: List[int],
             new_pos: int, rid: int = -1) -> None:
        """Slot b takes ownership of ``prompt_pages + fresh_pages``
        (references already held by the caller) at position ``new_pos``.
        ``rid`` only labels the journey event."""
        if self.pages[b]:
            raise ValueError(f"seat of occupied slot {b}")
        pages = list(prompt_pages) + list(fresh_pages)
        if len(pages) > self.max_pages:
            raise ValueError(f"slot {b}: {len(pages)} pages > "
                             f"{self.max_pages}")
        self.pages[b] = pages
        self._set_pos(b, new_pos)
        reqlog.emit("seat", rid, slot=b, pages=len(pages),
                    shared=len(prompt_pages), pos=new_pos)
        self._sync_row(b)

    def release(self, b: int) -> None:
        """Drop slot b's page references (shared prefix pages survive
        through the trie's reference) and park the slot."""
        for p in self.pages[b]:
            self.alloc.decref(p)
        self.pages[b] = []
        self._set_pos(b, 0)
        self._sync_row(b)

    def grow(self, b: int, need_pages: int) -> bool:
        """Extend slot b's page list to ``need_pages``; False when the pool
        is dry even after prefix eviction (the caller preempts)."""
        need_pages = min(need_pages, self.max_pages)
        short = need_pages - len(self.pages[b])
        if short <= 0:
            return True
        got = self.alloc_evicting(short)
        if got is None:
            return False
        self.pages[b].extend(got)
        self._sync_row(b)
        return True

    def ensure_writable(self, b: int, j: int) -> bool:
        """Copy on write: if slot b's page j is shared (refcount > 1), give
        the slot a private copy (in place in the pool). Unreachable under
        the radix policy; the scheduler runs it before decode writes as a
        guard. Returns True iff a copy was made."""
        page = self.pages[b][j]
        if self.alloc.refcount(page) <= 1:
            return False
        got = self.alloc_evicting(1)
        if got is None:
            raise RuntimeError("copy-on-write with a dry pool (admission "
                               "should have bounded the request)")
        for t in self.pool.values():
            t[:, got[0]] = t[:, page]
        self.pages[b][j] = got[0]
        self.alloc.decref(page)
        self._sync_row(b)
        return True

    # -- prompt scatter / history gather -----------------------------------

    def scatter_prompt(self, one, pages: List[int], start_page: int = 0
                       ) -> None:
        """Write a prefilled cache (``one`` = {'k','v'[,'ks','vs']: [L, 1,
        S_bucket, H, *]}, on the pool's device) into ``pages``, in place:
        page d takes bucket rows [(start_page + d)*pt, ...+pt)
        (zero-padded rows past the prompt are never attended).
        ``start_page`` offsets the source rows only; 0 scatters a whole
        prompt. (The JAX package takes ``start_page`` and ignores it, so
        the two agree at 0, the only value its callers pass.)"""
        pt = self.page_tokens
        bucket = one["k"].shape[2]
        keys = [k for k in _POOL_KEYS if k in one and k in self.pool]
        for j, page in enumerate(pages):
            r0 = (start_page + j) * pt
            n = min(pt, bucket - r0)
            if n <= 0:
                break
            for key in keys:
                self.pool[key][:, page, :n] = one[key][:, 0, r0:r0 + n]

    def gather_history(self, pages: List[int]):
        """``pages`` gathered into contiguous [L, n*pt, H, Dh] history K/V
        in compute dtype (int8 pages dequantized through their scales)."""
        idx = torch.as_tensor(pages, dtype=torch.long, device=self.device)

        def grab(key):
            return self.pool[key][:, idx]

        k, v = grab("k"), grab("v")
        if "ks" in self.pool:
            k = k.float() * grab("ks")
            v = v.float() * grab("vs")
        shp = (k.shape[0], len(pages) * self.page_tokens) + tuple(k.shape[3:])
        return (k.reshape(shp).to(self.cfg.dtype),
                v.reshape(shp).to(self.cfg.dtype))


# --------------------------------------------------------------------------
# Native-metrics publication (never builds or loads the library)


def publish_page_stats_best_effort(pages_free: int, pages_shared: int,
                                   prefix_hits: int, prefix_evictions: int,
                                   preemptions: int) -> bool:
    """Mirror the page plane into the native registry's gauges and counters
    (src/core/metrics.cc: pages_free, pages_shared, prefix_hits,
    prefix_evictions, preemptions), but only when the port's runtime
    binding has already loaded the native library: telemetry never builds
    or loads it. Returns True iff the numbers were handed over (False too
    for a library built without the registry's page counters)."""
    from mpi_acx_torch import runtime
    if runtime._lib is None:
        return False
    try:
        publish = runtime._lib.acx_serving_page_stats
    except AttributeError:
        return False
    publish(*(ctypes.c_uint64(n) for n in (pages_free, pages_shared,
                                           prefix_hits, prefix_evictions,
                                           preemptions)))
    return True
