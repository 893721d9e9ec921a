"""Shared decode scaffold (the JAX package's ``models/decoding.py``).

``transformer.generate`` is :func:`greedy_generate` closed over the
model's prefill and decode step, and every decode step runs its layers
through :func:`run_decode_layers`. JAX's ``lax.scan`` loops are Python
loops here, and the KV cache is updated IN PLACE: where the JAX functions
return new cache arrays, these write the fresh K/V rows into the caller's
cache tensors with indexed copies and return the same tensors.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mpi_acx_torch.ops.flash_decode import (dense_decode_attend,  # noqa: F401
                                            select_decode_attend)


def grouped_decode_attend(q, kc, vc, pos, max_len, n_rep, flash=None):
    """W-token grouped-query attention against an un-repeated KV cache:
    q [B, W, Hq, D] at positions pos..pos+W-1, kc/vc [B, max_len, Hkv, D]
    with Hq = Hkv*n_rep -> [B, W, Hq*D]. ``flash`` is the ``decode_flash``
    config switch (:func:`select_decode_attend`): ``True``/``None`` -> the
    decode kernel on a CUDA tensor (its plain version on a CPU tensor),
    ``False`` -> :func:`dense_decode_attend`."""
    return select_decode_attend(flash)(q, kc, vc, pos, max_len, n_rep)


def decode_layer_scan(layers, x, kc_all, vc_all, pos, qkv_fn, attend_fn):
    """The decode layer loop: for each layer i, ``qkv_fn(lp, x, pos) ->
    (q, k, v)`` with k/v [B, 1, H, D], the fresh k/v written into
    ``kc_all[i]``/``vc_all[i]`` ([L, B, max_len, H, D]) at each slot's
    position, then ``attend_fn(lp, x, q, kc_l, vc_l, pos) -> x`` against
    the updated layer cache. Returns (x, kc_all, vc_all).

    ``pos`` is a scalar (every row at one position) or [B] (one position
    per slot, continuous-batching serving). The writes go in place; as in
    JAX's ``dynamic_update_slice``, a write position past the cache is
    clamped to its last row rather than indexing out of bounds."""
    n_layers = next(iter(layers.values())).shape[0]
    B, max_len = kc_all.shape[1], kc_all.shape[2]
    pos = torch.as_tensor(pos, device=x.device)
    slots = torch.arange(B, device=x.device)
    wpos = pos.clamp(0, max_len - 1).expand(B)
    for i in range(n_layers):
        lp = {name: a[i] for name, a in layers.items()}
        q, k, v = qkv_fn(lp, x, pos)
        kc_all[i][slots, wpos] = k[:, 0]
        vc_all[i][slots, wpos] = v[:, 0]
        x = attend_fn(lp, x, q, kc_all[i], vc_all[i], pos)
    return x, kc_all, vc_all


def fill_kv_cache(cache, ks, vs, pos):
    """Land the prefill K/V ([L, B, S, H, D]) at the start of a fresh
    cache from ``init_kv_cache`` and set ``pos`` (in place)."""
    S = ks.shape[2]
    cache["k"][:, :, :S] = ks
    cache["v"][:, :, :S] = vs
    cache["pos"] = torch.full((), pos, dtype=torch.int32,
                              device=cache["k"].device)
    return cache


def run_decode_layers(layers, x, cache, qkv_fn, attend_fn):
    """:func:`decode_layer_scan` over a cache dict, returning ``(x,
    cache')`` where ``cache'`` shares the updated k/v tensors and carries
    ``pos`` advanced by the one decoded token."""
    if "ks" in cache:
        raise NotImplementedError("int8 KV caches are not ported yet")
    pos = cache["pos"]
    x, kc, vc = decode_layer_scan(layers, x, cache["k"], cache["v"], pos,
                                  qkv_fn, attend_fn)
    return x, {"k": kc, "v": vc, "pos": pos + 1}


def greedy_generate(prefill_fn: Callable, decode_fn: Callable,
                    prompt, n_new: int, max_seq: int,
                    max_len: Optional[int] = None):
    """prompt [B, S] -> [B, S + n_new] by greedy argmax.

    prefill_fn(tokens, max_len, last_only) -> (logits [B, *, vocab], cache)
    decode_fn(cache, token [B]) -> (logits [B, vocab], cache)
    """
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
    tok = logits[:, -1].argmax(dim=-1).to(prompt.dtype)
    toks = [tok]
    for _ in range(n_new - 1):
        logits, cache = decode_fn(cache, tok)
        tok = logits.argmax(dim=-1).to(prompt.dtype)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
