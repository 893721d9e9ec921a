"""Tensor-parallel (Megatron-style) inference for the model families: the
JAX package's ``parallel/tp_inference.py`` in PyTorch.

Head-parallel attention and a column/row-parallel MLP split every weight
matrix (and the KV cache) over a 'tp' mesh axis, so each decode step
reads 1/tp of the weights on each rank, at the cost of two ``psum``s a
layer (the Megatron residual-boundary all-reduces).

Each rank is one process holding its shard (``parallel/mesh.py``). A
builder returns a function that every rank of the mesh calls with the
same arguments; it makes the mesh active itself (``with mesh:``) and runs
the whole generation on the rank: prefill, the KV cache of its heads, and
a host loop of decode steps over :func:`models.decoding.decode_layer_scan`
(the JAX package runs one ``shard_map`` program with a ``lax.scan``).
Every rank computes the same logits (each psum hands every rank the same
buffer), so the tokens agree from rank to rank by construction; a sampled
pick draws from a ``torch.Generator`` seeded alike on every rank.

**Weights.** A builder's function takes the ORDINARY parameter tree of
its family (``init_params`` / ``cast_params``): it lays it out with the
family's ``tp_shard_params*`` and keeps this rank's slice under the
family's specs (``train.shard_params``). It also takes a tree already
sliced so (the attention weights in the laid-out, per-rank shape), so
that a rank holding only its shard never builds the whole tree. Int8
weight-only checkpoints (``ops/wquant.py``) are served for the dense
matmul weights: each ``*_scale`` companion is laid out and sliced with
its weight, and every weight is read through ``wread``.

GPT-2 (:func:`make_tp_generate`) splits the packed qkv by attention head;
Llama (:func:`make_tp_generate_llama`) by KV-head group, each rank holding
``n_kv_heads / tp`` K/V heads and their ``n_rep`` query heads, so its
cache stays un-repeated; the MoE transformer
(:func:`make_tp_generate_moe`) splits attention as GPT-2 and hosts
``n_experts / tp`` experts a rank. :func:`make_tp_speculative_generate`
and :func:`make_tp_server_fns` (continuous batching, the
``models/serving.py`` contract) run the same split.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from mpi_acx_torch import train
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models import llama as lm
from mpi_acx_torch.models import moe_transformer as mtf
from mpi_acx_torch.models import speculative as spec
from mpi_acx_torch.models import transformer as tfm
from mpi_acx_torch.models.decoding import (decode_layer_scan, fill_kv_cache,
                                           fold_in, grouped_decode_attend,
                                           key_generator, run_decode_layers,
                                           sample_logits, split_generator)
from mpi_acx_torch.ops.attention import select_attention
from mpi_acx_torch.ops.wquant import wread
from mpi_acx_torch.parallel import collective as col
from mpi_acx_torch.parallel.mesh import PartitionSpec as P


def _layers(layers):
    """The per-layer dicts of a stacked layer tree."""
    n = next(iter(layers.values())).shape[0]
    return [{name: a[i] for name, a in layers.items()} for i in range(n)]


def _run_generation(hooks, layers, prompt, key, n_new, *, pick):
    """The family-independent generation loop on this rank.

    hooks: embed(tokens [B, S]) -> x; embed_tok(tok [B], pos) -> x [B, 1,
    d]; prefill_layer(x, lp) -> (x, (k, v)); decode_qkv(lp, x, pos) -> (q,
    k, v) (k/v [B, 1, H_local, D]); decode_attend(lp, x, q, kc, vc, pos,
    max_len) -> x (kc/vc the layer's updated cache); finish(x) -> logits
    [B, S, vocab] f32. ``pick(logits, gen)`` picks the tokens; the first
    draws from ``key_generator(key)``, the decode steps in turn from
    ``key_generator(fold_in(key, 1))`` (``key`` is an int seed, unused
    when greedy)."""
    B, S = prompt.shape
    max_len = S + n_new
    dev = prompt.device
    sampled = key is not None
    g0 = key_generator(key, dev) if sampled else None
    g = key_generator(fold_in(key, 1), dev) if sampled else None

    x = hooks["embed"](prompt)
    ks, vs = [], []
    for lp in _layers(layers):
        x, (k, v) = hooks["prefill_layer"](x, lp)
        ks.append(k)
        vs.append(v)
    tok = pick(hooks["finish"](x[:, -1:])[:, 0], g0).to(prompt.dtype)
    kc, vc = _init_kv_from_prefill(torch.stack(ks), torch.stack(vs),
                                   max_len)
    toks = [tok]
    for pos in range(S, S + n_new - 1):
        x = hooks["embed_tok"](tok, pos)
        x, kc, vc = decode_layer_scan(
            layers, x, kc, vc, pos, hooks["decode_qkv"],
            lambda lp, x, q, kcl, vcl, p: hooks["decode_attend"](
                lp, x, q, kcl, vcl, p, max_len))
        tok = pick(hooks["finish"](x)[:, 0], g).to(prompt.dtype)
        toks.append(tok)
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)


def _check_key(temperature, key):
    if temperature != 0.0 and key is None:
        raise ValueError("a sampled run needs key, an int seed the same on "
                         "every rank")


def _make_pick(temperature, top_k, top_p):
    def pick(logits, gen):
        if temperature == 0.0:
            return logits.argmax(dim=-1)
        return sample_logits(logits, gen, temperature, top_k, top_p)
    return pick


# -- the weights ---------------------------------------------------------------


def _scale_keys(params) -> frozenset:
    """The int8 weight-only scale companions present in a checkpoint
    (ops/wquant.py)."""
    return frozenset(k for k in params["layers"] if k.endswith("_scale"))


def _specs_with_scales(specs, scale_keys: frozenset, scale_specs: dict,
                       where: str):
    """A family's spec tree with entries for the scale companions
    present. An unsupported companion (quantized MoE experts, say) raises
    ``ValueError``: the alternative is multiplying int8 codes without
    their scales."""
    unknown = [k for k in scale_keys if k not in scale_specs]
    if unknown:
        raise ValueError(
            f"{where} does not support int8 quantization of {unknown} "
            f"(supported: {sorted(scale_specs)}); see ops/wquant.py")
    if not scale_keys:
        return specs
    out = dict(specs)
    out["layers"] = dict(specs["layers"],
                         **{k: scale_specs[k] for k in scale_keys})
    return out


def _rank_params(params, cfg, mesh, axis, shard_fn, specs, scale_specs,
                 where, head_key, n_heads, dev):
    """This rank's slice of ``params``: the ordinary tree laid out by
    ``shard_fn`` and sliced under ``specs``, or a tree already sliced
    (``layers[head_key]`` in the laid-out shape, its head axis at
    ``n_heads / tp``), returned as it is."""
    tfm.check_device(params, dev)
    sspecs = _specs_with_scales(specs, _scale_keys(params), scale_specs,
                                where)
    w = params["layers"][head_key]
    laid = len(sspecs["layers"][head_key])
    if w.ndim != laid:
        return train.shard_params(shard_fn(params, cfg), sspecs, mesh)
    local = n_heads // mesh.shape[axis]
    if w.shape[laid - 2] != local:
        raise ValueError(f"{where}: {head_key} of shape {tuple(w.shape)} is "
                         f"neither the ordinary tree's nor this rank's slice "
                         f"({local} heads)")
    return params


def tp_shard_params(params, cfg: tfm.TransformerConfig):
    """Re-layout the stacked GPT-2 tree for the head/FFN split: wqkv [L,
    d, 3d] -> [L, d, 3, H, Dh] (the head axis splits without cutting the
    packed q/k/v thirds) and wo [L, d, d] -> [L, H, Dh, d] (row-parallel by
    head). Int8 scale companions are re-laid-out beside their weights
    (w1/w2's as they are). Views of the input's tensors."""
    L, d = cfg.n_layers, cfg.d_model
    H, Dh = cfg.n_heads, cfg.head_dim
    lay = params["layers"]
    out = dict(params)
    out["layers"] = dict(
        lay,
        wqkv=lay["wqkv"].reshape(L, d, 3, H, Dh),
        wo=lay["wo"].reshape(L, H, Dh, d),
    )
    if "wqkv_scale" in lay:
        out["layers"]["wqkv_scale"] = lay["wqkv_scale"].reshape(
            L, 1, 3, H, Dh)
    if "wo_scale" in lay:
        out["layers"]["wo_scale"] = lay["wo_scale"].reshape(L, 1, 1, d)
    return out


def _gpt2_scale_specs(axis: str):
    """Spec entries of GPT-2's scale companions after
    :func:`tp_shard_params`: a per-output-channel scale splits with its
    weight's output axis (wqkv: heads; w1: ffn) and is whole where the
    weight splits on its input side (wo, w2)."""
    return {
        "wqkv_scale": P(None, None, None, axis, None),
        "wo_scale": P(),
        "w1_scale": P(None, None, axis),
        "w2_scale": P(),
    }


def _moe_scale_specs(axis: str):
    """MoE TP serving takes int8 on the attention weights only; expert
    companions are absent here, so :func:`_specs_with_scales` refuses
    them."""
    gs = _gpt2_scale_specs(axis)
    return {k: gs[k] for k in ("wqkv_scale", "wo_scale")}


def tp_param_specs(axis: str = "tp"):
    """PartitionSpecs of :func:`tp_shard_params`'s output: attention split
    on the head axis, the MLP on the FFN axis, the rest whole."""
    return {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "layers": {
            "ln1_g": P(), "ln1_b": P(),
            "wqkv": P(None, None, None, axis, None),
            "wo": P(None, axis),
            "ln2_g": P(), "ln2_b": P(),
            "w1": P(None, None, axis), "b1": P(None, axis),
            "w2": P(None, axis), "b2": P(),
        },
    }


def _gpt2_embed(params, cfg, tokens):
    """Token + learned-position embedding (whole leaves)."""
    S = tokens.shape[1]
    return (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)


def _gpt2_finish(params, cfg, x):
    """Final layernorm + tied unembedding -> f32 logits."""
    x = tfm.layernorm(x, params["lnf_g"], params["lnf_b"])
    return tfm._unembed(x, params["embed"])


def _init_kv_from_prefill(ks, vs, cap):
    """[L, B, cap, H_local, D] caches with the prefill K/V at positions
    [0, S)."""
    kc = ks.new_zeros(ks.shape[:2] + (cap,) + ks.shape[3:])
    vc = torch.zeros_like(kc)
    S = ks.shape[2]
    kc[:, :, :S] = ks
    vc[:, :, :S] = vs
    return kc, vc


def _gpt2_tp_layer_ops(cfg, tp: int, axis: str):
    """The head/FFN-split layer primitives of TP generation and TP
    speculative decoding: (local_qkv, out_proj, dense_mlp) over this
    rank's Hl = n_heads / tp heads, two psums a layer."""
    H, Dh, d = cfg.n_heads, cfg.head_dim, cfg.d_model
    if H % tp:
        raise ValueError(f"n_heads {H} not divisible by {axis}={tp}")
    Hl = H // tp

    def local_qkv(lp, x):
        B, S, _ = x.shape
        h = tfm.layernorm(x, lp["ln1_g"], lp["ln1_b"])
        qkv = h @ wread(lp, "wqkv", x.dtype).reshape(d, 3 * Hl * Dh)
        return tuple(t.reshape(B, S, Hl, Dh)
                     for t in qkv.split(Hl * Dh, dim=-1))

    def out_proj(lp, o, x):
        B, S = o.shape[:2]
        part = o.reshape(B, S, Hl * Dh) @ wread(lp, "wo", x.dtype).reshape(
            Hl * Dh, d)
        return x + col.psum(part, axis)

    def dense_mlp(lp, x):
        h = tfm.layernorm(x, lp["ln2_g"], lp["ln2_b"])
        y = F.gelu(h @ wread(lp, "w1", x.dtype) + lp["b1"].to(x.dtype),
                   approximate="tanh")
        part = y @ wread(lp, "w2", x.dtype)
        return x + col.psum(part, axis) + lp["b2"].to(x.dtype)

    return local_qkv, out_proj, dense_mlp


def _gpt2_rank_params(cfg, mesh, axis, specs, shard_fn, scale_specs, where,
                      dev):
    return lambda params: _rank_params(
        params, cfg, mesh, axis, shard_fn, specs, scale_specs, where,
        "wqkv", cfg.n_heads, dev)


def _check_len(S, n_new, max_seq):
    if S + n_new > max_seq:
        raise ValueError(f"prompt {S} + n_new {n_new} > max_seq {max_seq}")


def make_tp_generate(cfg, mesh, n_new: int, axis: str = "tp",
                     temperature: float = 0.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None, ffn=None, specs=None,
                     shard_params=None, scale_specs=None, device=None):
    """Tensor-parallel GPT-2 generation over the mesh's ``axis``: returns
    ``generate(params, prompt, key=None) -> tokens [B, S + n_new]``, run by
    every rank with the same arguments on ``device`` (``None`` means the
    GPU). ``params`` is the ordinary tree or this rank's slice (see the
    module docstring). ``temperature=0`` is greedy; otherwise ``key`` is
    an int seed, the same on every rank.

    ``ffn(lp, x) -> x`` replaces the per-layer feed-forward half (the
    column/row-parallel MLP), with ``specs``/``shard_params``/
    ``scale_specs`` giving the matching weight layout: the MoE family
    plugs in its expert-parallel FFN so (:func:`make_tp_generate_moe`)."""
    tp = mesh.shape[axis]
    local_qkv, out_proj, dense_mlp = _gpt2_tp_layer_ops(cfg, tp, axis)
    mlp = ffn or dense_mlp
    if scale_specs is None:
        scale_specs = _gpt2_scale_specs(axis)
    dev = resolve_device(device)
    rank_params = _gpt2_rank_params(
        cfg, mesh, axis, specs or tp_param_specs(axis),
        shard_params or tp_shard_params, scale_specs,
        "TP GPT-2/MoE serving", dev)
    pick = _make_pick(temperature, top_k, top_p)

    def generate(params, prompt, key=None):
        _check_key(temperature, key)
        params = rank_params(params)
        prompt = torch.as_tensor(prompt, device=dev)
        _check_len(prompt.shape[1], n_new, cfg.max_seq)

        def embed_tok(tok, pos):
            return (params["embed"][tok][:, None, :]
                    + params["pos"][pos][None, None, :]).to(cfg.dtype)

        def prefill_layer(x, lp):
            q, k, v = local_qkv(lp, x)
            o = select_attention(cfg.use_flash)(q, k, v)
            return mlp(lp, out_proj(lp, o, x)), (k, v)

        def decode_attend(lp, x, q, kcl, vcl, pos, max_len):
            o = grouped_decode_attend(q, kcl, vcl, pos, max_len, n_rep=1,
                                      flash=cfg.decode_flash)
            return mlp(lp, out_proj(lp, o, x))

        hooks = {"embed": lambda t: _gpt2_embed(params, cfg, t),
                 "embed_tok": embed_tok, "prefill_layer": prefill_layer,
                 "decode_qkv": lambda lp, x, pos: local_qkv(lp, x),
                 "decode_attend": decode_attend,
                 "finish": lambda x: _gpt2_finish(params, cfg, x)}
        with mesh, torch.no_grad():
            return _run_generation(hooks, params["layers"], prompt, key,
                                   n_new, pick=pick)

    return generate


# -- MoE family (attention by head, experts over the same axis) --------------


# The attention re-layout is GPT-2's (the config duck-types); the expert
# tensors keep their layout, their [n_experts] dim split directly.
tp_shard_params_moe = tp_shard_params


def tp_param_specs_moe(axis: str = "tp"):
    return {
        "embed": P(), "pos": P(), "lnf_g": P(), "lnf_b": P(),
        "layers": {
            "ln1_g": P(), "ln1_b": P(),
            "wqkv": P(None, None, None, axis, None),
            "wo": P(None, axis),
            "ln2_g": P(), "ln2_b": P(), "gate": P(),
            "w1": P(None, axis), "w2": P(None, axis),
        },
    }


def _ep_dispatch_mode(mode: str, tokens: int, ep: int) -> str:
    """The EP dispatch of ONE routed call moving ``tokens`` tokens over an
    ``ep``-way axis: ``"auto"`` is ``"sharded"`` when the count divides
    the axis and ``"replicated"`` otherwise (B = 1 decode, speculative
    windows), decided call by call."""
    if mode == "auto":
        return "sharded" if tokens % ep == 0 else "replicated"
    return mode


def _make_moe_ffn(cfg, tp: int, axis: str, ep_dispatch: str):
    """The expert-FFN hook of every MoE TP builder: checks the expert
    split and ``ep_dispatch``, and resolves the dispatch per call
    (:func:`_ep_dispatch_mode`). Outside ``capacity_factor >= n_experts``
    sharded dispatch forms other capacity groups than the one-device run,
    so "auto" resolves to replicated for every call (bit-equal routing at
    any capacity); an explicit "sharded" is taken as asked."""
    if cfg.n_experts % tp:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by "
                         f"{axis}={tp}")
    if ep_dispatch not in ("auto", "sharded", "replicated"):
        raise ValueError(f"ep_dispatch {ep_dispatch!r}")
    side = ep_dispatch
    if side == "auto" and cfg.capacity_factor < cfg.n_experts:
        side = "replicated"

    def moe_ffn(lp, x):
        mode = _ep_dispatch_mode(side, x.shape[0] * x.shape[1], tp)
        return mtf._moe_ffn(cfg, lp, x, ep_axis=axis,
                            replicated=mode == "replicated",
                            sharded_dispatch=mode == "sharded")

    return moe_ffn


def make_tp_generate_moe(cfg, mesh, n_new: int, axis: str = "tp",
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None,
                         ep_dispatch: str = "auto", device=None):
    """Tensor-parallel MoE-transformer generation: the GPT-2 builder with
    the expert-parallel routed FFN in its ``ffn`` hook; each rank hosts
    ``n_experts / tp`` experts.

    ``ep_dispatch``: ``"sharded"`` has each rank route its exclusive 1/tp
    slice of the call's tokens and all_to_all carry them to their
    expert's rank and back, one all_gather re-replicating
    (``moe.moe_layer_sharded_dispatch``; every routed call's token count
    must divide tp); ``"replicated"`` has every rank route all tokens, run
    its expert block and one psum assemble (any batch, routing bit-equal
    to the one-device layer at any capacity); ``"auto"`` is sharded where
    the count divides tp and replicated elsewhere, and replicated
    throughout below ``capacity_factor >= n_experts``
    (:func:`_make_moe_ffn`). Where no token drops, all three give the
    one-device ``generate``'s tokens."""
    moe_ffn = _make_moe_ffn(cfg, mesh.shape[axis], axis, ep_dispatch)
    return make_tp_generate(cfg, mesh, n_new, axis=axis,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p, ffn=moe_ffn,
                            specs=tp_param_specs_moe(axis),
                            shard_params=tp_shard_params_moe,
                            scale_specs=_moe_scale_specs(axis),
                            device=device)


# -- Llama family (GQA: split by KV-head group) -------------------------------


def tp_shard_params_llama(params, cfg: lm.LlamaConfig):
    """Head-axis re-layout of the Llama tree: wq [L, d, Hq*Dh] -> [L, d,
    Hq, Dh], wk/wv -> [L, d, Hkv, Dh], wo -> [L, Hq, Dh, d]. Contiguous
    head blocks keep each KV group's query heads on its K/V head's rank
    (query head h belongs to group h // n_rep). Int8 scale companions are
    re-laid-out beside their weights. Views of the input's tensors."""
    L, d = cfg.n_layers, cfg.d_model
    Hq, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lay = params["layers"]
    out = dict(params)
    out["layers"] = dict(
        lay,
        wq=lay["wq"].reshape(L, d, Hq, Dh),
        wk=lay["wk"].reshape(L, d, Hkv, Dh),
        wv=lay["wv"].reshape(L, d, Hkv, Dh),
        wo=lay["wo"].reshape(L, Hq, Dh, d),
    )
    for name, shp in (("wq", (L, 1, Hq, Dh)), ("wk", (L, 1, Hkv, Dh)),
                      ("wv", (L, 1, Hkv, Dh)), ("wo", (L, 1, 1, d))):
        if name + "_scale" in lay:
            out["layers"][name + "_scale"] = \
                lay[name + "_scale"].reshape(shp)
    return out


def _llama_scale_specs(axis: str):
    """Spec entries of Llama's scale companions after
    :func:`tp_shard_params_llama` (output-side scales split with their
    heads or FFN axis; input-side-split weights keep whole scales)."""
    return {
        "wq_scale": P(None, None, axis, None),
        "wk_scale": P(None, None, axis, None),
        "wv_scale": P(None, None, axis, None),
        "wo_scale": P(),
        "w_gate_scale": P(None, None, axis),
        "w_up_scale": P(None, None, axis),
        "w_down_scale": P(),
    }


def tp_param_specs_llama(axis: str = "tp"):
    return {
        "embed": P(), "final_norm": P(), "unembed": P(),
        "layers": {
            "attn_norm": P(), "mlp_norm": P(),
            "wq": P(None, None, axis, None),
            "wk": P(None, None, axis, None),
            "wv": P(None, None, axis, None),
            "wo": P(None, axis),
            "w_gate": P(None, None, axis),
            "w_up": P(None, None, axis),
            "w_down": P(None, axis),
        },
    }


def _llama_rank_params(cfg, mesh, axis, dev):
    return lambda params: _rank_params(
        params, cfg, mesh, axis, tp_shard_params_llama,
        tp_param_specs_llama(axis), _llama_scale_specs(axis),
        "TP Llama serving", "wk", cfg.n_kv_heads, dev)


def _llama_tp_layer_ops(cfg, tp: int, axis: str):
    """Llama's layer primitives for TP generation and TP speculative
    decoding, split by KV-head group: (local_qkv, out_proj, mlp, n_rep).
    Each rank holds Hkv / tp K/V heads and their n_rep query heads."""
    Hq, Hkv, Dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    if Hkv % tp:
        raise ValueError(f"n_kv_heads {Hkv} not divisible by {axis}={tp}")
    n_rep = Hq // Hkv
    Hkv_l, Hq_l = Hkv // tp, (Hkv // tp) * n_rep

    def mlp(lp, x):
        h = lm.rmsnorm(x, lp["mlp_norm"])
        gate = F.silu(h @ wread(lp, "w_gate", x.dtype))
        up = h @ wread(lp, "w_up", x.dtype)
        part = (gate * up) @ wread(lp, "w_down", x.dtype)
        return x + col.psum(part, axis)

    def local_qkv(lp, x, positions):
        B, S, _ = x.shape
        h = lm.rmsnorm(x, lp["attn_norm"])
        q = (h @ wread(lp, "wq", x.dtype).reshape(d, Hq_l * Dh)).reshape(
            B, S, Hq_l, Dh)
        k = (h @ wread(lp, "wk", x.dtype).reshape(d, Hkv_l * Dh)).reshape(
            B, S, Hkv_l, Dh)
        v = (h @ wread(lp, "wv", x.dtype).reshape(d, Hkv_l * Dh)).reshape(
            B, S, Hkv_l, Dh)
        return (lm.rope(q, positions, cfg.rope_theta),
                lm.rope(k, positions, cfg.rope_theta), v)

    def out_proj(lp, o, x):
        B, S = o.shape[:2]
        part = o.reshape(B, S, Hq_l * Dh) @ wread(lp, "wo", x.dtype).reshape(
            Hq_l * Dh, d)
        return x + col.psum(part, axis)

    return local_qkv, out_proj, mlp, n_rep


def _llama_finish(params, x):
    return tfm._unembed(lm.rmsnorm(x, params["final_norm"]),
                        params["unembed"])


def make_tp_generate_llama(cfg: lm.LlamaConfig, mesh, n_new: int,
                           axis: str = "tp", temperature: float = 0.0,
                           top_k: Optional[int] = None,
                           top_p: Optional[float] = None, device=None):
    """Tensor-parallel Llama generation: ``tp`` must divide
    ``n_kv_heads``; each rank serves ``n_kv_heads / tp`` KV groups and
    their query heads, so its cache stays un-repeated and grouped-query
    decode runs as ``llama.decode_step`` does, on the group slice. The
    prefill repeats the local K/V for K1. Returns ``generate(params,
    prompt, key=None)`` as :func:`make_tp_generate`."""
    tp = mesh.shape[axis]
    local_qkv, out_proj, mlp, n_rep = _llama_tp_layer_ops(cfg, tp, axis)
    dev = resolve_device(device)
    rank_params = _llama_rank_params(cfg, mesh, axis, dev)
    pick = _make_pick(temperature, top_k, top_p)

    def generate(params, prompt, key=None):
        _check_key(temperature, key)
        params = rank_params(params)
        prompt = torch.as_tensor(prompt, device=dev)
        _check_len(prompt.shape[1], n_new, cfg.max_seq)

        def prefill_layer(x, lp):
            q, k, v = local_qkv(lp, x, torch.arange(x.shape[1],
                                                    device=x.device))
            o = select_attention(cfg.use_flash)(
                q, lm._repeat_kv(k, n_rep), lm._repeat_kv(v, n_rep))
            return mlp(lp, out_proj(lp, o, x)), (k, v)

        def decode_attend(lp, x, q, kcl, vcl, pos, max_len):
            o = grouped_decode_attend(q, kcl, vcl, pos, max_len, n_rep,
                                      flash=cfg.decode_flash)
            return mlp(lp, out_proj(lp, o, x))

        hooks = {"embed": lambda t: params["embed"][t].to(cfg.dtype),
                 "embed_tok": lambda tok, pos: params["embed"][tok][
                     :, None, :].to(cfg.dtype),
                 "prefill_layer": prefill_layer,
                 "decode_qkv": lambda lp, x, pos: local_qkv(lp, x,
                                                            pos.reshape(1)),
                 "decode_attend": decode_attend,
                 "finish": lambda x: _llama_finish(params, x)}
        with mesh, torch.no_grad():
            return _run_generation(hooks, params["layers"], prompt, key,
                                   n_new, pick=pick)

    return generate


# -- tensor-parallel speculative decoding --------------------------------------


def _pack_prefill_cache(ks, vs, cap, kv_int8):
    """A cap-length cache of this rank's heads with the prefill K/V landed
    by ``decoding.fill_kv_cache`` (the one definition of the int8
    layout): each rank quantizes its own heads."""
    L, B, _, H, D = ks.shape
    shape = (L, B, cap, H, D)
    kv_dtype = torch.int8 if kv_int8 else ks.dtype
    cache = {"k": ks.new_zeros(shape, dtype=kv_dtype),
             "v": ks.new_zeros(shape, dtype=kv_dtype)}
    if kv_int8:
        cache["ks"] = ks.new_zeros(shape[:-1] + (1,), dtype=torch.float32)
        cache["vs"] = ks.new_zeros(shape[:-1] + (1,), dtype=torch.float32)
    return fill_kv_cache(cache, ks, vs, ks.shape[2])


def _cut(x, last_only, last_index):
    if last_index is not None:
        return x[:, last_index:last_index + 1]
    return x[:, -1:] if last_only else x


def _tp_family_ops(cfg, tp: int, axis: str, ffn=None,
                   kv_int8: bool = False):
    """GPT-2-scaffold operations with the speculative loop's signatures
    (``models.speculative._make_run``'s ``ops``), tensor-parallel on this
    rank: (prefill, window, decode). Each rank holds its Hl heads of the
    weights and KV cache; the psums hand every rank the same logits, so
    the accept chains and counts agree on every rank. ``pos`` is a scalar
    or one position a row, as on ``transformer.decode_step``.
    ``ffn(lp, x) -> x`` replaces the feed-forward half (the MoE family's
    routed FFN)."""
    local_qkv, out_proj, dense_mlp = _gpt2_tp_layer_ops(cfg, tp, axis)
    mlp = ffn or dense_mlp

    def qkv_fn(lp, x, pos):
        return local_qkv(lp, x)

    def make_attend(max_len):
        def attend_fn(lp, x, q, kcl, vcl, pos):
            o = grouped_decode_attend(q, kcl, vcl, pos, max_len, n_rep=1,
                                      flash=cfg.decode_flash)
            return mlp(lp, out_proj(lp, o, x))
        return attend_fn

    def prefill(params, _cfg, tokens, cap, last_only=True, last_index=None):
        x = _gpt2_embed(params, cfg, tokens)
        ks, vs = [], []
        for lp in _layers(params["layers"]):
            q, k, v = local_qkv(lp, x)
            o = select_attention(cfg.use_flash)(q, k, v)
            x = mlp(lp, out_proj(lp, o, x))
            ks.append(k)
            vs.append(v)
        logits = _gpt2_finish(params, cfg, _cut(x, last_only, last_index))
        return logits, _pack_prefill_cache(torch.stack(ks), torch.stack(vs),
                                           cap, kv_int8)

    def decode(params, _cfg, cache, tok):
        pos = cache["pos"]
        # Like JAX's gather, a position past the table reads its last row.
        pe = params["pos"][pos.clamp(0, cfg.max_seq - 1)]
        pe = pe[:, None, :] if pos.ndim else pe[None, None, :]
        x = (params["embed"][tok][:, None, :] + pe).to(cfg.dtype)
        x, out = run_decode_layers(params["layers"], x, cache, qkv_fn,
                                   make_attend(cache["k"].shape[2]))
        return _gpt2_finish(params, cfg, x)[:, 0], out

    def window(params, _cfg, cache, tokens):
        W = tokens.shape[1]
        pos = cache["pos"]
        rows = spec._positions(pos.clamp(0, cfg.max_seq - W), W)
        x = (params["embed"][tokens] + params["pos"][rows]).to(cfg.dtype)
        x, kc, vc = decode_layer_scan(params["layers"], x, cache["k"],
                                      cache["v"], pos, qkv_fn,
                                      make_attend(cache["k"].shape[2]))
        return _gpt2_finish(params, cfg, x), {"k": kc, "v": vc,
                                              "pos": pos + W}

    return prefill, window, decode


def _llama_tp_family_ops(cfg, tp: int, axis: str, kv_int8: bool = False):
    """Llama's counterpart of :func:`_tp_family_ops` (split by KV-head
    group): RoPE at each row's absolute positions, grouped attention
    against the un-repeated local cache."""
    local_qkv, out_proj, mlp, n_rep = _llama_tp_layer_ops(cfg, tp, axis)

    def make_attend(max_len):
        def attend_fn(lp, x, q, kcl, vcl, pos):
            o = grouped_decode_attend(q, kcl, vcl, pos, max_len, n_rep,
                                      flash=cfg.decode_flash)
            return mlp(lp, out_proj(lp, o, x))
        return attend_fn

    def prefill(params, _cfg, tokens, cap, last_only=True, last_index=None):
        x = params["embed"][tokens].to(cfg.dtype)
        positions = torch.arange(tokens.shape[1], device=x.device)
        ks, vs = [], []
        for lp in _layers(params["layers"]):
            q, k, v = local_qkv(lp, x, positions)
            o = select_attention(cfg.use_flash)(
                q, lm._repeat_kv(k, n_rep), lm._repeat_kv(v, n_rep))
            x = mlp(lp, out_proj(lp, o, x))
            ks.append(k)
            vs.append(v)
        logits = _llama_finish(params, _cut(x, last_only, last_index))
        return logits, _pack_prefill_cache(torch.stack(ks), torch.stack(vs),
                                           cap, kv_int8)

    def decode(params, _cfg, cache, tok):
        pos = cache["pos"]
        x = params["embed"][tok][:, None, :].to(cfg.dtype)
        # A scalar pos rotates every row alike, [B] each slot by its own.
        positions = pos[:, None] if pos.ndim else pos.reshape(1)
        x, out = run_decode_layers(
            params["layers"], x, cache,
            lambda lp, x, p: local_qkv(lp, x, positions),
            make_attend(cache["k"].shape[2]))
        return _llama_finish(params, x)[:, 0], out

    def window(params, _cfg, cache, tokens):
        W = tokens.shape[1]
        pos = cache["pos"]
        x = params["embed"][tokens].to(cfg.dtype)
        positions = spec._positions(pos, W)
        x, kc, vc = decode_layer_scan(
            params["layers"], x, cache["k"], cache["v"], pos,
            lambda lp, x, p: local_qkv(lp, x, positions),
            make_attend(cache["k"].shape[2]))
        return _llama_finish(params, x), {"k": kc, "v": vc, "pos": pos + W}

    return prefill, window, decode


def _rowwise(ffn):
    """``ffn`` with each row's tokens as one routed call (the routing of a
    B = 1 run, as the JAX package's vmap over rows routes)."""
    return lambda lp, x: torch.cat([ffn(lp, x[b:b + 1])
                                    for b in range(x.shape[0])])


def make_tp_speculative_generate(draft_cfg, cfg, mesh, n_new: int,
                                 k: int = 4, axis: str = "tp",
                                 temperature: float = 0.0,
                                 ep_dispatch: str = "auto", device=None):
    """Tensor-parallel speculative decoding: the draft proposes and the
    target verifies k tokens a window pass, BOTH models split over the
    mesh's ``axis`` (each rank its heads of the weights and KV caches, two
    psums a layer). GPT-2, Llama and MoE-transformer families, mixed
    freely (config types pick each side's operations; the vocabularies
    must match; an MoE target must route drop-free).

    Returns ``generate(draft_params, params, prompt, key=None) -> (tokens
    [B, S + n_new], stats)`` with stats as ``speculative_generate``'s, run
    by every rank with the same arguments on ``device`` (``None`` means
    the GPU). ``temperature=0`` is greedy: the tokens equal the one-device
    ``speculative_generate``'s. Otherwise the accept/resample rule draws
    from ``key_generator(key)`` (an int seed, the same on every rank; at B
    > 1 row b from ``split_generator`` of it), every rank drawing alike.
    B > 1 rows run the port's batched loop, each row's tokens and stats
    those of its own B = 1 run. ``ep_dispatch`` (MoE sides) is
    :func:`make_tp_generate_moe`'s, each row's tokens one routed call."""
    if draft_cfg.vocab != cfg.vocab:
        raise ValueError(f"draft/target vocabularies differ "
                         f"({draft_cfg.vocab} vs {cfg.vocab})")
    if k < 2:
        raise ValueError(f"k = {k}: a round needs at least one proposal")
    if ep_dispatch not in ("auto", "sharded", "replicated"):
        raise ValueError(f"ep_dispatch {ep_dispatch!r}")
    spec._check_moe_target(cfg)
    tp = mesh.shape[axis]
    dev = resolve_device(device)

    def fam(c):
        """(speculative ops, rank_params) of one side's family."""
        if type(c) is lm.LlamaConfig:
            return (_llama_tp_family_ops(c, tp, axis),
                    _llama_rank_params(c, mesh, axis, dev))
        if type(c) is mtf.MoeTransformerConfig:
            moe_ffn = _rowwise(_make_moe_ffn(c, tp, axis, ep_dispatch))
            return (_tp_family_ops(c, tp, axis, ffn=moe_ffn),
                    _gpt2_rank_params(c, mesh, axis, tp_param_specs_moe(axis),
                                      tp_shard_params, _moe_scale_specs(axis),
                                      "TP speculative MoE", dev))
        if type(c) is tfm.TransformerConfig:
            return (_tp_family_ops(c, tp, axis),
                    _gpt2_rank_params(c, mesh, axis, tp_param_specs(axis),
                                      tp_shard_params,
                                      _gpt2_scale_specs(axis),
                                      "TP speculative GPT-2", dev))
        raise TypeError(
            "TP speculative decoding supports the GPT-2, Llama, and "
            f"MoE-transformer families; got {type(c).__name__}")

    t_ops, t_rank = fam(cfg)
    d_ops, d_rank = fam(draft_cfg)
    hooks = (spec._greedy_hooks(k) if temperature == 0.0
             else spec._sample_hooks(k, float(temperature)))

    def generate(draft_params, params, prompt, key=None):
        _check_key(temperature, key)
        dparams, params = d_rank(draft_params), t_rank(params)
        prompt = torch.as_tensor(prompt, device=dev)
        if prompt.ndim != 2:
            raise ValueError(f"prompt [B, S], got {tuple(prompt.shape)}")
        B, S = prompt.shape
        run = spec._make_run(draft_cfg, cfg, S, n_new, k, *hooks,
                             ops=(t_ops[0], t_ops[1], d_ops[0], d_ops[2]))
        gens = None
        if temperature != 0.0:
            gen = key_generator(key, dev)
            gens = [gen] if B == 1 else split_generator(gen, B)
        with mesh, torch.no_grad():
            toks, rounds, acc = run(dparams, params, prompt, gens)
        return toks, spec._stats(rounds, acc)

    return generate


# -- tensor-parallel continuous batching (models/serving.py) -------------------


def make_tp_server_fns(params, cfg, mesh, chunk: int = 1, axis: str = "tp",
                       family: str = "gpt2", ep_dispatch: str = "auto",
                       kv_int8: bool = False, device=None):
    """The server-fns tuple of ``models.serving._serve`` (``(prefill_fn,
    step_fn, scatter_fn, chunk, kv_int8, None)``) whose three functions
    run tensor-parallel over the mesh: every rank runs the same serve call
    (``serve_greedy(..., server_fns=fns)``) and calls them in the same
    order, and each makes the mesh active itself. Each slot's KV cache
    holds this rank's heads (Llama: its KV groups): the slots the serve
    loop allocates at the family's full head count are cut to this rank's
    heads at their first use. Per-slot positions ride the decode
    scaffold's vector-pos mode, so the tokens equal the one-device
    ``serve_greedy``'s up to the split's summation order (exact in f32;
    bf16 may flip near-tied argmaxes). The step runs ``chunk`` greedy
    decodes.

    ``family``: "gpt2", "moe" (GPT-2 attention and the routed expert FFN,
    ``ep_dispatch`` as :func:`make_tp_generate_moe`) or "llama".
    ``kv_int8`` serves from int8 slot caches (gpt2/llama): each rank
    quantizes its own heads. ``params`` is the ordinary tree or this
    rank's slice; it is laid out and sliced ONCE here, int8 weight
    checkpoints included. ``device=None`` means the GPU."""
    tp = mesh.shape[axis]
    dev = resolve_device(device)
    if family == "gpt2":
        ops_prefill, _, ops_decode = _tp_family_ops(cfg, tp, axis,
                                                    kv_int8=kv_int8)
        rank_params = _gpt2_rank_params(
            cfg, mesh, axis, tp_param_specs(axis), tp_shard_params,
            _gpt2_scale_specs(axis), "TP serving", dev)
        heads = cfg.n_heads
    elif family == "moe":
        if kv_int8:
            raise ValueError("int8 KV slot caches: gpt2/llama only for now")
        moe_ffn = _make_moe_ffn(cfg, tp, axis, ep_dispatch)
        ops_prefill, _, ops_decode = _tp_family_ops(cfg, tp, axis,
                                                    ffn=moe_ffn)
        rank_params = _gpt2_rank_params(
            cfg, mesh, axis, tp_param_specs_moe(axis), tp_shard_params_moe,
            _moe_scale_specs(axis), "TP serving", dev)
        heads = cfg.n_heads
    elif family == "llama":
        ops_prefill, _, ops_decode = _llama_tp_family_ops(
            cfg, tp, axis, kv_int8=kv_int8)
        rank_params = _llama_rank_params(cfg, mesh, axis, dev)
        heads = cfg.n_kv_heads
    else:
        raise ValueError(f"unknown family {family!r}")
    sharded = rank_params(params)
    local, r = heads // tp, mesh.coords[axis]

    def own(slots):
        """The slots with this rank's heads (cut once from the full
        allocation)."""
        if slots["k"].shape[3] == local:
            return slots
        out = {key: slots[key].narrow(3, r * local, local).contiguous()
               for key in ("k", "v", "ks", "vs") if key in slots}
        out["pos"] = slots["pos"]
        return out

    def prefill_fn(tokens, last):
        """[1, S_bucket], real last index -> (logits [1, 1, vocab], the
        bucket-length cache of this rank's heads, without 'pos')."""
        with mesh, torch.no_grad():
            logits, cache = ops_prefill(sharded, cfg, tokens,
                                        tokens.shape[1], last_index=last)
        cache.pop("pos")
        return logits, cache

    def step_fn(slots, tok, keys=None):
        slots = own(slots)
        toks = []
        with mesh, torch.no_grad():
            for _ in range(chunk):
                logits, slots = ops_decode(sharded, cfg, slots, tok)
                tok = logits.argmax(dim=-1).to(torch.int32)
                toks.append(tok)
        return slots, torch.stack(toks)                # toks [chunk, B]

    def scatter_fn(slots, one, slot_idx, new_pos):
        slots = own(slots)
        for key in [k for k in ("k", "v", "ks", "vs") if k in slots]:
            src = one[key][:, 0]                    # [L, S_bucket, H, *]
            slots[key][:, slot_idx, :src.shape[1]] = src
        slots["pos"][slot_idx] = new_pos
        return slots

    return prefill_fn, step_fn, scatter_fn, chunk, kv_int8, None
