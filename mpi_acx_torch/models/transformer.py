"""Decoder-only transformer (GPT-2 family): the JAX package's
``models/transformer.py`` in PyTorch.

Parameters are a plain dict of tensors with the JAX package's layout:
every per-layer tensor has a leading ``[n_layers]`` axis, matmul weights
are ``[in, out]`` (``x @ w``), and the KV cache is ``{'k', 'v': [L, B,
max_len, H, Dh], 'pos'}`` (plus f32 scales ``'ks', 'vs'`` beside int8
codes with ``kv_int8``). Compute runs in ``cfg.dtype``; layernorm,
softmax state and the logits are f32. Attention goes through the
hand-written kernels on the GPU (``ops/attention.py`` in prefill,
``ops/flash_decode.py`` in decode) and through their plain versions on the
CPU.

GPT-2 124M is :func:`gpt2_small`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mpi_acx_torch import profiling
from mpi_acx_torch.device import on_device, resolve_device
from mpi_acx_torch.models.decoding import (fill_kv_cache, greedy_generate,
                                           grouped_decode_attend,
                                           run_decode_layers,
                                           sample_generate)
from mpi_acx_torch.ops.attention import select_attention
from mpi_acx_torch.ops.wquant import wread
from mpi_acx_torch.ops.xent import chunked_xent_ll


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 50257
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_seq: int = 1024
    dtype: Any = torch.bfloat16  # compute dtype
    # Prefill attention (ops/attention.select_attention): None or True ->
    # the flash kernel on the GPU, its plain version on the CPU; False ->
    # the plain version everywhere.
    use_flash: Optional[bool] = None
    # Decode attention (ops/flash_decode.select_decode_attend), same rule.
    decode_flash: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def gpt2_small() -> TransformerConfig:
    """GPT-2 124M: 12L / 768d / 12H / 3072ff / 50257 vocab / 1024 ctx."""
    return TransformerConfig()


def tiny_config(vocab: int = 512, d_model: int = 128, n_heads: int = 4,
                n_layers: int = 4, d_ff: int = 512,
                max_seq: int = 128) -> TransformerConfig:
    """Small config for tests."""
    return TransformerConfig(vocab=vocab, d_model=d_model, n_heads=n_heads,
                             n_layers=n_layers, d_ff=d_ff, max_seq=max_seq)


Params = Dict[str, Any]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Params:
    """Stacked-layer parameters, f32, drawn N(0, 0.02) from a
    ``torch.Generator`` seeded with ``seed`` (output projections scaled by
    1/sqrt(2L), norms at 1/0, biases 0) — the JAX package's scheme, not its
    numbers. The draw runs on the CPU, so a seed gives the same weights on
    every device; ``device=None`` means the GPU."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    s = 0.02

    def nrm(*shape, scale=s):
        return torch.randn(shape, generator=g) * scale

    params = {
        "embed": nrm(cfg.vocab, d),
        "pos": nrm(cfg.max_seq, d),
        "layers": {
            "ln1_g": torch.ones(L, d), "ln1_b": torch.zeros(L, d),
            "wqkv": nrm(L, d, 3 * d),
            "wo": nrm(L, d, d, scale=s / math.sqrt(2 * L)),
            "ln2_g": torch.ones(L, d), "ln2_b": torch.zeros(L, d),
            "w1": nrm(L, d, ff), "b1": torch.zeros(L, ff),
            "w2": nrm(L, ff, d, scale=s / math.sqrt(2 * L)),
            "b2": torch.zeros(L, d),
        },
        "lnf_g": torch.ones(d), "lnf_b": torch.zeros(d),
    }
    return _tree_map(lambda t: t.to(dev), params)


def params_from_jax(np_tree, device=None,
                    requires_grad: bool = False) -> Params:
    """The JAX package's parameter tree (numpy arrays, e.g. from
    ``jax.device_get``; a stage-sliced tree too) as the port's parameters
    on ``device`` (``None`` means the GPU), dtypes kept — so both packages
    compute the same function in the parity tests. ``requires_grad``
    makes every floating leaf a leaf tensor that requires grad."""
    dev = resolve_device(device)

    def conv(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":       # no numpy bf16 in torch
            t = torch.from_numpy(a.astype(np.float32)).to(
                dev, torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(a)).to(dev)     # a writable copy
        return t.requires_grad_(requires_grad and t.is_floating_point())

    return _tree_map(conv, np_tree)


def cast_params(params: Params, dtype=torch.bfloat16) -> Params:
    """The whole parameter tree in ``dtype``, for inference."""
    return _tree_map(lambda p: p.to(dtype), params)


def layernorm(x, g, b, eps=1e-5):
    """LayerNorm computed in f32, returned in x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * g + b).to(x.dtype)


def _unembed(x, embed):
    """Tied unembedding: operands in x's dtype, f32 accumulation and f32
    logits (the JAX package's ``preferred_element_type=float32``) — the
    logits are never rounded to bf16 before an argmax."""
    w = embed.to(x.dtype)
    if x.dtype == torch.float32:
        return x @ w.T
    # aten::mm.dtype (the out_dtype product) has no derivative, so a call
    # that is differentiated takes the f32 form below.
    grad = torch.is_grad_enabled() and (x.requires_grad or w.requires_grad)
    if x.is_cuda and not grad:
        flat = torch.mm(x.reshape(-1, x.shape[-1]), w.T,
                        out_dtype=torch.float32)
        return flat.reshape(*x.shape[:-1], w.shape[0])
    # Products of bf16 values are exact in f32: the same function.
    return x.float() @ w.float().T


def _attend(cfg: TransformerConfig, q, k, v):
    """Causal attention, [B, S, H, Dh] -> [B, S, d]."""
    B, S = q.shape[:2]
    o = select_attention(cfg.use_flash)(q, k, v)
    return o.reshape(B, S, cfg.d_model)


def _qkv(cfg: TransformerConfig, lp: Params, x):
    B, S, _ = x.shape
    h = layernorm(x, lp["ln1_g"], lp["ln1_b"])
    qkv = h @ wread(lp, "wqkv", x.dtype)
    q, k, v = qkv.split(cfg.d_model, dim=-1)
    return tuple(t.reshape(B, S, cfg.n_heads, cfg.head_dim)
                 for t in (q, k, v))


def _mlp(cfg: TransformerConfig, lp: Params, x):
    h = layernorm(x, lp["ln2_g"], lp["ln2_b"])
    # jax.nn.gelu defaults to the tanh approximation.
    y = F.gelu(h @ wread(lp, "w1", x.dtype) + lp["b1"].to(x.dtype),
               approximate="tanh")
    return x + y @ wread(lp, "w2", x.dtype) + lp["b2"].to(x.dtype)


def block(cfg: TransformerConfig, lp: Params, x):
    """One transformer block; x [B, S, d] in compute dtype."""
    q, k, v = _qkv(cfg, lp, x)
    x = x + _attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
    return _mlp(cfg, lp, x)


def _layer(params: Params, i: int) -> Params:
    return {name: a[i] for name, a in params["layers"].items()}


def _hidden(params: Params, cfg: TransformerConfig, tokens):
    """The model trunk: tokens [B, S] -> final-layernormed hidden states
    [B, S, d] in ``cfg.dtype``. Shared by :func:`forward` and the
    chunked-CE loss path."""
    S = tokens.shape[1]
    x = (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)
    for i in range(cfg.n_layers):
        x = block(cfg, _layer(params, i), x)
    return layernorm(x, params["lnf_g"], params["lnf_b"])


def forward(params: Params, cfg: TransformerConfig, tokens):
    """tokens [B, S] -> logits [B, S, vocab] (f32)."""
    return _unembed(_hidden(params, cfg, tokens), params["embed"])


def loss_fn(params: Params, cfg: TransformerConfig, tokens, targets,
            xent_chunk: Optional[int] = None):
    """Mean next-token cross-entropy; differentiable in the parameters.

    ``xent_chunk`` selects the memory-bounded chunked-vocab CE
    (ops/xent.py): the [B, S, vocab] logits never exist, the hidden states
    go straight into the online-logsumexp loop and the backward recomputes
    logit tiles. Same values and gradients up to f32 summation order."""
    if xent_chunk is not None:
        B, S = tokens.shape
        x = _hidden(params, cfg, tokens)
        ll = chunked_xent_ll(x.reshape(B * S, -1), params["embed"],
                             targets.reshape(-1), xent_chunk)
        return -ll.mean()
    logp = torch.log_softmax(forward(params, cfg, tokens), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def init_kv_cache(cfg: TransformerConfig, batch: int, max_len: int,
                  kv_int8: bool = False, device=None):
    """Zeroed cache: {'k','v': [L, B, max_len, H, Dh] in cfg.dtype, 'pos':
    int32 scalar} on ``device`` (``None`` means the GPU). ``kv_int8=True``
    stores int8 codes in 'k'/'v' plus per-(position, head) f32 scales
    'ks'/'vs' [L, B, max_len, H, 1] (ops/kvquant.py)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
    kv_dtype = torch.int8 if kv_int8 else cfg.dtype
    cache = {
        "k": torch.zeros(shape, dtype=kv_dtype, device=dev),
        "v": torch.zeros(shape, dtype=kv_dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }
    if kv_int8:
        cache["ks"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev)
        cache["vs"] = torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                  device=dev)
    return cache


def prefill(params: Params, cfg: TransformerConfig, tokens, max_len: int,
            last_only: bool = False, ffn=None, kv_int8: bool = False,
            last_index: Optional[int] = None):
    """Run the prompt through the model, filling a fresh KV cache.

    tokens [B, S] -> (logits [B, S, vocab] f32, cache with pos=S). With
    ``last_only`` the unembedding runs on the final position alone (logits
    [B, 1, vocab]); ``last_index`` picks that position instead (for
    right-padded prompts, models/serving.py). ``ffn(cfg, lp, x) -> x``
    replaces the block's feed-forward half (default :func:`_mlp`): the MoE
    family runs this scaffold with its routed FFN
    (models/moe_transformer.py). ``kv_int8`` selects the int8 cache:
    attention runs on the exact K/V and only the cache entries are
    quantized."""
    with profiling.annotate("acx.model.prefill"):
        ffn = ffn or _mlp
        B, S = tokens.shape
        if S > max_len or S > cfg.max_seq:
            raise ValueError(f"prompt length {S} exceeds max_len {max_len} or "
                             f"max_seq {cfg.max_seq}")
        x = (params["embed"][tokens] + params["pos"][:S]).to(cfg.dtype)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params, i)
            q, k, v = _qkv(cfg, lp, x)
            x = x + _attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
            x = ffn(cfg, lp, x)
            ks.append(k)
            vs.append(v)
        x = layernorm(x, params["lnf_g"], params["lnf_b"])
        if last_index is not None:
            x = x[:, last_index:last_index + 1]
        elif last_only:
            x = x[:, -1:]
        logits = _unembed(x, params["embed"])
        cache = fill_kv_cache(
            init_kv_cache(cfg, B, max_len, kv_int8=kv_int8, device=x.device),
            torch.stack(ks), torch.stack(vs), S)
        return logits, cache


def decode_step(params: Params, cfg: TransformerConfig, cache, token,
                ffn=None):
    """One autoregressive step: token [B] -> (logits [B, vocab] f32, cache
    with pos + 1). The cache's k/v tensors are updated in place (see
    models/decoding.py); ``cache['pos']`` is a scalar, or [B] with one
    position per slot (continuous-batching serving). ``ffn`` replaces the
    feed-forward half as in :func:`prefill`."""
    with profiling.annotate("acx.model.decode"):
        ffn = ffn or _mlp
        pos = cache["pos"]
        max_len = cache["k"].shape[2]
        # Like JAX's gather, a position past the table reads its last row.
        pe = params["pos"][pos.clamp(0, cfg.max_seq - 1)]
        pe = pe[:, None, :] if pos.ndim else pe[None, None, :]
        x = (params["embed"][token][:, None, :] + pe).to(cfg.dtype)

        def qkv_fn(lp, x, pos):
            return _qkv(cfg, lp, x)                        # [B, 1, H, Dh]

        def attend_fn(lp, x, q, kc, vc, pos):
            o = grouped_decode_attend(q, kc, vc, pos, max_len, n_rep=1,
                                      flash=cfg.decode_flash)
            return ffn(cfg, lp, x + o @ wread(lp, "wo", x.dtype))

        with profiling.annotate("acx.model.layers"):
            x, out_cache = run_decode_layers(params["layers"], x, cache,
                                             qkv_fn, attend_fn)
        with profiling.annotate("acx.model.head"):
            x = layernorm(x, params["lnf_g"], params["lnf_b"])
            logits = _unembed(x, params["embed"])[:, 0]
        return logits, out_cache


def stage_slice(params: Params, n_stages: int) -> Params:
    """Stacked layers [L, ...] -> [n_stages, L / n_stages, ...], so a
    pipeline stage takes its own layer block. The staged tensors are views
    of the input's (same storage, detached, with the input's
    ``requires_grad``), so an in-place update of one updates the other."""
    L = next(iter(params["layers"].values())).shape[0]
    if L % n_stages:
        raise ValueError(f"{L} layers do not split into {n_stages} stages")
    per = L // n_stages

    def rs(p):
        return p.detach().reshape((n_stages, per) + tuple(
            p.shape[1:])).requires_grad_(p.requires_grad)

    out = dict(params)
    out["layers"] = _tree_map(rs, params["layers"])
    return out


def stage_slice_interleaved(params: Params, n_stages: int,
                            n_virtual: int) -> Params:
    """Stacked layers [L, ...] -> [n_stages, n_virtual, L / (n_stages *
    n_virtual), ...] for the interleaved pipeline schedule: global stage
    g = j * n_stages + s lands at [s, j] (device s, chunk j), so
    consecutive layer blocks snake over the devices n_virtual times. Views
    of the input's tensors, as :func:`stage_slice` gives."""
    L = next(iter(params["layers"].values())).shape[0]
    G = n_stages * n_virtual
    if L % G:
        raise ValueError(f"{L} layers do not split into {n_stages} stages "
                         f"x {n_virtual} chunks")
    per = L // G

    def rs(p):
        q = p.detach().reshape((n_virtual, n_stages, per) + tuple(
            p.shape[1:]))
        return q.transpose(0, 1).requires_grad_(p.requires_grad)

    out = dict(params)
    out["layers"] = _tree_map(rs, params["layers"])
    return out


def check_device(params: Params, dev: torch.device) -> None:
    """Raise unless the parameters lie on ``dev``."""
    if not on_device(params["embed"], dev):
        raise ValueError(f"params are on {params['embed'].device}, the "
                         f"call asks for {dev}")


def generate(params: Params, cfg: TransformerConfig, prompt, n_new: int,
             max_len: Optional[int] = None, kv_int8: bool = False,
             device=None):
    """Greedy decode: prompt [B, S] -> [B, S + n_new] on ``device``
    (``None`` means the GPU; the parameters must already be there).
    ``kv_int8`` decodes from the int8 cache (ops/kvquant.py)."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return greedy_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, max_len)


def generate_sample(params: Params, cfg: TransformerConfig, prompt,
                    n_new: int, key: torch.Generator,
                    temperature: float = 1.0, top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    max_len: Optional[int] = None, kv_int8: bool = False,
                    device=None):
    """Stochastic decode (temperature / top-k / top-p nucleus): prompt
    [B, S] -> [B, S + n_new] on ``device`` (``None`` means the GPU),
    drawing from ``key``, a ``torch.Generator`` there
    (models/decoding.py:sample_generate)."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return sample_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, key, temperature, top_k, top_p, max_len)
