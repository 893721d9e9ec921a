"""Llama-family decoder (RMSNorm, RoPE, SwiGLU, grouped-query attention):
the JAX package's ``models/llama.py`` in PyTorch, its serving path.

Parameters are a plain dict of tensors in the JAX package's layout: every
per-layer tensor has a leading ``[n_layers]`` axis, matmul weights are
``[in, out]`` (``x @ w``), the output head ``unembed`` is untied ``[vocab,
d]``. The KV cache stores only the ``n_kv_heads`` groups, ``{'k', 'v': [L,
B, max_len, Hkv, Dh], 'pos'}`` (plus f32 scales ``'ks', 'vs'`` beside int8
codes with ``kv_int8``): GQA's memory win. Compute runs in ``cfg.dtype``;
the norms, RoPE, softmax state and the logits are f32.

Prefill broadcasts the K/V groups to the query heads and runs the flash
kernel (K1, ``ops/attention.py``); decode reads the un-repeated cache
through the grouped decode kernel (K2, ``ops/flash_decode.py``). On the
CPU both run their plain versions. Llama-3-8B (:func:`llama3_8b`) has head
dim 128, for which both kernels have their own instantiations.
:func:`loss_fn` trains through K1's forward and its blockwise backward;
the framework's train step (``mpi_acx_torch/train.py``) runs the same
blocks sequence-parallel, with B10 on every layer; its layout on the mesh
is ``train.llama_param_specs``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from mpi_acx_torch import profiling
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models.decoding import (fill_kv_cache, greedy_generate,
                                           grouped_decode_attend,
                                           run_decode_layers,
                                           sample_generate)
# The JAX tree's converter and the device check are GPT-2's, leaf for leaf
# (re-exported under the JAX package's names).
from mpi_acx_torch.models.transformer import (  # noqa: F401
    _unembed, check_device, params_from_jax)
from mpi_acx_torch.ops.attention import select_attention
from mpi_acx_torch.ops.wquant import wread
from mpi_acx_torch.ops.xent import chunked_xent_ll


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab: int = 128256
    d_model: int = 4096
    n_heads: int = 32
    n_kv_heads: int = 8          # GQA: queries share K/V head groups
    n_layers: int = 32
    d_ff: int = 14336            # SwiGLU hidden
    max_seq: int = 8192
    rope_theta: float = 500000.0
    dtype: Any = torch.bfloat16  # compute dtype
    # Prefill attention (ops/attention.select_attention) and decode
    # attention (ops/flash_decode.select_decode_attend): None or True ->
    # the kernel on the GPU, its plain version on the CPU; False -> the
    # plain version everywhere.
    use_flash: Optional[bool] = None
    decode_flash: Optional[bool] = None

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def llama3_8b() -> LlamaConfig:
    """Llama-3-8B geometry (BASELINE.json configs[4]): 32 layers, d 4096,
    32 query heads over 8 KV groups (head dim 128), SwiGLU 14336, vocab
    128256, RoPE theta 500000."""
    return LlamaConfig()


def tiny_llama(vocab: int = 256, d_model: int = 64, n_heads: int = 4,
               n_kv_heads: int = 2, n_layers: int = 2, d_ff: int = 128,
               max_seq: int = 64) -> LlamaConfig:
    """Small config for tests."""
    return LlamaConfig(vocab=vocab, d_model=d_model, n_heads=n_heads,
                       n_kv_heads=n_kv_heads, n_layers=n_layers, d_ff=d_ff,
                       max_seq=max_seq, rope_theta=10000.0)


Params = Dict[str, Any]


def init_params(cfg: LlamaConfig, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Stacked-layer parameters in ``dtype`` on ``device`` (``None`` means
    the GPU): matmul weights N(0, 0.02), the output projections (``wo``,
    ``w_down``) scaled by 1/sqrt(2L), norms at 1 — the JAX package's
    scheme, not its numbers. Each leaf is drawn on the device itself, one
    after the other, from a ``torch.Generator`` there seeded with ``seed``:
    Llama-3-8B's 16 GB of bf16 weights never pass through the host."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s = 0.02

    def nrm(*shape, scale=s):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    out_scale = s / math.sqrt(2 * L)
    return {
        "embed": nrm(cfg.vocab, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": nrm(L, d, hq * dh),
            "wk": nrm(L, d, hkv * dh),
            "wv": nrm(L, d, hkv * dh),
            "wo": nrm(L, hq * dh, d, scale=out_scale),
            "mlp_norm": ones(L, d),
            "w_gate": nrm(L, d, ff),
            "w_up": nrm(L, d, ff),
            "w_down": nrm(L, ff, d, scale=out_scale),
        },
        "final_norm": ones(d),
        # Untied output head (Llama style).
        "unembed": nrm(cfg.vocab, d),
    }


def rmsnorm(x, g, eps=1e-5):
    """RMSNorm computed in f32, returned in x's dtype."""
    x32 = x.float()
    rms = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    return (x32 * rms * g).to(x.dtype)


_FREQS: Dict[tuple, torch.Tensor] = {}


def _rope_freqs(D: int, theta: float, device) -> torch.Tensor:
    """RoPE's D/2 frequencies in f32, as the JAX package forms them: the
    exponents ``-i / (D/2)`` in f32, ``theta`` raised to them (in f64,
    rounded once to f32). Made once per (D, theta, device) and kept, so a
    step copies nothing from the host (a CUDA graph can capture it)."""
    key = (D, float(theta), torch.device(device))
    if key not in _FREQS:
        half = D // 2
        expo = -torch.arange(0, half, dtype=torch.float32) / half
        _FREQS[key] = (theta ** expo.double()).float().to(device)
    return _FREQS[key]


def rope(x, positions, theta: float):
    """Rotary embedding; x [..., S, H, D], positions [S] (or [..., S]).
    The angles are f32: the positions in f32 times :func:`_rope_freqs`."""
    D = x.shape[-1]
    half = D // 2
    freqs = _rope_freqs(D, theta, x.device)
    ang = positions[..., None].float() * freqs                # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                        # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _repeat_kv(x, n_rep: int):
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D]: broadcast K/V head groups to
    the query heads (GQA -> MHA view for the attention kernel)."""
    if n_rep == 1:
        return x
    B, S, H, D = x.shape
    return x[:, :, :, None, :].expand(B, S, H, n_rep, D).reshape(
        B, S, H * n_rep, D)


def _qkv(cfg: LlamaConfig, lp: Params, x, positions):
    B, S, _ = x.shape
    h = rmsnorm(x, lp["attn_norm"])
    q = (h @ wread(lp, "wq", x.dtype)).reshape(B, S, cfg.n_heads,
                                               cfg.head_dim)
    k = (h @ wread(lp, "wk", x.dtype)).reshape(B, S, cfg.n_kv_heads,
                                               cfg.head_dim)
    v = (h @ wread(lp, "wv", x.dtype)).reshape(B, S, cfg.n_kv_heads,
                                               cfg.head_dim)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attend(cfg: LlamaConfig, q, k, v):
    """Post-RoPE causal attention with K/V broadcast to the query heads,
    [B, S, Hq, Dh] -> [B, S, Hq*Dh]: K1 on a CUDA tensor (its plain
    version on the CPU), as ``cfg.use_flash`` selects."""
    n_rep = cfg.n_heads // cfg.n_kv_heads
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    o = select_attention(cfg.use_flash)(q, k, v)
    B, S = q.shape[:2]
    return o.reshape(B, S, cfg.n_heads * cfg.head_dim)


def _mlp(cfg: LlamaConfig, lp: Params, x):
    """SwiGLU: x + (silu(h W_gate) * h W_up) W_down, h = rmsnorm(x)."""
    h = rmsnorm(x, lp["mlp_norm"])
    gate = F.silu(h @ wread(lp, "w_gate", x.dtype))
    up = h @ wread(lp, "w_up", x.dtype)
    return x + (gate * up) @ wread(lp, "w_down", x.dtype)


def block(cfg: LlamaConfig, lp: Params, x, positions):
    """One decoder block; x [B, S, d] in compute dtype."""
    q, k, v = _qkv(cfg, lp, x, positions)
    x = x + _attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
    return _mlp(cfg, lp, x)


def _layer(params: Params, i: int) -> Params:
    return {name: a[i] for name, a in params["layers"].items()}


def _check_len(S, cfg: LlamaConfig, max_len=None):
    if S > cfg.max_seq or (max_len is not None and S > max_len):
        raise ValueError(f"sequence length {S} exceeds max_seq "
                         f"{cfg.max_seq}" + ("" if max_len is None else
                                             f" or max_len {max_len}"))


def _hidden(params: Params, cfg: LlamaConfig, tokens):
    """The model trunk: tokens [B, S] -> final-rmsnormed hidden states
    [B, S, d] in ``cfg.dtype``."""
    S = tokens.shape[1]
    _check_len(S, cfg)
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        x = block(cfg, _layer(params, i), x, positions)
    return rmsnorm(x, params["final_norm"])


def forward(params: Params, cfg: LlamaConfig, tokens):
    """tokens [B, S] -> logits [B, S, vocab] (f32)."""
    return _unembed(_hidden(params, cfg, tokens), params["unembed"])


def loss_fn(params: Params, cfg: LlamaConfig, tokens, targets,
            xent_chunk: Optional[int] = None):
    """Mean next-token cross-entropy; differentiable in the parameters.
    ``xent_chunk`` selects the memory-bounded chunked-vocab CE
    (ops/xent.py): the [B, S, vocab] logits never exist; same values and
    gradients up to f32 summation order."""
    targets = targets.long()
    if xent_chunk is not None:
        B, S = tokens.shape
        x = _hidden(params, cfg, tokens)
        ll = chunked_xent_ll(x.reshape(B * S, -1), params["unembed"],
                             targets.reshape(-1), xent_chunk)
        return -ll.mean()
    logp = torch.log_softmax(forward(params, cfg, tokens), dim=-1)
    return -logp.gather(-1, targets[..., None])[..., 0].mean()


# -- KV-cache decode (GQA: the cache stores only n_kv_heads) ---------------


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int,
                  kv_int8: bool = False, device=None):
    """Zeroed GQA cache: {'k','v': [L, B, max_len, Hkv, Dh] in cfg.dtype,
    'pos': int32 scalar} on ``device`` (``None`` means the GPU);
    ``kv_int8=True`` stores int8 codes plus per-(position, head) f32 scales
    'ks'/'vs' [L, B, max_len, Hkv, 1] (ops/kvquant.py)."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
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


def prefill(params: Params, cfg: LlamaConfig, tokens, max_len: int,
            last_only: bool = False, kv_int8: bool = False,
            last_index: Optional[int] = None):
    """Prompt pass filling a fresh KV cache (layout: :func:`init_kv_cache`).

    tokens [B, S] -> (logits [B, S, vocab] f32, cache with pos=S). Prefill
    attention runs on the exact K/V; with ``kv_int8`` only the cache
    entries are quantized. With ``last_only`` the unembedding runs on the
    final position alone; ``last_index`` picks that position instead (for
    bucket-padded serving prompts, models/serving.py)."""
    with profiling.annotate("acx.model.prefill"):
        B, S = tokens.shape
        _check_len(S, cfg, max_len)
        x = params["embed"][tokens].to(cfg.dtype)
        positions = torch.arange(S, device=x.device)
        ks, vs = [], []
        for i in range(cfg.n_layers):
            lp = _layer(params, i)
            q, k, v = _qkv(cfg, lp, x, positions)
            x = x + _attend(cfg, q, k, v) @ wread(lp, "wo", x.dtype)
            x = _mlp(cfg, lp, x)
            ks.append(k)
            vs.append(v)
        x = rmsnorm(x, params["final_norm"])
        if last_index is not None:
            x = x[:, last_index:last_index + 1]
        elif last_only:
            x = x[:, -1:]
        logits = _unembed(x, params["unembed"])
        cache = fill_kv_cache(
            init_kv_cache(cfg, B, max_len, kv_int8=kv_int8, device=x.device),
            torch.stack(ks), torch.stack(vs), S)
        return logits, cache


def decode_step(params: Params, cfg: LlamaConfig, cache, token):
    """One autoregressive step: token [B] -> (logits [B, vocab] f32, cache
    with pos + 1). The cache's k/v tensors are updated in place (see
    models/decoding.py). ``cache['pos']`` is a scalar (one position for
    every row) or [B] (continuous-batching serving): RoPE then rotates each
    slot by its own position ([B, 1] positions)."""
    with profiling.annotate("acx.model.decode"):
        pos = cache["pos"]
        max_len = cache["k"].shape[2]
        n_rep = cfg.n_heads // cfg.n_kv_heads
        x = params["embed"][token][:, None, :].to(cfg.dtype)
        positions = pos[:, None] if pos.ndim else pos.reshape(1)

        def qkv_fn(lp, x, pos):
            return _qkv(cfg, lp, x, positions)         # k, v [B, 1, Hkv, Dh]

        def attend_fn(lp, x, q, kc, vc, pos):
            o = grouped_decode_attend(q, kc, vc, pos, max_len, n_rep,
                                      flash=cfg.decode_flash)
            return _mlp(cfg, lp, x + o @ wread(lp, "wo", x.dtype))

        with profiling.annotate("acx.model.layers"):
            x, out_cache = run_decode_layers(params["layers"], x, cache,
                                             qkv_fn, attend_fn)
        with profiling.annotate("acx.model.head"):
            x = rmsnorm(x, params["final_norm"])
            logits = _unembed(x, params["unembed"])[:, 0]
        return logits, out_cache


def generate(params: Params, cfg: LlamaConfig, prompt, n_new: int,
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


def generate_sample(params: Params, cfg: LlamaConfig, prompt, n_new: int,
                    key: torch.Generator, temperature: float = 1.0,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    max_len: Optional[int] = None, kv_int8: bool = False,
                    device=None):
    """Stochastic decode (temperature / top-k / top-p nucleus) from
    ``key``, a ``torch.Generator`` on ``device`` (``None`` means the
    GPU)."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return sample_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, key, temperature, top_k, top_p, max_len)
