"""DeepSeek-V2 decoder: multi-head latent attention over a latent cache and
DeepSeekMoE (64 routed experts of which each token takes 6, plus shared
experts), served through the port's normal path.

The equations are DeepSeek-V2's (Liu et al. 2024, arXiv:2405.04434,
section 2.1 MLA without query compression, section 2.2 DeepSeekMoE) and
those of the model's ``modeling_deepseek.py``:

* attention: ``q = h W_q``, 16 heads of 192 (128 "nope" then 64 rope
  dims); ``kv_a = h W_kv_a`` (576): ``c = RMSNorm(kv_a[:512])`` and
  ``k_pe = kv_a[512:]``, one rope key every head shares; ``c W_kv_b``
  gives each head ``k_nope`` (128) and ``v`` (128); ``W_o`` 2048 -> 2048.
  YaRN rotary positions on the 64 rope dims
  (``DeepseekV2YarnRotaryEmbedding``: theta, factor, the original
  context, beta_fast, beta_slow, the ramp between the correction dims)
  and the softmax scale ``192 ** -0.5 * m ** 2``, ``m = 0.1 *
  mscale_all_dim * ln(factor) + 1`` (:func:`ops.mla.softmax_scale`);
* FFN: the first ``first_dense`` layers a dense SwiGLU, the others MoE:
  the router's softmax over the experts, greedy top-k, not renormalised,
  times ``routed_scale``; each routed expert a SwiGLU of ``d_expert``; the
  shared experts one SwiGLU of ``n_shared * d_expert`` added for every
  token;
* RMSNorm (eps 1e-6) before each sublayer and at the end, an untied head.

Two forms of the attention agree: prefill runs the non-absorbed one
(per-head K of 192 and V of 128) through the prefill kernel (K1 at
192/128, ``ops/mla.py``); decode the absorbed one: ``q_lat = q_nope
W_UK^T`` (16 x 512) with ``q_pe`` attends the cached rows ``[c, k_pe]``
(576, every head's), the value is ``c`` and ``o = o_lat W_UV`` a head, then
``W_o`` (``ops/mla.py``'s decode kernel). The cache holds that one row a
token a layer, ``{'k': [L, B, max_len, 1, 576], 'pos', 'counts'}``, with
no ``'v'`` (``models/decoding.py``'s latent layout); ``'counts'`` [MoE
layers, 2] int64 counts, on the device and in the captured step, the
experts that received at least one pair and the pairs routed, summed over
the decode steps. The routed experts never drop a pair
(``ops/moe_experts.py``).

Departures from the published code, each kept by the plain reference
(``acxbench/reference/deepseek_v2.py``) too:

* RoPE pairs dims (i, i + 32), the port's halves convention; the
  published code interleaves pairs, the same map under a fixed
  permutation of the rope columns of ``W_q`` and ``W_kv_a``;
* the router's product is taken in f32 (beside its f32 softmax), so bf16
  rounding does not flip near-tied experts, and ties go to the lower
  expert.

Serving: bf16 cache only (``kv_int8`` is refused), no paged cache
(``LATENT_CACHE``: the paged server refuses the family), no tp serving
and no training. Parameters are a plain dict: the attention of every
layer stacked ``[L, ...]`` under ``'layers'``, the dense FFN layers under
``'dense'`` and the MoE layers under ``'moe'``, each stacked over its own
layers; products ``[in, out]``; the head ``unembed`` ``[vocab, d]``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from mpi_acx_torch import profiling
from mpi_acx_torch.device import resolve_device
from mpi_acx_torch.models.decoding import (PrefillParts, StepParts,
                                           greedy_generate, last_rows,
                                           run_decode_step, run_prefill)
from mpi_acx_torch.models.llama import rmsnorm
from mpi_acx_torch.models.transformer import _unembed, check_device
from mpi_acx_torch.ops.mla import mla_decode_attend, softmax_scale
from mpi_acx_torch.ops.mla import select_mla_attention as select_attention
from mpi_acx_torch.ops.moe_experts import (expert_counts, route,
                                           routed_experts)

# The paged server refuses a family that keeps a latent cache.
LATENT_CACHE = True


@dataclasses.dataclass(frozen=True)
class DeepseekV2Config:
    vocab: int = 102400
    d_model: int = 2048
    n_heads: int = 16
    n_layers: int = 27
    first_dense: int = 1         # first_k_dense_replace
    d_ff: int = 10944            # the dense layers' SwiGLU
    d_expert: int = 1408         # moe_intermediate_size
    n_experts: int = 64          # n_routed_experts
    n_shared: int = 2            # n_shared_experts
    top_k: int = 6               # num_experts_per_tok
    routed_scale: float = 1.0    # routed_scaling_factor
    kv_lora: int = 512           # kv_lora_rank
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128
    rms_eps: float = 1e-6
    max_seq: int = 163840
    rope_theta: float = 10000.0
    rope_factor: float = 40.0
    rope_original: int = 4096    # original_max_position_embeddings
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 0.707
    mscale_all_dim: float = 0.707
    dtype: Any = torch.bfloat16

    @property
    def q_head(self) -> int:
        return self.qk_nope + self.qk_rope

    @property
    def latent(self) -> int:
        """Width of a cached row: the latent c, then the rope key."""
        return self.kv_lora + self.qk_rope

    @property
    def n_moe(self) -> int:
        return self.n_layers - self.first_dense

    @property
    def scale(self) -> float:
        return softmax_scale(self.q_head, self.rope_factor,
                             self.mscale_all_dim)


def deepseek_v2_lite() -> DeepseekV2Config:
    """DeepSeek-V2-Lite as published (deepseek-ai/DeepSeek-V2-Lite,
    config.json): 27 layers, d 2048, 16 heads, 64 routed experts of 1408
    (top-6) and 2 shared, vocab 102400; 15.7 B parameters."""
    return DeepseekV2Config()


def tiny_deepseek_v2(vocab: int = 96, d_model: int = 64, n_heads: int = 4,
                     n_layers: int = 3, max_seq: int = 256
                     ) -> DeepseekV2Config:
    """Small config for tests: one dense layer, then MoE layers of 8
    experts (top 3) and 2 shared, YaRN over an original context of 64 so
    that its ramp lies inside the rope dims."""
    return DeepseekV2Config(
        vocab=vocab, d_model=d_model, n_heads=n_heads, n_layers=n_layers,
        d_ff=96, d_expert=32, n_experts=8, top_k=3, kv_lora=32, qk_nope=16,
        qk_rope=8, v_head=16, max_seq=max_seq, rope_original=64)


Params = Dict[str, Any]


def init_params(cfg: DeepseekV2Config, seed: int = 0, device=None,
                dtype=torch.float32) -> Params:
    """Parameters in ``dtype`` on ``device`` (``None`` means the GPU): the
    products N(0, 0.02), the output projections (``wo``, the FFNs'
    ``w_down``) scaled by 1/sqrt(2L), norms at 1. Each leaf is drawn on
    the device, one after the other, from a ``torch.Generator`` there
    seeded with ``seed``."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    L, Ld, Lm, d = cfg.n_layers, cfg.first_dense, cfg.n_moe, cfg.d_model
    H, E, I = cfg.n_heads, cfg.n_experts, cfg.d_expert
    s, so = 0.02, 0.02 / math.sqrt(2 * L)

    def nrm(*shape, scale=s):
        return torch.randn(shape, generator=g, device=dev,
                           dtype=dtype).mul_(scale)

    def ones(*shape):
        return torch.ones(shape, device=dev, dtype=dtype)

    shared = cfg.n_shared * I
    return {
        "embed": nrm(cfg.vocab, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": nrm(L, d, H * cfg.q_head),
            "w_kv_a": nrm(L, d, cfg.latent),
            "kv_norm": ones(L, cfg.kv_lora),
            "w_kv_b": nrm(L, cfg.kv_lora, H * (cfg.qk_nope + cfg.v_head)),
            "wo": nrm(L, H * cfg.v_head, d, scale=so),
            "mlp_norm": ones(L, d),
        },
        "dense": {
            "w_gate": nrm(Ld, d, cfg.d_ff),
            "w_up": nrm(Ld, d, cfg.d_ff),
            "w_down": nrm(Ld, cfg.d_ff, d, scale=so),
        },
        "moe": {
            "router": nrm(Lm, d, E),
            "w_gate": nrm(Lm, E, d, I),
            "w_up": nrm(Lm, E, d, I),
            "w_down": nrm(Lm, E, I, d, scale=so),
            "shared_gate": nrm(Lm, d, shared),
            "shared_up": nrm(Lm, d, shared),
            "shared_down": nrm(Lm, shared, d, scale=so),
        },
        "final_norm": ones(d),
        "unembed": nrm(cfg.vocab, d),
    }


def _layer(params: Params, cfg: DeepseekV2Config, i: int) -> Params:
    """Layer i's parameters: its attention, and under ``'ffn'`` its dense
    FFN or its MoE layer (``'moe'`` then holds its index among the MoE
    layers, ``None`` for a dense one)."""
    lp = {name: a[i] for name, a in params["layers"].items()}
    if i < cfg.first_dense:
        lp["ffn"] = {n: a[i] for n, a in params["dense"].items()}
        lp["moe"] = None
    else:
        j = i - cfg.first_dense
        lp["ffn"] = {n: a[j] for n, a in params["moe"].items()}
        lp["moe"] = j
    return lp


# -- YaRN rotary positions --------------------------------------------------

_FREQS: Dict[tuple, torch.Tensor] = {}


def yarn_inv_freq(dim: int, base: float, factor: float, original: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """YaRN's dim/2 frequencies in f32, as ``DeepseekV2YarnRotaryEmbedding``
    forms them: the extrapolated ``base ** -(2i/dim)`` and the interpolated
    ones divided by ``factor``, blended by a linear ramp between the
    correction dims of ``beta_fast`` and ``beta_slow`` rotations over the
    original context."""
    def corr(n_rot):
        return (dim * math.log(original / (n_rot * 2 * math.pi))
                / (2 * math.log(base)))
    low = max(math.floor(corr(beta_fast)), 0)
    high = min(math.ceil(corr(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    extra = 1.0 / pos
    inter = 1.0 / (factor * pos)
    return inter * (1 - mask) + extra * mask


def yarn_mscale(factor: float, mscale: float) -> float:
    """``yarn_get_mscale``: 0.1 * mscale * ln(factor) + 1 (1 at factor <=
    1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def _yarn_freqs(cfg: DeepseekV2Config, device) -> torch.Tensor:
    """:func:`yarn_inv_freq` of ``cfg``, made once per device and kept, so
    a step copies nothing from the host (a CUDA graph can capture it)."""
    key = (cfg.qk_rope, cfg.rope_theta, cfg.rope_factor, cfg.rope_original,
           cfg.beta_fast, cfg.beta_slow, torch.device(device))
    if key not in _FREQS:
        _FREQS[key] = yarn_inv_freq(
            cfg.qk_rope, cfg.rope_theta, cfg.rope_factor, cfg.rope_original,
            cfg.beta_fast, cfg.beta_slow).to(device)
    return _FREQS[key]


def rope(cfg: DeepseekV2Config, x, positions):
    """YaRN rotary embedding on x ``[..., S, H, qk_rope]`` at positions
    ``[S]`` (or ``[..., S]``), in f32, pairing dims (i, i + qk_rope/2);
    cos and sin times ``mscale / mscale_all_dim``'s attention factors (1
    where the two are equal)."""
    half = x.shape[-1] // 2
    ang = positions[..., None].float() * _yarn_freqs(cfg, x.device)
    m = (yarn_mscale(cfg.rope_factor, cfg.mscale)
         / yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim))
    cos = (torch.cos(ang) * m)[..., None, :]
    sin = (torch.sin(ang) * m)[..., None, :]
    x1, x2 = x.float().split(half, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


# -- blocks -----------------------------------------------------------------


def _q_and_row(cfg: DeepseekV2Config, lp: Params, x, positions):
    """The query ``[B, S, H, 192]`` (rope dims rotated) and the cached row
    ``[B, S, 576]`` (``c`` normed, then ``k_pe`` rotated)."""
    B, S, _ = x.shape
    h = rmsnorm(x, lp["attn_norm"], cfg.rms_eps)
    q = (h @ lp["wq"].to(x.dtype)).reshape(B, S, cfg.n_heads, cfg.q_head)
    q = torch.cat([q[..., :cfg.qk_nope],
                   rope(cfg, q[..., cfg.qk_nope:], positions)], dim=-1)
    kv_a = h @ lp["w_kv_a"].to(x.dtype)
    c = rmsnorm(kv_a[..., :cfg.kv_lora], lp["kv_norm"], cfg.rms_eps)
    k_pe = rope(cfg, kv_a[..., None, cfg.kv_lora:], positions)[..., 0, :]
    return q, torch.cat([c, k_pe], dim=-1)


def _prefill_kv(cfg: DeepseekV2Config, lp: Params, row):
    """The non-absorbed form's per-head K ``[k_nope, k_pe]`` (192) and V
    (128) from the rows ``[B, S, 576]``."""
    B, S = row.shape[:2]
    H = cfg.n_heads
    kv = (row[..., :cfg.kv_lora] @ lp["w_kv_b"].to(row.dtype)).reshape(
        B, S, H, cfg.qk_nope + cfg.v_head)
    k_pe = row[..., None, cfg.kv_lora:].expand(B, S, H, cfg.qk_rope)
    return (torch.cat([kv[..., :cfg.qk_nope], k_pe], dim=-1),
            kv[..., cfg.qk_nope:])


def _attend_prefill(cfg: DeepseekV2Config, lp: Params, q, row):
    """The non-absorbed form (:func:`_prefill_kv`), causal attention
    through ``select_attention`` (looked up at the call) -> ``[B, S, H *
    v_head]``."""
    B, S = q.shape[:2]
    with profiling.annotate("acx.model.mla"):
        k, v = _prefill_kv(cfg, lp, row)
        o = select_attention(None)(q, k, v, cfg.scale)
    return o.reshape(B, S, cfg.n_heads * cfg.v_head)


def _absorbed(cfg: DeepseekV2Config, lp: Params):
    """Per-head views of ``W_kv_b``: ``W_UK^T`` ``[H, qk_nope, kv_lora]``
    and ``W_UV`` ``[H, kv_lora, v_head]`` (strided, no copy)."""
    w = lp["w_kv_b"].reshape(cfg.kv_lora, cfg.n_heads,
                             cfg.qk_nope + cfg.v_head)
    return (w[..., :cfg.qk_nope].permute(1, 2, 0),
            w[..., cfg.qk_nope:].permute(1, 0, 2))


def _absorb_query(cfg: DeepseekV2Config, lp: Params, q):
    """q ``[B, W, H, 192]`` -> the latent query ``[B, W, H, 576]``:
    ``q_nope W_UK^T`` (512) then ``q_pe`` (64)."""
    B, W, H, _ = q.shape
    w_uk_t = _absorbed(cfg, lp)[0].to(q.dtype)
    qn = q[..., :cfg.qk_nope].reshape(B * W, H, cfg.qk_nope).transpose(0, 1)
    q_lat = torch.matmul(qn, w_uk_t).transpose(0, 1).reshape(
        B, W, H, cfg.kv_lora)
    return torch.cat([q_lat, q[..., cfg.qk_nope:]], dim=-1)


def _unabsorb(cfg: DeepseekV2Config, lp: Params, o_lat):
    """o_lat ``[B, W, H, 512]`` -> ``[B, W, H * v_head]`` through W_UV."""
    B, W, H, _ = o_lat.shape
    w_uv = _absorbed(cfg, lp)[1].to(o_lat.dtype)
    o = torch.matmul(o_lat.reshape(B * W, H, cfg.kv_lora).transpose(0, 1),
                     w_uv)
    return o.transpose(0, 1).reshape(B, W, H * cfg.v_head)


def _swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate.to(h.dtype)) * (h @ w_up.to(h.dtype))) @ \
        w_down.to(h.dtype)


def moe(cfg: DeepseekV2Config, mp: Params, h, counts=None):
    """DeepSeekMoE on h ``[B, S, d]`` (normed) -> ``[B, S, d]`` f32: the
    routed experts, no pair dropped (``ops/moe_experts.py``), plus the
    shared experts. ``counts`` (a ``[2]`` int64 row of the cache's
    ``'counts'``), when given, gains the experts that received a pair and
    the pairs routed."""
    B, S, d = h.shape
    hf = h.reshape(B * S, d)
    with profiling.annotate("acx.moe.route"):
        ids, w = route(hf, mp["router"], cfg.top_k, cfg.routed_scale)
        n = expert_counts(ids, cfg.n_experts)
        if counts is not None:
            counts += torch.stack([(n > 0).sum(), n.sum()])
    with profiling.annotate("acx.moe.experts"):
        y = routed_experts(hf, ids, w, n, mp["w_gate"], mp["w_up"],
                           mp["w_down"])
    with profiling.annotate("acx.moe.shared"):
        ys = _swiglu(hf, mp["shared_gate"], mp["shared_up"],
                     mp["shared_down"])
    return (y + ys.float()).reshape(B, S, d)


def _ffn(cfg: DeepseekV2Config, lp: Params, x, counts=None):
    """x + the layer's FFN on rmsnorm(x): the dense SwiGLU or :func:`moe`
    (``counts``: the cache's ``'counts'``, whose row the layer updates)."""
    h = rmsnorm(x, lp["mlp_norm"], cfg.rms_eps)
    f = lp["ffn"]
    if lp["moe"] is None:
        return x + _swiglu(h, f["w_gate"], f["w_up"], f["w_down"])
    row = None if counts is None else counts[lp["moe"]]
    return (x.float() + moe(cfg, f, h, row)).to(x.dtype)


def _check_len(S, cfg: DeepseekV2Config, max_len=None):
    if S > cfg.max_seq or (max_len is not None and S > max_len):
        raise ValueError(f"sequence length {S} exceeds max_seq "
                         f"{cfg.max_seq}" + ("" if max_len is None else
                                             f" or max_len {max_len}"))


def _trunk(params: Params, cfg: DeepseekV2Config, tokens):
    """tokens ``[B, S]`` -> final-normed hidden states ``[B, S, d]`` in
    ``cfg.dtype``."""
    S = tokens.shape[1]
    x = params["embed"][tokens].to(cfg.dtype)
    positions = torch.arange(S, device=x.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, cfg, i)
        q, row = _q_and_row(cfg, lp, x, positions)
        x = x + _attend_prefill(cfg, lp, q, row) @ lp["wo"].to(x.dtype)
        x = _ffn(cfg, lp, x)
    return rmsnorm(x, params["final_norm"], cfg.rms_eps)


def forward(params: Params, cfg: DeepseekV2Config, tokens):
    """tokens ``[B, S]`` -> logits ``[B, S, vocab]`` (f32)."""
    _check_len(tokens.shape[1], cfg)
    return _unembed(_trunk(params, cfg, tokens), params["unembed"])


# -- the latent cache and decoding ------------------------------------------


def init_kv_cache(cfg: DeepseekV2Config, batch: int, max_len: int,
                  kv_int8: bool = False, device=None):
    """Zeroed latent cache: ``{'k': [L, B, max_len, 1, 576]`` in
    ``cfg.dtype``, ``'pos'``: int32 scalar, ``'counts'``: ``[MoE layers,
    2]`` int64} on ``device`` (``None`` means the GPU). ``kv_int8`` is
    refused: the family keeps a bf16 cache only."""
    if kv_int8:
        raise ValueError("deepseek_v2: kv_int8 is not supported (the latent "
                         "cache is bf16 only)")
    dev = resolve_device(device)
    return {
        "k": torch.zeros((cfg.n_layers, batch, max_len, 1, cfg.latent),
                         dtype=cfg.dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "counts": torch.zeros((cfg.n_moe, 2), dtype=torch.int64,
                              device=dev),
    }


def prefill(params: Params, cfg: DeepseekV2Config, tokens, max_len: int,
            last_only: bool = False, kv_int8: bool = False,
            last_index: Optional[int] = None, seat=None):
    """Prompt pass filling a fresh latent cache (:func:`init_kv_cache`):
    tokens ``[B, S]`` -> (logits ``[B, S, vocab]`` f32, cache with pos =
    S). ``last_only`` unembeds the final position alone, ``last_index``
    that position instead (bucket-padded serving prompts). ``seat`` lands
    the rows in a slot of the serve loop's cache, the pass replayed from
    CUDA graphs between its attention calls on the GPU
    (``decoding.run_prefill``)."""
    with profiling.annotate("acx.model.prefill"):
        B, S = tokens.shape
        _check_len(S, cfg, max_len)
        return run_prefill(
            params, tokens, _prefill_parts(params, cfg), cfg,
            lambda: init_kv_cache(cfg, B, max_len, kv_int8,
                                  device=tokens.device),
            last_only, last_index, seat)


def _prefill_parts(params: Params, cfg: DeepseekV2Config) -> PrefillParts:
    """The prompt pass's pieces (``decoding.PrefillParts``): the
    non-absorbed form's operands and one latent row a token to cache."""
    def embed(tokens):
        return params["embed"][tokens].to(cfg.dtype)

    def qkv(lp, x):
        positions = torch.arange(x.shape[1], device=x.device)
        q, row = _q_and_row(cfg, lp, x, positions)
        with profiling.annotate("acx.model.mla"):
            k, v = _prefill_kv(cfg, lp, row)
        return (q, k, v), (row[:, :, None, :], None)

    def attend(q, k, v, out=None):
        return select_attention(None)(q, k, v, cfg.scale, out=out)

    def post(lp, x, o):
        B, S = x.shape[:2]
        o = o.reshape(B, S, cfg.n_heads * cfg.v_head)
        return _ffn(cfg, lp, x + o @ lp["wo"].to(x.dtype))

    def head(x, last):
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        return _unembed(last_rows(x, last), params["unembed"])

    def layers():
        return [_layer(params, cfg, i) for i in range(cfg.n_layers)]

    return PrefillParts(embed, qkv, attend, post, head, layers)


def grouped_decode_attend(q, kc, pos, scale: float, kv_lora: int,
                          out=None):
    """The absorbed decode attention: every query head one group over the
    shared latent row (``ops/mla.py``), the kernel on a CUDA tensor, its
    plain version on a CPU one."""
    return mla_decode_attend(q, kc, pos, scale, kv_lora, out=out)


def _step_parts(params: Params, cfg: DeepseekV2Config, cache) -> StepParts:
    """The decode step's pieces (``decoding.StepParts``), over the latent
    cache: ``qkv`` gives the latent query and the row to cache, ``attend``
    the absorbed attention, ``post`` W_UV, W_o and the FFN (which counts
    into ``cache['counts']``)."""
    counts = cache["counts"]

    def embed(token, pos):
        return params["embed"][token][:, None, :].to(cfg.dtype)

    def qkv(lp, x, pos):
        positions = pos[:, None] if pos.ndim else pos.reshape(1)
        q, row = _q_and_row(cfg, lp, x, positions)
        return _absorb_query(cfg, lp, q), row[:, :, None, :], None

    def attend(q, kc, vc, pos, out=None):
        return grouped_decode_attend(q, kc, pos, cfg.scale, cfg.kv_lora,
                                     out=out)

    def post(lp, x, o):
        x = x + _unabsorb(cfg, lp, o) @ lp["wo"].to(x.dtype)
        return _ffn(cfg, lp, x, counts)

    def head(x):
        x = rmsnorm(x, params["final_norm"], cfg.rms_eps)
        return _unembed(x, params["unembed"])[:, 0]

    def layers():
        return [_layer(params, cfg, i) for i in range(cfg.n_layers)]

    return StepParts(embed, qkv, attend, post, head, layers)


def decode_step(params: Params, cfg: DeepseekV2Config, cache, token):
    """One autoregressive step: token ``[B]`` -> (logits ``[B, vocab]``
    f32, cache with pos + 1), the new rows written in place. ``pos`` is a
    scalar or ``[B]`` (continuous batching). A slot cache the serve loop
    seated replays the step from CUDA graphs between its attention calls
    (``decoding.DecodeGraphs``)."""
    with profiling.annotate("acx.model.decode"):
        return run_decode_step(params, cache, token,
                               _step_parts(params, cfg, cache), cfg)


def generate(params: Params, cfg: DeepseekV2Config, prompt, n_new: int,
             max_len: Optional[int] = None, kv_int8: bool = False,
             device=None):
    """Greedy decode: prompt ``[B, S]`` -> ``[B, S + n_new]`` on ``device``
    (``None`` means the GPU; the parameters must already be there)."""
    dev = resolve_device(device)
    check_device(params, dev)
    prompt = torch.as_tensor(prompt, device=dev)
    return greedy_generate(
        lambda t, ml, lo: prefill(params, cfg, t, ml, last_only=lo,
                                  kv_int8=kv_int8),
        lambda c, t: decode_step(params, cfg, c, t),
        prompt, n_new, cfg.max_seq, max_len)
