"""DeepSeek-V2 in plain float32 PyTorch, from the published description
(Liu et al. 2024, arXiv:2405.04434: section 2.1 multi-head latent
attention without query compression, section 2.2 DeepSeekMoE) and the
model's ``modeling_deepseek.py``: pre-RMSNorm blocks of MLA in its
non-absorbed form (per-head keys ``[c W_UK, k_pe]`` of 192 and values ``c
W_UV`` of 128, ``c`` the normed latent, ``k_pe`` one rotated key every
head shares), YaRN rotary positions on the rope dims
(``DeepseekV2YarnRotaryEmbedding``) and the softmax scale ``q_head **
-0.5 * m ** 2``; then a dense SwiGLU in the first
``first_k_dense_replace`` layers and DeepSeekMoE after them: the router's
softmax over the routed experts, greedy top-k, not renormalised, times
``routed_scaling_factor``, every token's k experts gathered with no
capacity, plus the shared experts as one SwiGLU; a final RMSNorm and an
untied head.

Departures from the published code, as the program has them: the rope
dims pair (i, i + D/2) (the published code interleaves pairs, the same map
under a fixed permutation of the rope columns of ``W_q`` and
``W_kv_a``); the router's product runs in the reference's precision,
like every product, and its ties go to the lower expert.

Weights come in the port's layout (attention stacked ``[L, ...]`` under
``layers``, the dense FFN layers under ``dense``, the MoE layers under
``moe``; products ``[in, out]``; head ``[vocab, d]``). Attention runs a
block of query rows at a time and the experts one at a time, so a
2048-token request fits beside the bf16 weights.
"""

from __future__ import annotations

import math

import torch

from acxbench.reference.common import causal_attention
from acxbench.reference.llama import _rmsnorm


def _mscale(factor, m):
    return 1.0 if factor <= 1 else 0.1 * m * math.log(factor) + 1.0


def inv_freq(cfg):
    """YaRN's frequencies of the rope dims, as ``modeling_deepseek.py``
    forms them (float32)."""
    rs = cfg["rope_scaling"]
    dim, base = cfg["qk_rope_head_dim"], float(cfg["rope_theta"])
    orig, factor = rs["original_max_position_embeddings"], rs["factor"]

    def corr(n_rot):
        return dim * math.log(orig / (n_rot * 2 * math.pi)) / (
            2 * math.log(base))
    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(dim // 2, dtype=torch.float32) - low)
            / (high - low)).clamp(0, 1)
    keep = 1.0 - ramp
    pos = base ** (torch.arange(0, dim, 2, dtype=torch.float32) / dim)
    return (1.0 / (factor * pos)) * (1 - keep) + (1.0 / pos) * keep


def softmax_scale(cfg):
    rs = cfg["rope_scaling"]
    q_head = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    m = _mscale(rs["factor"], rs["mscale_all_dim"])
    return q_head ** -0.5 * m * m


def _rope(cfg, x):
    """x [S, H, D] rotated at positions 0..S-1 (halves pairing)."""
    S, D = x.shape[0], x.shape[-1]
    rs = cfg["rope_scaling"]
    ang = (torch.arange(S, dtype=torch.float32, device=x.device)[:, None]
           * inv_freq(cfg).to(x.device))
    m = (_mscale(rs["factor"], rs["mscale"])
         / _mscale(rs["factor"], rs["mscale_all_dim"]))
    cos = (torch.cos(ang) * m)[:, None, :]
    sin = (torch.sin(ang) * m)[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _swiglu(h, wg, wu, wd, mm):
    gate = mm(h, wg)
    return mm(gate * torch.sigmoid(gate) * mm(h, wu), wd)


def _moe(cfg, mp, h, mm):
    """The routed experts (every token's k, no capacity) plus the shared
    ones, h [S, d]."""
    E, k = cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    probs = torch.softmax(mm(h, mp["router"]), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    ids, wts = ids[:, :k], vals[:, :k] * cfg["routed_scaling_factor"]
    y = torch.zeros_like(h)
    for e in range(E):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if len(tok):
            out = _swiglu(h[tok], mp["w_gate"][e], mp["w_up"][e],
                          mp["w_down"][e], mm)
            y.index_add_(0, tok, out * wts[tok, slot][:, None])
    return y + _swiglu(h, mp["shared_gate"], mp["shared_up"],
                       mp["shared_down"], mm)


def _layer(cfg, lp, ffn, is_moe, x, mm):
    S, d = x.shape
    H = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    eps = cfg["rms_norm_eps"]
    h = _rmsnorm(x, lp["attn_norm"], eps)
    q = mm(h, lp["wq"]).reshape(S, H, dn + dr)
    q = torch.cat([q[..., :dn], _rope(cfg, q[..., dn:])], dim=-1)
    kv_a = mm(h, lp["w_kv_a"])
    c = _rmsnorm(kv_a[:, :r], lp["kv_norm"], eps)
    k_pe = _rope(cfg, kv_a[:, None, r:])                       # [S, 1, dr]
    kv = mm(c, lp["w_kv_b"]).reshape(S, H, dn + dv)
    k = torch.cat([kv[..., :dn], k_pe.expand(S, H, dr)], dim=-1)
    # causal_attention scales by (dn + dr) ** -0.5; the rest of the scale,
    # YaRN's m ** 2, goes on q.
    m2 = softmax_scale(cfg) * math.sqrt(dn + dr)
    o = causal_attention((q * m2)[None], k[None], kv[None, ..., dn:])[0]
    x = x + mm(o.reshape(S, H * dv), lp["wo"])
    h = _rmsnorm(x, lp["mlp_norm"], eps)
    if is_moe:
        return x + _moe(cfg, ffn, h, mm)
    return x + _swiglu(h, ffn["w_gate"], ffn["w_up"], ffn["w_down"], mm)


def hidden(params, cfg, tokens, mm):
    """tokens [S] -> final-normed hidden states [S, d], float32, one layer
    at a time."""
    x = params["embed"][tokens].float()
    n_dense = cfg["first_k_dense_replace"]
    for i in range(cfg["num_hidden_layers"]):
        lp = {n: a[i] for n, a in params["layers"].items()}
        is_moe = i >= n_dense
        grp, j = (params["moe"], i - n_dense) if is_moe else (
            params["dense"], i)
        x = _layer(cfg, lp, {n: a[j] for n, a in grp.items()}, is_moe, x,
                   mm)
    return _rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"])


def logits_at(params, cfg, tokens, positions, mm):
    """Logits [len(positions), vocab] of one sequence (tokens [S]) at the
    given positions."""
    x = hidden(params, cfg, tokens, mm)[positions]
    return mm(x, params["unembed"].T)
