"""The Llama architecture in plain float32 PyTorch, from the published
descriptions (Touvron et al. 2023; Jiang et al. 2023 for Mistral 7B; HF
``MistralForCausalLM``): pre-RMSNorm blocks of causal grouped-query
attention with rotary positions (theta from the config, the halves
convention: dims i and i + D/2 rotate together at frequency theta^(-2i/D))
and a SwiGLU MLP, a final RMSNorm and an untied head.

Weights come in the port's layout (stacked layers, products ``[in,
out]``, head ``[vocab, d]``). The rotary angles are formed in float64.
"""

from __future__ import annotations

import torch

from acxbench.reference.common import causal_attention


def _rmsnorm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g.float()


def _rope(x, theta):
    """x [B, S, H, D] rotated at positions 0..S-1."""
    S, D = x.shape[1], x.shape[-1]
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) * 2.0 / D)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(cfg, lp, x, mm):
    B, S, d = x.shape
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh = d // hq
    theta, eps = float(cfg["rope_theta"]), cfg["rms_norm_eps"]
    h = _rmsnorm(x, lp["attn_norm"], eps)
    q = _rope(mm(h, lp["wq"]).reshape(B, S, hq, dh), theta)
    k = _rope(mm(h, lp["wk"]).reshape(B, S, hkv, dh), theta)
    v = mm(h, lp["wv"]).reshape(B, S, hkv, dh)
    # Query head j reads KV group j // (hq / hkv).
    k = k.repeat_interleave(hq // hkv, dim=2)
    v = v.repeat_interleave(hq // hkv, dim=2)
    x = x + mm(causal_attention(q, k, v).reshape(B, S, d), lp["wo"])
    h = _rmsnorm(x, lp["mlp_norm"], eps)
    gate = mm(h, lp["w_gate"])
    y = gate * torch.sigmoid(gate) * mm(h, lp["w_up"])
    return x + mm(y, lp["w_down"])


def hidden(params, cfg, tokens, mm):
    """tokens [B, S] -> final-normed hidden states [B, S, d], float32,
    computed one layer at a time."""
    x = params["embed"][tokens].float()
    layers = params["layers"]
    for i in range(cfg["num_hidden_layers"]):
        x = _layer(cfg, {n: a[i] for n, a in layers.items()}, x, mm)
    return _rmsnorm(x, params["final_norm"], cfg["rms_norm_eps"])


def head(params):
    """The untied head's [vocab, d] matrix."""
    return params["unembed"]


def logits_at(params, cfg, tokens, positions, mm):
    """Logits [len(positions), vocab] of one sequence (tokens [S]) at the
    given positions."""
    x = hidden(params, cfg, tokens[None], mm)[0, positions]
    return mm(x, head(params).T)
