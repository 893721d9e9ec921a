"""GPT-2 in plain float32 PyTorch, from the published description
(Radford et al. 2019; HF ``GPT2LMHeadModel``): learned positions,
pre-LayerNorm blocks of causal multi-head attention and a tanh-GELU MLP,
a final LayerNorm and the head tied to the token embedding.

Weights come in the port's layout (stacked layers, products ``[in,
out]``); see ``acxbench/families/gpt2.py`` for the two attention biases
the port leaves out. ``mm`` is the product of the chosen precision
(``reference/common.py``); everything else is float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from acxbench.reference.common import causal_attention


def _gelu_new(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x.pow(3))))


def _layer(cfg, lp, x, mm):
    B, S, d = x.shape
    H = cfg["n_head"]
    eps = cfg["layer_norm_epsilon"]
    h = F.layer_norm(x, (d,), lp["ln1_g"].float(), lp["ln1_b"].float(), eps)
    q, k, v = mm(h, lp["wqkv"]).split(d, dim=-1)
    q, k, v = (t.reshape(B, S, H, d // H) for t in (q, k, v))
    x = x + mm(causal_attention(q, k, v).reshape(B, S, d), lp["wo"])
    h = F.layer_norm(x, (d,), lp["ln2_g"].float(), lp["ln2_b"].float(), eps)
    y = _gelu_new(mm(h, lp["w1"]) + lp["b1"].float())
    return x + mm(y, lp["w2"]) + lp["b2"].float()


def hidden(params, cfg, tokens, mm):
    """tokens [B, S] -> final-normed hidden states [B, S, d], float32,
    computed one layer at a time."""
    S = tokens.shape[1]
    x = params["embed"][tokens].float() + params["pos"][:S].float()
    layers = params["layers"]
    for i in range(cfg["n_layer"]):
        x = _layer(cfg, {n: a[i] for n, a in layers.items()}, x, mm)
    d = cfg["n_embd"]
    return F.layer_norm(x, (d,), params["lnf_g"].float(),
                        params["lnf_b"].float(), cfg["layer_norm_epsilon"])


def head(params):
    """The tied head's [vocab, d] matrix."""
    return params["embed"]


def logits_at(params, cfg, tokens, positions, mm):
    """Logits [len(positions), vocab] of one sequence (tokens [S]) at the
    given positions."""
    x = hidden(params, cfg, tokens[None], mm)[0, positions]
    return mm(x, head(params).T)
