"""GPT-2 (HF ``GPT2LMHeadModel`` key names) through the port's
``models/transformer.py``.

The port's GPT-2 has no bias on the fused q/k/v product or on the
attention's output projection, where the published model has both
(``c_attn.bias``, ``attn.c_proj.bias``); the benchmark draws none, so the
reference computes the same function with them at zero.
"""

from __future__ import annotations

import math

import torch

from acxbench.reference import gpt2 as reference  # noqa: F401


def port_module():
    from mpi_acx_torch.models import transformer
    return transformer


def port_config(cfg: dict, dtype):
    """The port's TransformerConfig for ``cfg``, computing in ``dtype``.
    Refuses what the port's family cannot express."""
    from mpi_acx_torch.models.transformer import TransformerConfig
    if (cfg["layer_norm_epsilon"] != 1e-5
            or cfg["activation_function"] != "gelu_new"
            or not cfg["tie_word_embeddings"]):
        raise ValueError("the port's GPT-2 has eps 1e-5, tanh GELU and a "
                         "tied head")
    d = cfg["n_embd"]
    return TransformerConfig(
        vocab=cfg["vocab_size"], d_model=d, n_heads=cfg["n_head"],
        n_layers=cfg["n_layer"], d_ff=cfg["n_inner"] or 4 * d,
        max_seq=cfg["n_positions"], dtype=dtype)


def draw_params(cfg: dict, seed: int, device, dtype) -> dict:
    """Weights in the port's layout (stacked layers, products ``[in,
    out]``), drawn on ``device`` in ``dtype`` from a generator seeded with
    ``seed``, one call a leaf."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d = cfg["n_layer"], cfg["n_embd"]
    ff, V, P = cfg["n_inner"] or 4 * d, cfg["vocab_size"], cfg["n_positions"]

    std, qk = cfg["init"]["std"], cfg["init"]["qk_std"]

    def nrm(*shape, scale=std, mean=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(scale).add_(mean)

    out = cfg["init"].get("out_std", std / math.sqrt(2 * L))
    return {
        "embed": nrm(V, d),
        "pos": nrm(P, d),
        "layers": {
            "ln1_g": nrm(L, d, scale=0.1, mean=1.0),
            "ln1_b": nrm(L, d),
            "wqkv": torch.cat([nrm(L, d, 2 * d, scale=qk), nrm(L, d, d)],
                              dim=-1),
            "wo": nrm(L, d, d, scale=out),
            "ln2_g": nrm(L, d, scale=0.1, mean=1.0),
            "ln2_b": nrm(L, d),
            "w1": nrm(L, d, ff),
            "b1": nrm(L, ff),
            "w2": nrm(L, ff, d, scale=out),
            "b2": nrm(L, d),
        },
        "lnf_g": nrm(d, scale=0.1, mean=1.0),
        "lnf_b": nrm(d),
    }
