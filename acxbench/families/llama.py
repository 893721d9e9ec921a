"""The Llama architecture (HF ``MistralForCausalLM``/``LlamaForCausalLM``
key names: RMSNorm, RoPE, grouped-query attention, SwiGLU, untied head)
through the port's ``models/llama.py``. Mistral-7B-v0.3 has no sliding
window, so it is this architecture at its own sizes."""

from __future__ import annotations

import math

import torch

from acxbench.reference import llama as reference  # noqa: F401


def port_module():
    from mpi_acx_torch.models import llama
    return llama


def port_config(cfg: dict, dtype):
    """The port's LlamaConfig for ``cfg``, computing in ``dtype``. Refuses
    what the port's family cannot express."""
    from mpi_acx_torch.models.llama import LlamaConfig
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    if (cfg["rms_norm_eps"] != 1e-5 or cfg["hidden_act"] != "silu"
            or cfg["tie_word_embeddings"] or cfg.get("sliding_window")
            or (cfg.get("head_dim") or d // h) != d // h):
        raise ValueError("the port's Llama family has eps 1e-5, SiLU, an "
                         "untied head, no window and head_dim = d / heads")
    return LlamaConfig(
        vocab=cfg["vocab_size"], d_model=d, n_heads=h,
        n_kv_heads=cfg["num_key_value_heads"],
        n_layers=cfg["num_hidden_layers"], d_ff=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), dtype=dtype)


def draw_params(cfg: dict, seed: int, device, dtype) -> dict:
    """Weights in the port's layout (stacked layers, products ``[in,
    out]``, head ``[vocab, d]``), drawn on ``device`` in ``dtype`` from a
    generator seeded with ``seed``, one call a leaf."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d, ff = (cfg["num_hidden_layers"], cfg["hidden_size"],
                cfg["intermediate_size"])
    hq, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    dh, V = d // hq, cfg["vocab_size"]

    std, qk = cfg["init"]["std"], cfg["init"]["qk_std"]

    def nrm(*shape, scale=std, mean=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(scale).add_(mean)

    out = cfg["init"].get("out_std", std / math.sqrt(2 * L))
    return {
        "embed": nrm(V, d),
        "layers": {
            "attn_norm": nrm(L, d, scale=0.1, mean=1.0),
            "wq": nrm(L, d, hq * dh, scale=qk),
            "wk": nrm(L, d, hkv * dh, scale=qk),
            "wv": nrm(L, d, hkv * dh),
            "wo": nrm(L, hq * dh, d, scale=out),
            "mlp_norm": nrm(L, d, scale=0.1, mean=1.0),
            "w_gate": nrm(L, d, ff),
            "w_up": nrm(L, d, ff),
            "w_down": nrm(L, ff, d, scale=out),
        },
        "final_norm": nrm(d, scale=0.1, mean=1.0),
        "unembed": nrm(V, d),
    }
