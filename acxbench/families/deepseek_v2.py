"""DeepSeek-V2 (HF ``DeepseekV2ForCausalLM`` key names: multi-head latent
attention with YaRN rotary positions, a dense SwiGLU then DeepSeekMoE,
untied head) through the port's ``models/deepseek_v2.py``."""

from __future__ import annotations

import math

import torch

from acxbench.reference import deepseek_v2 as reference  # noqa: F401


def port_module():
    from mpi_acx_torch.models import deepseek_v2
    return deepseek_v2


def port_config(cfg: dict, dtype):
    """The port's DeepseekV2Config for ``cfg``, computing in ``dtype``.
    Refuses what the port's family cannot express."""
    from mpi_acx_torch.models.deepseek_v2 import DeepseekV2Config
    rs = cfg["rope_scaling"]
    if (cfg["hidden_act"] != "silu" or cfg["tie_word_embeddings"]
            or cfg.get("q_lora_rank") is not None
            or cfg["scoring_func"] != "softmax"
            or cfg["topk_method"] != "greedy" or cfg["norm_topk_prob"]
            or cfg["moe_layer_freq"] != 1 or cfg["attention_bias"]
            or rs["type"] != "yarn"):
        raise ValueError("the port's DeepSeek-V2 family has SiLU, an untied "
                         "head, no query compression, a softmax router "
                         "with greedy top-k and no renormalisation, MoE in "
                         "every layer after the dense ones, no attention "
                         "bias and YaRN")
    return DeepseekV2Config(
        vocab=cfg["vocab_size"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_layers=cfg["num_hidden_layers"],
        first_dense=cfg["first_k_dense_replace"],
        d_ff=cfg["intermediate_size"],
        d_expert=cfg["moe_intermediate_size"],
        n_experts=cfg["n_routed_experts"], n_shared=cfg["n_shared_experts"],
        top_k=cfg["num_experts_per_tok"],
        routed_scale=float(cfg["routed_scaling_factor"]),
        kv_lora=cfg["kv_lora_rank"], qk_nope=cfg["qk_nope_head_dim"],
        qk_rope=cfg["qk_rope_head_dim"], v_head=cfg["v_head_dim"],
        rms_eps=cfg["rms_norm_eps"],
        max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), rope_factor=float(rs["factor"]),
        rope_original=rs["original_max_position_embeddings"],
        beta_fast=float(rs["beta_fast"]), beta_slow=float(rs["beta_slow"]),
        mscale=float(rs["mscale"]), mscale_all_dim=float(rs["mscale_all_dim"]),
        dtype=dtype)


def draw_params(cfg: dict, seed: int, device, dtype) -> dict:
    """Weights in the port's layout (attention stacked over every layer,
    the dense and the MoE FFNs each over their own layers, products ``[in,
    out]``, head ``[vocab, d]``), drawn on ``device`` in ``dtype`` from a
    generator seeded with ``seed``, one call a leaf."""
    g = torch.Generator(device=device).manual_seed(seed)
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    Ld = cfg["first_k_dense_replace"]
    Lm = L - Ld
    H, E = cfg["num_attention_heads"], cfg["n_routed_experts"]
    I, ff = cfg["moe_intermediate_size"], cfg["intermediate_size"]
    r, rope = cfg["kv_lora_rank"], cfg["qk_rope_head_dim"]
    q_head = cfg["qk_nope_head_dim"] + rope
    kv_b = H * (cfg["qk_nope_head_dim"] + cfg["v_head_dim"])
    shared = cfg["n_shared_experts"] * I
    std, qk = cfg["init"]["std"], cfg["init"]["qk_std"]
    out = cfg["init"].get("out_std", std / math.sqrt(2 * L))

    def nrm(*shape, scale=std, mean=0.0):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(scale).add_(mean)

    return {
        "embed": nrm(cfg["vocab_size"], d),
        "layers": {
            "attn_norm": nrm(L, d, scale=0.1, mean=1.0),
            "wq": nrm(L, d, H * q_head, scale=qk),
            "w_kv_a": nrm(L, d, r + rope, scale=qk),
            "kv_norm": nrm(L, r, scale=0.1, mean=1.0),
            "w_kv_b": nrm(L, r, kv_b),
            "wo": nrm(L, H * cfg["v_head_dim"], d, scale=out),
            "mlp_norm": nrm(L, d, scale=0.1, mean=1.0),
        },
        "dense": {
            "w_gate": nrm(Ld, d, ff),
            "w_up": nrm(Ld, d, ff),
            "w_down": nrm(Ld, ff, d, scale=out),
        },
        "moe": {
            "router": nrm(Lm, d, E),
            "w_gate": nrm(Lm, E, d, I),
            "w_up": nrm(Lm, E, d, I),
            "w_down": nrm(Lm, E, I, d, scale=out),
            "shared_gate": nrm(Lm, d, shared),
            "shared_up": nrm(Lm, d, shared),
            "shared_down": nrm(Lm, shared, d, scale=out),
        },
        "final_norm": nrm(d, scale=0.1, mean=1.0),
        "unembed": nrm(cfg["vocab_size"], d),
    }
