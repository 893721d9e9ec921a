"""The absorbed MLA decode kernels against their roofline: the least time
of every layer's decode attention in the traced steps (the bytes of the
live latent rows at each step's positions, read once for all heads, plus
the queries and outputs: ``deepseek_cost.mla_decode_cost``) over the
device time of the kernels named ``mla_decode`` inside the benchmark's
``decode_step`` span."""

from pathlib import Path

from acxbench import deepseek_cost as dc
from acxbench.roofline import bound_ms

UNIT, MOVES, SOURCE = "%", "serve_tokens_per_s", "device_trace"
LAYER = "kernels: MLA (ops/mla.py), routed experts (ops/moe_experts.py)"
CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def read(art):
    if art.kind != "serve" or art.trace is None or not art.k2_steps:
        return None
    dev_ms = dc.named_device_ms(art.trace, "decode_step", dc.MLA_DECODE)
    cfg = dc.config_of(art, CONFIGS)
    if dev_ms <= 0 or cfg is None:
        return None
    least = cfg["num_hidden_layers"] * sum(
        bound_ms(*dc.mla_decode_cost(
            live, B, cfg["num_attention_heads"], cfg["kv_lora_rank"],
            cfg["qk_rope_head_dim"]))[0]
        for live, B in art.k2_steps)
    return 100.0 * least / dev_ms
