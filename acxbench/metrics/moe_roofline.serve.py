"""The routed-expert kernels against their roofline: the least time of
the expert work of the traced decode steps, counting only the experts
their routing touched (the program's device-side counters in the slot
cache, read back as each served batch's ``round_counters``), plus the
steps' input and output rows (``deepseek_cost.moe_cost``), over the
device time of the kernels named ``moe_experts`` inside the benchmark's
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
    n = art.trace.count("decode_step")
    dev_ms = dc.named_device_ms(art.trace, "decode_step", dc.MOE_EXPERTS)
    cfg = dc.config_of(art, CONFIGS)
    counted = dc.traced_rounds(art)
    if not n or dev_ms <= 0 or cfg is None or counted is None:
        return None
    touched, pairs, steps = counted
    if not steps:
        return None
    moe_layers = cfg["num_hidden_layers"] - cfg["first_k_dense_replace"]
    tokens = moe_layers * sum(B for _, B in art.k2_steps[:steps])
    least = bound_ms(*dc.moe_cost(touched, pairs, tokens,
                                  cfg["hidden_size"],
                                  cfg["moe_intermediate_size"]))[0]
    # The device time of every traced step, the bytes of the whole
    # rounds among them: a round the trace cut short only lowers the share.
    return 100.0 * least / dev_ms
