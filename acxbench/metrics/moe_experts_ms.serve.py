"""Device time of the routed-expert kernels in one decode step: the
device operations named ``moe_experts`` launched inside the benchmark's
``decode_step`` span, over the number of those spans."""

from acxbench import deepseek_cost as dc

UNIT, MOVES, SOURCE = "ms", "serve_tokens_per_s", "device_trace"
LAYER = "kernels: MLA (ops/mla.py), routed experts (ops/moe_experts.py)"


def read(art):
    if art.kind != "serve" or art.trace is None:
        return None
    n = art.trace.count("decode_step")
    dev_ms = dc.named_device_ms(art.trace, "decode_step", dc.MOE_EXPERTS)
    if not n or dev_ms <= 0:
        return None
    return dev_ms / n
