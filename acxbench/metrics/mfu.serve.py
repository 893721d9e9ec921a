"""The served window's model FLOPs over the chip's bf16 peak: every
request completed in the window, its prefill at the real prompt length
and its decode tokens at their positions (``flops.request_flops``), over
the window's length times 989 TFLOP/s."""

from acxbench import flops
from acxbench.metrics import MODEL_STEP
from acxbench.roofline import PEAK_FLOPS

UNIT, LAYER, MOVES, SOURCE = "%", MODEL_STEP, "serve_tokens_per_s", \
    "program_counter"


def read(art):
    if art.kind != "serve" or not art.requests:
        return None
    total = sum(flops.request_flops(art.dims, S, n)
                for S, n, *_ in art.requests)
    lo, hi = art.window
    return 100.0 * total / ((hi - lo) * PEAK_FLOPS["bfloat16"])
