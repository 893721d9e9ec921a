"""K1 at prefill against its roofline: the least time of every prefill
attention call of the traced window (``roofline.bound_ms`` of its
operations and bytes at the real prompt length, ``flops.k1_cost``) over
the device time of everything launched inside the attention entry
point's span."""

from acxbench import flops
from acxbench.metrics import KERNELS
from acxbench.roofline import bound_ms

UNIT, LAYER, MOVES, SOURCE = "%", KERNELS, "serve_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "serve" or art.trace is None or not art.k1_calls:
        return None
    dev_ms = 1e3 * art.trace.device_s("k1")
    if dev_ms <= 0:
        return None
    least = sum(bound_ms(*flops.k1_cost(B, S, H, D))[0]
                for B, S, H, D in art.k1_calls)
    return 100.0 * least / dev_ms
