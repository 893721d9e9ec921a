"""K2 at decode against its roofline: the least time of every decode
attention call of the traced window (the bytes of the live rows at each
call's positions, ``flops.k2_cost``; one call a layer a step) over the
device time of everything launched inside the entry point's span."""

from acxbench import flops
from acxbench.metrics import KERNELS
from acxbench.roofline import bound_ms

UNIT, LAYER, MOVES, SOURCE = "%", KERNELS, "serve_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "serve" or art.trace is None or not art.k2_steps:
        return None
    dev_ms = 1e3 * art.trace.device_s("k2")
    if dev_ms <= 0:
        return None
    dm = art.dims
    least = dm.layers * sum(
        bound_ms(*flops.k2_cost(live, B, dm.heads, dm.kv_heads,
                                dm.head_dim))[0]
        for live, B in art.k2_steps)
    return 100.0 * least / dev_ms
