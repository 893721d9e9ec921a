"""B10's forward (K1 with the row logsumexp) against its roofline: the
least time of every call of the traced window (``flops.k1_cost`` with the
lse) over the device time of everything launched inside the span round
``flash_attention_lse``."""

from acxbench import flops
from acxbench.metrics import KERNELS
from acxbench.roofline import bound_ms

UNIT, LAYER, MOVES, SOURCE = "%", KERNELS, "train_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "train" or art.trace is None or not art.k1_calls:
        return None
    dev_ms = 1e3 * art.trace.device_s("k1_lse")
    if dev_ms <= 0:
        return None
    least = sum(bound_ms(*flops.k1_cost(B, S, H, D, lse=True))[0]
                for B, S, H, D in art.k1_calls)
    return 100.0 * least / dev_ms
