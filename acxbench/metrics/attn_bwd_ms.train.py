"""Device time of the attention backward per step: the device operations
launched inside the program's ``acx.ops.attn_bwd`` ranges
(``ops/attention.py``: the blockwise backward of ``_Flash`` and
``_FlashLse``, entered on autograd's thread), over the count of its
``acx.train.backward`` ranges (``train.py``: one a step)."""

from acxbench import program_spans
from acxbench.metrics import TRAIN_STEP

UNIT, LAYER, MOVES, SOURCE = "ms", TRAIN_STEP, "train_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "train":
        return None
    steps = program_spans.ranges(art.trace, "acx.train.backward")
    if steps is None or "acx.ops.attn_bwd" not in art.trace.spans:
        return None
    return 1e3 * art.trace.device_s("acx.ops.attn_bwd") / len(steps[0])
