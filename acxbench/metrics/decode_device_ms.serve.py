"""Device time of one decode step in the traced window: the device
operations launched inside the benchmark's span round the family's
``decode_step``, over the number of those spans."""

from acxbench.metrics import MODEL_STEP

UNIT, LAYER, MOVES, SOURCE = "ms", MODEL_STEP, "serve_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "serve" or art.trace is None:
        return None
    n = art.trace.count("decode_step")
    if not n:
        return None
    return 1e3 * art.trace.device_s("decode_step") / n
