"""Share of the traced window in which no operation ran on the device."""

from acxbench.metrics import DEVICE

UNIT, LAYER, MOVES, SOURCE = "%", DEVICE, "train_tokens_per_s", \
    "device_trace"


def read(art):
    if art.kind != "train" or art.trace is None:
        return None
    return 100.0 * (1.0 - art.trace.busy_s() / art.trace.window_s)
