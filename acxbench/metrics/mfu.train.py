"""Model FLOPs of the window's training over the chip's bf16 peak: each
completed step's products, causal attention and head, forward and
backward (three times the forward, no recompute: ``flops
.train_step_flops``), over the window's length times 989 TFLOP/s."""

from acxbench.metrics import TRAIN_STEP
from acxbench.roofline import PEAK_FLOPS

UNIT, LAYER, MOVES, SOURCE = "%", TRAIN_STEP, "train_tokens_per_s", \
    "program_counter"


def read(art):
    if art.kind != "train" or not art.steps:
        return None
    return (100.0 * art.steps * art.step_flops
            / (art.window_s * PEAK_FLOPS["bfloat16"]))
