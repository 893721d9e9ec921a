"""Host time a step waited for its batch: the benchmark's span round
``next()`` of ``data.prefetch``, per step of the window."""

from acxbench.metrics import TOKEN_DATA

UNIT, LAYER, MOVES, SOURCE = "ms", TOKEN_DATA, "train_tokens_per_s", \
    "program_span"


def read(art):
    if art.kind != "train" or not art.data_wait_s:
        return None
    return 1e3 * sum(art.data_wait_s) / len(art.data_wait_s)
