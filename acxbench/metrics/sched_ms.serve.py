"""The scheduler's own host time per decode step: each of the program's
``acx.serve.round`` ranges (``models/serving.py``: one scheduler turn)
less the ``acx.serve.issue``, ``acx.serve.wait`` and ``acx.serve.refill``
ranges inside it, summed over the rounds and divided by the rounds times
``chunk``."""

from acxbench import program_spans
from acxbench.metrics import SERVE_LOOP

UNIT, LAYER, MOVES, SOURCE = "ms", SERVE_LOOP, "serve_tokens_per_s", \
    "program_span"

CHILDREN = ("acx.serve.issue", "acx.serve.wait", "acx.serve.refill")


def read(art):
    if art.kind != "serve":
        return None
    rounds = program_spans.ranges(art.trace, "acx.serve.round")
    if rounds is None:
        return None
    s, e = rounds
    own = int((e - s).sum())
    for name in CHILDREN:
        inner = program_spans.ranges(art.trace, name)
        if inner is not None:
            own -= program_spans.time_inside(rounds, inner)
    return 1e-6 * own / (len(s) * art.chunk)
