"""Host time to issue one decode step: the program's ``acx.serve.issue``
ranges (``models/serving.py``: the ``step_fn`` call that enqueues a
round's ``chunk`` decode steps and picks, the token copy to the device
included, before the host waits for the tokens), over the ranges times
``chunk``."""

from acxbench import program_spans
from acxbench.metrics import MODEL_STEP

UNIT, LAYER, MOVES, SOURCE = "ms", MODEL_STEP, "serve_tokens_per_s", \
    "program_span"


def read(art):
    if art.kind != "serve":
        return None
    issue = program_spans.ranges(art.trace, "acx.serve.issue")
    if issue is None:
        return None
    s, e = issue
    return 1e-6 * float((e - s).sum()) / (len(s) * art.chunk)
