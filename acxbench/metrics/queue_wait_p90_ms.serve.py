"""How long a request waits in the queue before its prefill: over the
program's ``acx.serve.refill`` ranges of the traced window
(``models/serving.py``: one request's prefill, first token and scatter),
the start of each less the start of the ``acx.serve.call`` range it lies
in (the call's requests all arrive as it starts); the 90th percentile."""

import numpy as np

from acxbench import program_spans
from acxbench.metrics import SERVE_LOOP

UNIT, LAYER, MOVES, SOURCE = "ms", SERVE_LOOP, "ttft_p95_ms", "program_span"


def read(art):
    if art.kind != "serve" or art.trace is None:
        return None
    refills = program_spans.ranges(art.trace, "acx.serve.refill")
    calls = art.trace.spans.get("acx.serve.call")
    if refills is None or calls is None:
        return None
    # The call in flight when the profiler stopped counts too: its start
    # is its requests' arrival, whatever its end.
    idx = program_spans.enclosing(calls, refills[0])
    waits = (refills[0] - calls[0][np.maximum(idx, 0)])[idx >= 0]
    if not len(waits):
        return None
    return 1e-6 * float(np.percentile(waits, 90))
