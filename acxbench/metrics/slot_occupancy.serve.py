"""Share of the serve loop's slots that hold a request, over the window's
calls: each call's ``ServingMetrics.slot_occupancy_mean``, weighted by
the call's decode steps."""

from acxbench.metrics import SERVE_LOOP

UNIT, LAYER, MOVES, SOURCE = "%", SERVE_LOOP, "serve_tokens_per_s", \
    "program_counter"


def read(art):
    if art.kind != "serve":
        return None
    ms = [c["out"].metrics for c in art.calls]
    steps = sum(m.steps for m in ms)
    if not steps:
        return None
    return 100.0 * sum(m.slot_occupancy_mean * m.steps for m in ms) / steps
