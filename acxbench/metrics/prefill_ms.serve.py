"""Mean time of a prefill in the window, from the program's request log:
``prefill_start`` to ``prefill_end`` of each request."""

from acxbench.metrics import SERVE_LOOP

UNIT, LAYER, MOVES, SOURCE = "ms", SERVE_LOOP, "ttft_p95_ms", "program_span"


def read(art):
    if art.kind != "serve":
        return None
    lo, hi = art.window
    open_ = {}
    spans = []
    for rec in art.reqlog:
        if rec["k"] == "prefill_start":
            open_[rec["rid"]] = rec["t"]
        elif rec["k"] == "prefill_end" and rec.get("rid") in open_:
            t0 = open_.pop(rec["rid"])
            if lo <= t0 and rec["t"] <= hi:
                spans.append(rec["t"] - t0)
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
