"""Host time of one decode step in the window, from the program's request
log: the ``decode_step`` records' ``dt_s`` (one record a round of
``chunk`` steps, ending when the round's tokens reach the host), over the
rounds times ``chunk``."""

from acxbench.metrics import MODEL_STEP

UNIT, LAYER, MOVES, SOURCE = "ms", MODEL_STEP, "serve_tokens_per_s", \
    "program_span"


def read(art):
    if art.kind != "serve":
        return None
    lo, hi = art.window
    dts = [r["dt_s"] for r in art.reqlog
           if r["k"] == "decode_step" and lo <= r["t"] <= hi]
    if not dts:
        return None
    return 1e3 * sum(dts) / (len(dts) * art.chunk)
