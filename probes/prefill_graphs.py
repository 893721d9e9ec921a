"""The served prefill through its CUDA graphs (``models/decoding.py``:
``run_prefill``, ``PrefillGraphs``) against the plain pass, on the card.

    python3 probes/prefill_graphs.py check [name] [--max-bucket N]
    python3 probes/prefill_graphs.py long [name]
    python3 probes/prefill_graphs.py cell <cell> [--seed N] [--seconds S]
        [--trace 1]

``check`` draws each chat cell's model as the benchmark does
(``acxbench/configs``: GPT-2 124M, Mistral-7B-v0.3, DeepSeek-V2-Lite at
their published widths, bf16) and, for every power-of-two bucket from 8
to 1024 (Mistral's also 8192), seats four passes in a slot cache of four
slots: the first is the warm pass and the capture, the next three replay
at other real lengths and slots (a bucket above
``decoding.PREFILL_CAPTURE_MAX`` is never captured: its four passes run
eagerly, counted ``exact``). It prints one ``PREFILL`` JSON line a
bucket: whether every pass's logits and slot rows equal a plain pass's
(a fresh cache, then the serve loop's scatter: the path before the
capture) bit for bit; the host time to issue one pass (no synchronise),
its wall time (synchronised) and, under ``torch.profiler``, the device
time and the device operations launched inside an ``acxbench.prefill``
range, both ways; and the capture's time.

``long`` weighs the rule for prompts above the capture cap
(``decoding.PREFILL_CAPTURE_MAX``, 1024) on a chat cell's model: for real
lengths from 1025 to 2048 it seats the prompt's pass at its own length
(eager, as served) and, with the cap raised to 2048 for the probe alone,
the same prompt padded to the 2048 bucket and replayed from its capture.
It prints one ``LONG`` JSON line a length: both ways, the host time to
issue a pass, its synchronised wall time and its device time under
``torch.profiler``, and the largest difference of their logits.

``cell`` runs a serve cell as ``acxbench/run.py`` does (set-up, the
warm-up call, a window of ``--seconds``, without the check) and prints
one ``CELL`` JSON line: the prefill capture state's counters
(``replayed``, ``eager``, ``captures``, ``exact``) after set-up and over
the window (total and by prompt length), the host time to issue a
prefill (``prefill_fn``, timed around each call), the peak device memory,
the end-to-end metrics and the window's completed requests, their model
FLOPs (``acxbench/flops.py``) and that work's share of the bf16 peak over
the window (``mfu.serve``'s reading). With ``--trace 1`` the run is the
traced one: it also gives where in the window the profiler stopped and
how long its stop took, the host time of the prefills issued while the
profiler ran, the traced window's busy and idle seconds and the per-layer
metrics as the benchmark reads them.

Run from the repository root on a machine with one NVIDIA GPU.
"""

import argparse
import json
import os
import sys
import time
from types import SimpleNamespace

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from acxbench import flops, harness, trace  # noqa: E402
from acxbench.roofline import PEAK_FLOPS  # noqa: E402
from acxbench.run import _card, _fixed_caches  # noqa: E402

CHAT = {"gpt2-124m": 1024, "mistral-7b-v0.3": 8192,
        "deepseek-v2-lite": 1024}
KEYS = ("k", "v", "ks", "vs")
COUNTERS = ("replayed", "eager", "captures", "exact")


def _model(name):
    bench = harness.Bench()
    cfg = bench.config(name)
    fam = bench.family(cfg["family"])
    pcfg = fam.port_config(cfg, torch.bfloat16)
    params = fam.draw_params(cfg, 1234, "cuda", torch.bfloat16)
    return fam.port_module(), pcfg, params


def _tokens(vocab, real, bucket, seed):
    g = torch.Generator().manual_seed(seed)
    tok = torch.zeros((1, bucket), dtype=torch.int32)
    tok[0, :real] = torch.randint(0, vocab, (real,), generator=g)
    return tok.cuda()


def _pass(fns, slots, tok, real, slot, seated):
    """One refill's device work as the serve loop issues it: the logits,
    the slot cache with the prompt seated in ``slot``."""
    prefill_fn, scatter_fn = fns[0], fns[2]
    if not seated:
        logits, one = prefill_fn(tok, real - 1)
        return logits, scatter_fn(slots, one, slot, real)
    logits, _ = prefill_fn(tok, real - 1, seat=(slots, slot))
    slots["pos"][slot] = real
    return logits, slots


def _timed(fns, slots, tok, real, seated, n=10):
    """(host ms to issue a pass, wall ms a synchronised pass)."""
    issue = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        a = time.perf_counter()
        _pass(fns, slots, tok, real, 0, seated)
        issue += time.perf_counter() - a
        torch.cuda.synchronize()
    return 1e3 * issue / n, 1e3 * (time.perf_counter() - t0) / n


def _profiled(fns, slots, tok, real, seated, n=3):
    """(device ops, device ms) a pass launched inside an
    ``acxbench.prefill`` range."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    with trace.span("window"):
        for _ in range(n):
            with trace.span("prefill"):
                _pass(fns, slots, tok, real, 0, seated)
        torch.cuda.synchronize()
    prof.stop()
    tr = trace.reduce_events(prof.profiler.kineto_results.events())
    return (int(tr.inside("prefill").sum()) / n,
            1e3 * tr.device_s("prefill") / n)


def check(name, max_bucket):
    from mpi_acx_torch.models import serving
    module, cfg, params = _model(name)
    top = min(max_bucket, CHAT[name])
    fns = serving.make_server_fns(params, cfg, module)
    slots = serving.seat_slots(module.init_kv_cache(cfg, 4, top,
                                                    device="cuda"))
    plain = {k: t.clone() for k, t in slots.items()}
    buckets = [b for b in (8, 16, 32, 64, 128, 256, 512, 1024, 8192)
               if b <= top]
    for bucket in buckets:
        equal, worst, capture_s = True, 0.0, None
        for n in range(4):
            real = max(1, bucket - 3 * n) if n else bucket // 2 + 1
            tok = _tokens(cfg.vocab, real, bucket, seed=bucket + n)
            want, plain = _pass(fns, plain, tok, real, n, seated=False)
            want = want.clone()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, slots = _pass(fns, slots, tok, real, n, seated=True)
            torch.cuda.synchronize()
            if n == 0:
                capture_s = time.perf_counter() - t0
            equal &= torch.equal(want, got)
            worst = max(worst, float((want - got).abs().max()))
            equal &= all(torch.equal(plain[k][:, n, :bucket],
                                     slots[k][:, n, :bucket])
                         for k in KEYS if k in slots)
        pg = slots.prefills
        real = bucket // 2 + 1
        tok = _tokens(cfg.vocab, real, bucket, seed=7)
        out = dict(model=name, bucket=bucket, real=real, equal=bool(equal),
                   max_abs_logit_diff=worst, capture_s=capture_s,
                   counters=pg.buckets.get(bucket))
        out["eager_issue_ms"], out["eager_wall_ms"] = _timed(
            fns, plain, tok, real, seated=False)
        out["graph_issue_ms"], out["graph_wall_ms"] = _timed(
            fns, slots, tok, real, seated=True)
        e = _profiled(fns, plain, tok, real, seated=False)
        g = _profiled(fns, slots, tok, real, seated=True)
        out["profiled_eager"] = dict(ops=e[0], device_ms=e[1])
        out["profiled_graph"] = dict(ops=g[0], device_ms=g[1])
        print("PREFILL " + json.dumps(out), flush=True)
    print("MEMORY " + json.dumps(dict(
        model=name, peak_gb=torch.cuda.max_memory_allocated() / 1e9)),
        flush=True)
    del params, plain, slots, fns
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def long(name, lens=(1025, 1280, 1536, 2048)):
    from mpi_acx_torch.models import decoding, serving
    module, cfg, params = _model(name)
    fns = serving.make_server_fns(params, cfg, module)
    slots = serving.seat_slots(module.init_kv_cache(cfg, 1, 2048,
                                                    device="cuda"))
    cap = decoding.PREFILL_CAPTURE_MAX
    for real in lens:
        own = _tokens(cfg.vocab, real, real, seed=real)
        pad = _tokens(cfg.vocab, real, 2048, seed=real)
        out = dict(model=name, real=real, cap=cap)
        exact, _ = _pass(fns, slots, own, real, 0, seated=True)
        exact = exact.clone()
        out["exact_issue_ms"], out["exact_wall_ms"] = _timed(
            fns, slots, own, real, seated=True)
        out["exact_device_ms"] = _profiled(fns, slots, own, real,
                                           seated=True)[1]
        decoding.PREFILL_CAPTURE_MAX = 2048
        try:
            padded, _ = _pass(fns, slots, pad, real, 0, seated=True)
            out["pad_issue_ms"], out["pad_wall_ms"] = _timed(
                fns, slots, pad, real, seated=True)
            out["pad_device_ms"] = _profiled(fns, slots, pad, real,
                                             seated=True)[1]
        finally:
            decoding.PREFILL_CAPTURE_MAX = cap
        out["max_abs_logit_diff"] = float((exact - padded).abs().max())
        out["counters"] = {b: dict(n) for b, n in
                           sorted(slots.prefills.buckets.items())}
        print("LONG " + json.dumps(out), flush=True)
    del params, slots, fns
    torch.cuda.empty_cache()


def _counts(pg):
    """The counters of ``pg`` (``exact`` 0 for a tree without it)."""
    out = {k: getattr(pg, k, 0) for k in COUNTERS}
    out["buckets"] = {b: dict(n) for b, n in sorted(pg.buckets.items())}
    return out


def _less(a, b):
    """Counters ``a`` less ``b`` (as :func:`_counts` gives them)."""
    out = {k: a[k] - b[k] for k in COUNTERS}
    out["buckets"] = {
        bk: {k: n[k] - b["buckets"].get(bk, {}).get(k, 0) for k in n}
        for bk, n in a["buckets"].items()}
    return out


def _window_work(drv, seconds):
    """The window's completed requests, their model FLOPs and that work's
    share of the bf16 peak over the window (as ``mfu.serve`` reads it)."""
    done = drv.in_window()
    total = sum(flops.request_flops(drv.dims, S, n) for S, n, *_ in done)
    return dict(requests=len(done), model_tflop=total / 1e12,
                mfu=100.0 * total / (seconds * PEAK_FLOPS["bfloat16"]))


def cell(name, seed, seconds, traced=False, bench=None, device="cuda"):
    from mpi_acx_torch.models import decoding, serving
    bench = bench or harness.Bench()
    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    run = SimpleNamespace(cell=name, workload=wl, config=cfg, seed=seed,
                          device=device, trace=traced,
                          family=bench.family(cfg["family"]))
    drv = bench.driver(wl["driver"]).Driver(run)
    t0 = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t0
    fns = drv.fns
    pg = fns.slots.cache.prefills
    after_setup = _counts(pg)
    issue, traced_issue, stops = [], [], []
    prefill_fn = fns[0]

    def timed(*a, **kw):
        on = drv.tracing()
        t = time.perf_counter()
        out = prefill_fn(*a, **kw)
        (traced_issue if on else issue).append(time.perf_counter() - t)
        return out

    stop = trace.Tracer.stop

    def timed_stop(tracer):
        t = time.perf_counter()
        stop(tracer)
        stops.append((t, time.perf_counter() - t))

    trace.Tracer.stop = timed_stop
    drv.fns = serving.ServerFns((timed,) + tuple(fns[1:]))
    drv.fns.slots = fns.slots
    t_window = time.perf_counter()
    try:
        drv.window(seconds)
    finally:
        trace.Tracer.stop = stop
    e2e = drv.end_to_end(seconds)
    window = _less(_counts(pg), after_setup)
    n = sum(window[k] for k in ("replayed", "eager", "exact"))
    out = dict(cell=name, seed=seed, seconds=seconds, traced=traced,
               cap=getattr(decoding, "PREFILL_CAPTURE_MAX", None),
               setup_s=setup_s, after_setup=after_setup, window=window,
               replayed_share=window["replayed"] / n if n else None,
               prefills=len(issue),
               issue_ms_per_prefill=1e3 * sum(issue) / max(len(issue), 1),
               peak_gb=(torch.cuda.max_memory_allocated() / 1e9
                        if torch.cuda.is_available() else None),
               calls=len(drv.calls), e2e=e2e, work=_window_work(drv, seconds))
    if traced:
        art = drv.artifacts()
        tr = art.trace
        out["stops"] = [dict(at_s=t - t_window, stop_s=d) for t, d in stops]
        out["traced_prefills"] = len(traced_issue)
        out["traced_issue_ms_per_prefill"] = (
            1e3 * sum(traced_issue) / max(len(traced_issue), 1))
        if tr is not None:
            out["trace_window_s"] = tr.window_s
            out["trace_busy_s"] = tr.busy_s()
            out["trace_linked"] = list(tr.linked)
        out["per_layer"] = {}
        for m in bench.per_layer(name):
            v = bench.metric(m["name"]).read(art)
            if v is not None:
                out["per_layer"][m["name"]] = v
    drv.release()
    print("CELL " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "long", "cell"))
    ap.add_argument("name", nargs="?")
    ap.add_argument("--max-bucket", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    _fixed_caches()
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    print(f"card: {_card()}; torch {torch.__version__}", flush=True)
    if args.mode == "check":
        for name in [args.name] if args.name else list(CHAT):
            check(name, args.max_bucket)
    elif args.mode == "long":
        for name in ([args.name] if args.name
                     else ["mistral-7b-v0.3", "deepseek-v2-lite"]):
            long(name)
    else:
        cell(args.name, args.seed, args.seconds, bool(args.trace))


if __name__ == "__main__":
    main()
