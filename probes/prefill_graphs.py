"""The served prefill through its CUDA graphs (``models/decoding.py``:
``run_prefill``, ``PrefillGraphs``) against the plain pass, on the card.

    python3 probes/prefill_graphs.py check [name] [--max-bucket N]
    python3 probes/prefill_graphs.py cell <cell> [--seed N] [--seconds S]

``check`` draws each chat cell's model as the benchmark does
(``acxbench/configs``: GPT-2 124M, Mistral-7B-v0.3, DeepSeek-V2-Lite at
their published widths, bf16) and, for every power-of-two bucket from 8
to 1024 (Mistral's also 8192), seats four passes in a slot cache of four
slots: the first is the warm pass and the capture, the next three replay
at other real lengths and slots. It prints one ``PREFILL`` JSON line a
bucket: whether every pass's logits and slot rows equal a plain pass's
(a fresh cache, then the serve loop's scatter: the path before the
capture) bit for bit; the host time to issue one pass (no synchronise),
its wall time (synchronised) and, under ``torch.profiler``, the device
time and the device operations launched inside an ``acxbench.prefill``
range, both ways; and the capture's time.

``cell`` runs a serve cell as ``acxbench/run.py --trace 0`` does (set-up,
the warm-up call, a window of ``--seconds``) and prints one ``CELL`` JSON
line: the prefill capture state's counters after set-up and over the
window (total and by bucket), the untraced host time to issue a prefill
(``prefill_fn``, timed around each call), the peak device memory and the
end-to-end metrics.

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

from acxbench import harness, trace  # noqa: E402
from acxbench.run import _card, _fixed_caches  # noqa: E402

CHAT = {"gpt2-124m": 1024, "mistral-7b-v0.3": 8192,
        "deepseek-v2-lite": 1024}
KEYS = ("k", "v", "ks", "vs")


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


def _counts(pg):
    return dict(replayed=pg.replayed, eager=pg.eager, captures=pg.captures,
                buckets={b: dict(n) for b, n in sorted(pg.buckets.items())})


def _less(a, b):
    """Counters ``a`` less ``b`` (as :func:`_counts` gives them)."""
    out = {k: a[k] - b[k] for k in ("replayed", "eager", "captures")}
    out["buckets"] = {
        bk: {k: n[k] - b["buckets"].get(bk, {}).get(k, 0) for k in n}
        for bk, n in a["buckets"].items()}
    return out


def cell(name, seed, seconds, bench=None, device="cuda"):
    from mpi_acx_torch.models import serving
    bench = bench or harness.Bench()
    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    run = SimpleNamespace(cell=name, workload=wl, config=cfg, seed=seed,
                          device=device, trace=False,
                          family=bench.family(cfg["family"]))
    drv = bench.driver(wl["driver"]).Driver(run)
    t0 = time.perf_counter()
    drv.setup()
    setup_s = time.perf_counter() - t0
    fns = drv.fns
    pg = fns.slots.cache.prefills
    after_setup = _counts(pg)
    issue = []
    prefill_fn = fns[0]

    def timed(*a, **kw):
        t = time.perf_counter()
        out = prefill_fn(*a, **kw)
        issue.append(time.perf_counter() - t)
        return out

    drv.fns = serving.ServerFns((timed,) + tuple(fns[1:]))
    drv.fns.slots = fns.slots
    drv.window(seconds)
    e2e = drv.end_to_end(seconds)
    window = _less(_counts(pg), after_setup)
    n = window["replayed"] + window["eager"]
    out = dict(cell=name, seed=seed, seconds=seconds, setup_s=setup_s,
               after_setup=after_setup, window=window,
               replayed_share=window["replayed"] / n if n else None,
               prefills=len(issue),
               issue_ms_per_prefill=1e3 * sum(issue) / max(len(issue), 1),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               calls=len(drv.calls), e2e=e2e)
    print("CELL " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("check", "cell"))
    ap.add_argument("name", nargs="?")
    ap.add_argument("--max-bucket", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=987654321)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args()
    _fixed_caches()
    torch.cuda.set_device(0)
    torch.set_num_threads(1)
    print(f"card: {_card()}; torch {torch.__version__}", flush=True)
    if args.mode == "check":
        for name in [args.name] if args.name else list(CHAT):
            check(name, args.max_bucket)
    else:
        cell(args.name, args.seed, args.seconds)


if __name__ == "__main__":
    main()
