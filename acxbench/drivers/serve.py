"""Serving traffic: a closed loop of one client that sends the port's
``models.serving.serve_greedy`` one batch of requests after another.

Each call carries ``requests_per_call`` requests of the seed's traffic
(``traffic.py``), all arriving at the call; calls follow each other back
to back. The window is the ``--seconds`` from the start of the first
timed call. A request belongs to it when it completes inside it: its
call's start plus its ``latency_s`` in the program's own
``ServingMetrics.per_request``. The window's rate counts the generated
tokens of those requests; its tails are over them. The call in flight
at the window's end runs out, and its requests that complete later are
not counted.

The traced run (``--trace 1``) also hands the server a thin family object
that forwards ``prefill``, ``decode_step`` and ``init_kv_cache`` to the
port's family inside the benchmark's spans, wraps the attention entry
points where the families look them up (``select_attention``'s result
at prefill, ``grouped_decode_attend`` at decode), arms the program's
request log, and runs ``torch.profiler`` over the first
``trace_seconds`` of the window.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from acxbench import flops, trace
from acxbench.reference.common import exact_f32, matmul
from acxbench.traffic import ServeTraffic


class _TracedFamily:
    """The port's family module behind the benchmark's spans."""

    def __init__(self, module, drv):
        self.m, self.drv = module, drv

    def prefill(self, params, cfg, tokens, max_len, **kw):
        self.drv.maybe_stop_trace()
        real = kw.get("last_index")
        self.drv.real_len = tokens.shape[1] if real is None else real + 1
        with trace.span("prefill"):
            return self.m.prefill(params, cfg, tokens, max_len, **kw)

    def decode_step(self, params, cfg, cache, token):
        self.drv.maybe_stop_trace()
        with trace.span("decode_step"):
            if self.drv.tracing():
                self.drv.k2_pos.append(cache["pos"].clone())
            return self.m.decode_step(params, cfg, cache, token)

    def init_kv_cache(self, *a, **kw):
        return self.m.init_kv_cache(*a, **kw)

    def check_device(self, *a, **kw):
        return self.m.check_device(*a, **kw)


class Driver:
    kind = "serve"

    def __init__(self, run):
        self.run = run
        self.wl, self.cfg = run.workload, run.config
        self.s = self.wl["serve"]
        self.dims = flops.dims(self.cfg)
        self.dev = torch.device(run.device)
        self.tracer = None
        self.k1_calls, self.k2_pos = [], []
        self.real_len = None
        self.reqlog_path = None
        self.restore = []

    # -- set-up ---------------------------------------------------------

    def setup(self):
        from mpi_acx_torch.models import serving
        fam = self.run.family
        if self.run.trace:
            self._arm_reqlog()
        self.pcfg = fam.port_config(self.cfg, torch.bfloat16)
        self.params = fam.draw_params(self.cfg, self.run.seed, self.dev,
                                      torch.bfloat16)
        module = fam.port_module()
        family = module
        if self.run.trace:
            family = _TracedFamily(module, self)
            self._wrap_attention(module)
        self.family = family
        self.fns = serving.make_server_fns(self.params, self.pcfg, family,
                                           chunk=self.s["chunk"])
        self.traffic = ServeTraffic(self.wl["traffic"], self.dims.vocab,
                                    self.run.seed)
        self._warm_up()

    def _arm_reqlog(self):
        from mpi_acx_torch import reqlog
        prefix = os.path.join(tempfile.gettempdir(), "acxbench-reqlog")
        self.reqlog_path = Path(f"{prefix}.rank0.reqlog.jsonl")
        self.reqlog_path.unlink(missing_ok=True)
        os.environ["ACX_REQLOG"] = prefix
        # The log's clock is monotonic from its arming; the window's is
        # perf_counter: keep both readings to map one onto the other.
        self.reqlog_zero = time.monotonic_ns()
        self.reqlog_offset = time.perf_counter() - self.reqlog_zero / 1e9
        if not reqlog.enabled():
            raise RuntimeError("the request log did not arm")

    def _wrap_attention(self, module):
        """Spans around the attention entry points, where the family looks
        them up (tracing only)."""
        drv = self
        select = module.select_attention
        decode = module.grouped_decode_attend

        def select_attention(use_flash):
            fn = select(use_flash)

            def attend(q, k, v, *a, **kw):
                if drv.tracing():
                    S = min(drv.real_len or q.shape[1], q.shape[1])
                    drv.k1_calls.append((q.shape[0], S, q.shape[2],
                                         q.shape[3]))
                with trace.span("k1"):
                    return fn(q, k, v, *a, **kw)
            return attend

        def grouped_decode_attend(*a, **kw):
            with trace.span("k2"):
                return decode(*a, **kw)

        self.restore = [(module, "select_attention", select),
                        (module, "grouped_decode_attend", decode)]
        module.select_attention = select_attention
        module.grouped_decode_attend = grouped_decode_attend

    def _serve(self, prompts, n_new):
        from mpi_acx_torch.models import serving
        return serving.serve_greedy(
            self.params, self.pcfg, prompts, n_new, self.s["n_slots"],
            self.s["max_len"], family=self.family, chunk=self.s["chunk"],
            server_fns=self.fns, device=self.dev)

    def _warm_up(self):
        """One short call: a request in each power-of-two prompt bucket
        the traffic reaches, decoding two rounds."""
        lens = sorted({int(x) for x in self.traffic.prompt_lens})
        buckets = sorted({1 << max(3, (n - 1).bit_length()) for n in lens})
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, self.dims.vocab,
                                min(max(b, lens[0]), lens[-1]),
                                dtype=np.int32) for b in buckets]
        self._serve(prompts, 2 * self.s["chunk"] + 1)
        self._sync()
        self.k1_calls.clear()
        self.k2_pos.clear()

    def _sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    # -- window ---------------------------------------------------------

    def tracing(self) -> bool:
        return self.tracer is not None and self.tracer.running

    def maybe_stop_trace(self):
        if (self.tracing() and time.perf_counter() - self.tracer.t_start
                >= self.wl["trace_seconds"]):
            self.tracer.stop()

    def window(self, seconds):
        if self.run.trace and self.dev.type == "cuda":
            self.tracer = trace.Tracer()
            self.tracer.start()
        self.calls = []
        self.seconds = seconds
        self.t0 = time.perf_counter()
        end = self.t0 + seconds
        while time.perf_counter() < end:
            reqs = self.traffic.call()
            c0 = time.perf_counter()
            with trace.span("serve_call"):
                out = self._serve([p for p, _ in reqs], [n for _, n in reqs])
            self.maybe_stop_trace()
            self.calls.append(dict(t0=c0, reqs=reqs, out=out))
        if self.tracing():
            self.tracer.stop()

    def in_window(self):
        """(prompt_len, new_tokens, ttft_s, latency_s, output) of every
        request that completed inside the window, from the program's
        per-request telemetry."""
        end = self.t0 + self.seconds
        out = []
        for c in self.calls:
            for r in c["out"].metrics.per_request:
                if c["t0"] + r.latency_s <= end:
                    out.append((len(c["reqs"][r.rid][0]), r.new_tokens,
                                r.ttft_s, r.latency_s, c["out"][r.rid]))
        return out

    def memory_peak(self) -> int:
        if self.dev.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.dev))

    def end_to_end(self, seconds) -> dict:
        done = self.in_window()
        attempted = sum(len(c["reqs"]) for c in self.calls)
        failed = sum(1 for c in self.calls
                     for (p, n), o in zip(c["reqs"], c["out"])
                     if not isinstance(o, np.ndarray) or len(o) != len(p) + n)
        ttft = [t for _, _, t, _, _ in done]
        tpot = [(lat - t) / (n - 1) for _, n, t, lat, _ in done if n > 1]
        pct = (lambda xs: float(np.percentile(xs, 95)) * 1e3
               if xs else None)
        return dict(attempted=attempted, failed=failed,
                    serve_tokens_per_s=sum(n for _, n, *_ in done) / seconds,
                    ttft_p95_ms=pct(ttft), tpot_p95_ms=pct(tpot))

    def artifacts(self):
        pos = (torch.stack(self.k2_pos) if self.k2_pos
               else torch.zeros(0, 1, dtype=torch.int32))
        return SimpleNamespace(
            kind="serve", dims=self.dims, chunk=self.s["chunk"],
            n_slots=self.s["n_slots"],
            calls=self.calls, window=(self.t0, self.t0 + self.seconds),
            requests=self.in_window(),
            trace=(self.tracer.result() if self.tracer is not None
                   else None),
            k1_calls=list(self.k1_calls),
            k2_steps=list(zip((pos + 1).sum(1).tolist(),
                              [pos.shape[1]] * pos.shape[0])),
            reqlog=self._read_reqlog())

    def _read_reqlog(self):
        if self.reqlog_path is None or not self.reqlog_path.exists():
            return []
        out = []
        for line in self.reqlog_path.read_text().splitlines():
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "k" in rec:
                rec["t"] = ((self.reqlog_zero + rec["t_mono_ns"]) / 1e9
                            + self.reqlog_offset)
                out.append(rec)
        return out

    # -- check ----------------------------------------------------------

    def release(self):
        """Free the program's state; the weights stay for the reference."""
        self.fns = self.family = None
        self.k2_pos = []
        for mod, name, fn in self.restore:
            setattr(mod, name, fn)
        self.restore = []
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def sample(self):
        """The requests the check replays: the longest that completed in
        the window and a sample drawn from the seed, ``sample_requests``
        in all."""
        done = self.in_window()
        if not done:
            return []
        order = sorted(range(len(done)),
                       key=lambda i: -(done[i][0] + done[i][1]))
        rest = order[1:]
        rng = np.random.default_rng([self.run.seed, 1])
        k = min(len(rest), self.wl["check"]["sample_requests"] - 1)
        pick = [order[0]] + [rest[i] for i in
                             rng.choice(len(rest), k, replace=False)]
        return [(done[i][0], done[i][4]) for i in pick]

    def check(self, control=False) -> dict:
        """The widest gap by which a served token's reference logit lies
        below the reference's best, over the sampled requests (with
        ``control``, also the gap of the token the float8 reference puts
        first at each of those positions)."""
        return serve_gaps(self.run.family.reference, self.params, self.cfg,
                          self.sample(), self.dev, control=control)


def serve_gaps(ref, params, cfg, seqs, device, control=False) -> dict:
    """``max_logit_gap`` (and ``control_gap`` with ``control``) over
    ``seqs``, a list of (prompt_len, prompt + served tokens)."""
    worst = ctrl = 0.0
    tokens_checked = 0
    with torch.no_grad(), exact_f32():
        for S, seq in seqs:
            seq = torch.as_tensor(np.asarray(seq), device=device).long()
            pos = torch.arange(S - 1, len(seq) - 1, device=device)
            served = seq[S:]
            lg = ref.logits_at(params, cfg, seq[:-1], pos, matmul("f32"))
            best = lg.max(dim=-1).values
            gap = best - lg.gather(1, served[:, None])[:, 0]
            worst = max(worst, float(gap.max()))
            tokens_checked += len(served)
            if control:
                lc = ref.logits_at(params, cfg, seq[:-1], pos,
                                   matmul("fp8"))
                pick = lc.argmax(dim=-1)
                cg = best - lg.gather(1, pick[:, None])[:, 0]
                ctrl = max(ctrl, float(cg.max()))
            del lg
    # Nothing checked is no pass.
    out = {"max_logit_gap": worst if tokens_checked else None,
           "tokens_checked": tokens_checked}
    if control:
        out["control_gap"] = ctrl
    return out
