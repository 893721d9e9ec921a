"""DeepSeek-V2-Lite's kernels and served path on the card
(``models/deepseek_v2.py``, ``ops/mla.py``, ``ops/moe_experts.py``).

    python3 probes/deepseek_v2.py kernels
    python3 probes/deepseek_v2.py serve [--requests N] [--seed N]
    python3 probes/deepseek_v2.py step [--steps N]

``kernels`` runs ``chip_smoke.py``'s phase-4f kernel checks alone: each
new kernel at the served path's shapes against its plain version, then
timed by CUDA-graph replay beside its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, whichever is larger), the plain version and,
where one PyTorch call computes the same function, that call. One
``KERNEL`` JSON line a kernel: the MLA decode (64 slots of 4096, ~34k
live rows), K1 at 192/128 (prompts of 161 and 1024) and the routed
experts (a decode batch of 64 tokens, 64 experts of 1408, top-6).

``serve`` draws DeepSeek-V2-Lite as the benchmark does
(``acxbench/configs/deepseek-v2-lite.json``, bf16), serves ``--requests``
chat requests through ``serving.serve_greedy`` (64 slots of 4096, chunk
4) twice on one ``make_server_fns`` result, and prints one ``SERVE``
JSON line: the capture counters (``DecodeGraphs``), the kernels' launch
counts, the MoE counters of the second call (experts touched a layer a
step, pairs a step), and the widest logit gap to the plain reference over
three served requests, with the float8 control beside it.

``step`` seats a 64-slot latent cache of 4096 (random rows, every slot at
a position in 200-400, as the chat cell's live lengths run), captures the
decode step and profiles ``--steps`` replayed steps: one ``STEP`` JSON
line with the device time a step, the device operations a step, and the
largest kernels by device time a step.

Run from the repository root on a machine with one NVIDIA GPU.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from acxbench.run import _card, _fixed_caches  # noqa: E402


def _emit(tag, **kw):
    print(tag + " " + json.dumps(kw), flush=True)


def kernels():
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(7)
    card = _card()
    for name, fn in (("mla_decode_attend", cs.ds_mla_decode),
                     ("mla_flash_attention", cs.ds_mla_prefill),
                     ("routed_experts", cs.ds_routed_experts)):
        err, times = fn(g, card)
        _emit("KERNEL", name=name, errors=err, **times)


def serve(n_requests, seed):
    from acxbench import harness
    from acxbench.drivers.serve import serve_gaps
    from mpi_acx_torch.models import serving
    from mpi_acx_torch.ops import mla, moe_experts
    bench = harness.Bench()
    cfg = bench.config("deepseek-v2-lite")
    fam = bench.family(cfg["family"])
    pcfg = fam.port_config(cfg, torch.bfloat16)
    t0 = time.perf_counter()
    params = fam.draw_params(cfg, seed, "cuda", torch.bfloat16)
    torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    module = fam.port_module()
    fns = serving.make_server_fns(params, pcfg, module, chunk=4)
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, pcfg.vocab, int(n), dtype=np.int32)
               for n in rng.integers(4, 300, n_requests)]
    n_new = [int(n) for n in rng.integers(4, 200, n_requests)]
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = serving.serve_greedy(params, pcfg, prompts, n_new, 64, 4096,
                                   family=module, chunk=4, server_fns=fns)
        times.append(time.perf_counter() - t0)
    gr = fns.slots.cache.graphs
    rc = np.array(out.round_counters)      # [rounds + 1, Lm, 2]
    steps = 4 * (len(rc) - 1)
    diff = rc[-1] - rc[0]
    seqs = [(len(prompts[i]), out[i]) for i in range(3)]
    gaps = serve_gaps(fam.reference, params, cfg, seqs, "cuda", control=True)
    _emit("SERVE", draw_s=t_draw, call_s=times,
          tokens=int(sum(n_new)), graphs=dict(
              captures=gr.captures, eager=gr.eager, replayed=gr.replayed),
          launches=dict(
              mla_decode=mla.mla_decode_attend.launches,
              mla_prefill=mla.mla_flash_attention.launches,
              routed_experts=moe_experts.routed_experts.launches),
          steps=steps, touched_per_layer_step=float(
              diff[:, 0].sum() / max(steps, 1) / diff.shape[0]),
          pairs_per_step=float(diff[:, 1].sum() / max(steps, 1)),
          gaps=gaps, memory_peak_gb=torch.cuda.max_memory_allocated() / 1e9)


def step(n_steps, seed):
    from torch.profiler import ProfilerActivity, profile

    from acxbench import harness
    from mpi_acx_torch.models import serving
    bench = harness.Bench()
    cfg = bench.config("deepseek-v2-lite")
    fam = bench.family(cfg["family"])
    pcfg = fam.port_config(cfg, torch.bfloat16)
    params = fam.draw_params(cfg, seed, "cuda", torch.bfloat16)
    module = fam.port_module()
    cache = serving.seat_slots(module.init_kv_cache(pcfg, 64, 4096,
                                                    device="cuda"))
    g = torch.Generator(device="cuda").manual_seed(seed)
    cache["k"].normal_(0, 1, generator=g)
    cache["pos"].copy_(torch.randint(200, 400, (64,), generator=g,
                                     device="cuda", dtype=torch.int32))
    tok = torch.randint(0, pcfg.vocab, (64,), generator=g, device="cuda")
    for _ in range(3):
        module.decode_step(params, pcfg, cache, tok)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            module.decode_step(params, pcfg, cache, tok)
        torch.cuda.synchronize()
    tot, count = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            name = ev.name()[:80]
            tot[name] = tot.get(name, 0) + ev.duration_ns()
            count[name] = count.get(name, 0) + 1
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:25]
    _emit("STEP", steps=n_steps, device_ms_per_step=sum(tot.values())
          / 1e6 / n_steps, ops_per_step=sum(count.values()) / n_steps,
          graphs=dict(captures=cache.graphs.captures,
                      replayed=cache.graphs.replayed),
          top=[[k, v / 1e6 / n_steps, count[k] / n_steps] for k, v in top])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("kernels", "serve", "step"))
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--requests", type=int, default=96)
    ap.add_argument("--seed", type=int, default=2024)
    args = ap.parse_args()
    _fixed_caches()
    print(f"card: {_card()}", flush=True)
    print("torch", torch.__version__, torch.version.cuda, flush=True)
    if args.what == "kernels":
        kernels()
    elif args.what == "serve":
        serve(args.requests, args.seed)
    else:
        step(args.steps, args.seed)


if __name__ == "__main__":
    main()
