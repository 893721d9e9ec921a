"""One fleet rank of the port's disaggregated prefill/decode serving.

Run under acxrun with roles from ``ACX_ROLE``::

    ACX_ROLE=prefill,decode build/acxrun -np 2 [-transport socket] \\
        python tests/torch_disagg_worker.py --device cpu [options]

Every rank builds the same weights and requests. The prefill rank ships
per-layer KV handoffs (``serve_disagg_greedy``); the decode rank splices
them into fixed slots (``serve_disagg_greedy``) or into the paged pool
(``run_decode_worker(page_tokens=...)``), generates, then holds its outputs
bit for bit to a local ``serve_greedy(..., kv_int8=True)`` of the same
requests. Prints ``DISAGG_OK`` (decode) or ``DISAGG_SHIPPED`` (prefill),
one ``DISAGG_ROW {json}`` and one ``LAUNCHES {json}`` (the attention
kernels launched during the disagg serve, counted from 0 just before it)
per rank.

Options: ``--device`` (``cuda`` runs the kernels), ``--no-overlap`` (ship
only after the full prompt pass), ``--prefill-int8`` (the
quantize-at-compute prefill variant), ``--page-tokens N`` (a paged decode
rank), ``--full-width`` (GPT-2 124M in bf16, seed 0, prompts of 32-512
tokens; otherwise a tiny f32 configuration), ``--requests N``.

``--jax-rank R`` makes rank R a prefill rank of the JAX package
(mpi_acx_tpu) on the CPU: the two packages meet on one wire. Both ranks then
use the JAX tiny configuration's init (key 0), which the port's rank takes
through ``params_from_jax``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

TINY = dict(vocab=512, d_model=128, n_heads=4, n_layers=4, d_ff=512,
            max_seq=128)
# (prompt lengths, new tokens, max_len, slots, chunk) of each size.
TINY_LOAD = ([5, 11, 3, 17, 8, 13, 7, 21, 4, 9], [3, 4, 5, 6, 7], 64, 2, 1)
FULL_LOAD = ([32, 128, 256, 512], [16, 64, 128, 32], 1024, 4, 8)
COUNTERS = (("flash_attention", "flash_attention", "launches"),
            ("flash_decode_attend", "flash_decode_attend", "launches"),
            ("flash_decode_attend_int8", "flash_decode_attend",
             "launches_int8"),
            ("paged_flash_decode_attend", "paged_flash_decode_attend",
             "launches"),
            ("paged_flash_decode_attend_int8", "paged_flash_decode_attend",
             "launches_int8"))


def workload(args, vocab):
    lens, news, max_len, n_slots, chunk = (FULL_LOAD if args.full_width
                                           else TINY_LOAD)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, vocab, size=lens[i % len(lens)])
               .astype(np.int32) for i in range(args.requests)]
    n_new = [news[i % len(news)] for i in range(args.requests)]
    return prompts, n_new, max_len, n_slots, chunk


def jax_weights():
    """The JAX tiny configuration's f32 init (key 0) as numpy."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import jax.numpy as jnp
    from mpi_acx_tpu.models import transformer as jt
    cfg = dataclasses.replace(jt.tiny_config(**TINY), dtype=jnp.float32)
    return cfg, jt.init_params(jax.random.key(0), cfg)


def jax_prefill_rank(args) -> int:
    """Rank ``--jax-rank``: the JAX package's prefill worker."""
    cfg, params = jax_weights()
    from mpi_acx_tpu import runtime
    from mpi_acx_tpu.models.disagg import serve_disagg_greedy
    prompts, n_new, max_len, n_slots, chunk = workload(args, cfg.vocab)
    rt = runtime.Runtime()
    rt.set_deadline(60_000)
    rt.barrier()                 # the port's rank warms up before this
    t0 = time.perf_counter()
    serve_disagg_greedy(params, cfg, prompts, n_new, n_slots=n_slots,
                        max_len=max_len, chunk=chunk, rt=rt,
                        overlap=args.overlap,
                        prefill_kv_int8=args.prefill_int8)
    print(f"DISAGG_SHIPPED rank={rt.rank} n={len(prompts)} package=jax",
          flush=True)
    print("DISAGG_ROW " + json.dumps({
        "rank": rt.rank, "role": "prefill", "package": "jax",
        "wall_s": time.perf_counter() - t0}), flush=True)
    rt.barrier()
    rt.finalize()
    return 0


def port_weights(args, dev):
    import torch
    from mpi_acx_torch.models import transformer as tt
    if args.jax_rank is not None:
        import jax
        _, jparams = jax_weights()
        cfg = dataclasses.replace(tt.tiny_config(**TINY),
                                  dtype=torch.float32)
        return cfg, tt.params_from_jax(jax.device_get(jparams), device=dev)
    if args.full_width:
        cfg = tt.gpt2_small()
        f32 = dataclasses.replace(cfg, dtype=torch.float32)
        return cfg, tt.cast_params(tt.init_params(f32, seed=0, device=dev),
                                   torch.bfloat16)
    cfg = dataclasses.replace(tt.tiny_config(**TINY), dtype=torch.float32)
    return cfg, tt.init_params(cfg, seed=0, device=dev)


def launches():
    from mpi_acx_torch.ops import attention, flash_decode
    mods = {"flash_attention": attention.flash_attention,
            "flash_decode_attend": flash_decode.flash_decode_attend,
            "paged_flash_decode_attend":
                flash_decode.paged_flash_decode_attend}
    return {name: getattr(mods[fn], attr) for name, fn, attr in COUNTERS}


def reset_launches():
    from mpi_acx_torch.ops import attention, flash_decode
    mods = {"flash_attention": attention.flash_attention,
            "flash_decode_attend": flash_decode.flash_decode_attend,
            "paged_flash_decode_attend":
                flash_decode.paged_flash_decode_attend}
    for _, fn, attr in COUNTERS:
        setattr(mods[fn], attr, 0)


def sync(dev):
    import torch
    if dev == "cuda":
        torch.cuda.synchronize()


def port_rank(args) -> int:
    from mpi_acx_torch import runtime
    from mpi_acx_torch.models import transformer as tt
    from mpi_acx_torch.models.disagg import (fleet_roles, run_decode_worker,
                                             serve_disagg_greedy)
    from mpi_acx_torch.models.serving import make_server_fns, serve_greedy
    dev = args.device
    cfg, params = port_weights(args, dev)
    prompts, n_new, max_len, n_slots, chunk = workload(args, cfg.vocab)
    rt = runtime.Runtime()
    # A torn fleet must surface as a typed error, not a block forever.
    rt.set_deadline(120_000)
    role = fleet_roles(rt.size)[rt.rank]
    fns = make_server_fns(params, cfg, tt, chunk=chunk, kv_int8=True)
    if dev == "cuda":
        # Warm-up outside the count: library load, cuBLAS, allocator pools.
        serve_greedy(params, cfg, prompts[:1], 2, n_slots=n_slots,
                     max_len=max_len, chunk=chunk, kv_int8=True,
                     server_fns=fns, device=dev)
    sync(dev)
    rt.barrier()
    reset_launches()
    t0 = time.perf_counter()
    kw = dict(n_slots=n_slots, max_len=max_len, chunk=chunk, device=dev)
    if role == "decode" and args.page_tokens:
        batch = run_decode_worker(rt, params, cfg, prompts, n_new,
                                  page_tokens=args.page_tokens, **kw)
    else:
        batch = serve_disagg_greedy(
            params, cfg, prompts, n_new, server_fns=fns, rt=rt,
            overlap=args.overlap, prefill_kv_int8=args.prefill_int8, **kw)
    sync(dev)
    wall = time.perf_counter() - t0
    counts = launches()
    print(f"LAUNCHES {json.dumps(counts)}", flush=True)
    row = {"rank": rt.rank, "role": role, "package": "torch", "device": dev,
           "wall_s": wall, "overlap": args.overlap,
           "prefill_int8": args.prefill_int8,
           "page_tokens": args.page_tokens}
    if role == "prefill":
        print(f"DISAGG_SHIPPED rank={rt.rank} n={len(prompts)} "
              "package=torch", flush=True)
    else:
        mono = serve_greedy(params, cfg, prompts, n_new, kv_int8=True,
                            server_fns=fns, **kw)
        m = batch.metrics
        mine = [r.rid for r in m.per_request]
        if not mine:
            raise RuntimeError("decode rank owns no requests")
        for rid in mine:
            if batch[rid] is None or not np.array_equal(batch[rid],
                                                        mono[rid]):
                raise RuntimeError(f"rank {rt.rank} request {rid}: disagg "
                                   f"{batch[rid]} != monolithic {mono[rid]}")
        hs = m.handoffs
        row.update(
            requests=len(mine), new_tokens=m.new_tokens,
            tokens_per_s=m.tokens_per_s, ttft_p50_s=m.ttft_p50_s,
            itl_p50_s=m.itl_p50_s,
            prefill_p50_s=m.handoff_prefill_p50_s,
            pickup_p50_s=m.handoff_pickup_p50_s,
            expose_p50_s=sorted(h.expose_s for h in hs)[len(hs) // 2],
            handoff_wire_bytes=sum(h.wire_bytes for h in hs),
            requeues=m.requeues, peer_requeues=m.peer_requeues)
        print(f"DISAGG_OK rank={rt.rank} rids={mine} requeues={m.requeues} "
              f"peer_requeues={m.peer_requeues}", flush=True)
    print("DISAGG_ROW " + json.dumps(row), flush=True)
    rt.barrier()
    rt.finalize()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overlap", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--prefill-int8", action="store_true")
    ap.add_argument("--page-tokens", type=int, default=None)
    ap.add_argument("--full-width", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--jax-rank", type=int, default=None)
    args = ap.parse_args()
    if args.jax_rank is not None and args.full_width:
        ap.error("--jax-rank runs the tiny configuration")
    if int(os.environ["ACX_RANK"]) == args.jax_rank:
        return jax_prefill_rank(args)
    return port_rank(args)


if __name__ == "__main__":
    sys.exit(main())
