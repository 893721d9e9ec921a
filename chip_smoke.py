#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpi_acx_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (one card, no
arguments). It imports nothing of JAX and needs nothing beyond the sources
in the repository. Phases, each of which exits non-zero on failure:

1. build   — compile the CUDA kernels in mpi_acx_torch/csrc/ for sm_90a
             (one nvcc per source, in parallel) into build/torch_kernels/.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's shapes, in bf16 and f32: max abs error
             and row errors within TOL_ABS, TOL_ROW, TOL_ROW_F32.
3. f32     — GPT-2 124M at full width in float32 served through the kernels
             and through the plain versions: the tokens must be equal (a
             divergence passes only at a true tie, see TIE), and the two
             paths' logits over the served sequences within TIE.
4. serve   — GPT-2 124M in bf16, 16 requests through 8 slots (max_len
             1024, chunk 8): every request gets its tokens, tokens/s, TTFT
             and ITL are printed, and both kernels must have launched. The
             same requests then go through the plain versions, held to the
             kernel path's tokens and logits as in phase 3.
5. timing  — each kernel, its plain version, the equivalent PyTorch
             library call and the roofline bound at the phase-4 shapes
             (device time: the calls are replayed from a CUDA graph), and
             one decode step as the server issues it against its device
             time (the device's busy share of a step).
6. flags   — the flag kernels B1-B5 (csrc/flags.cu) against their plain
             versions with exact equality over tables of 1 to 4096 slots,
             indices in and out of range, repeated, as ints and as tensors
             on the card, and B5's payload bit for bit at 8x128 and at the
             4 MiB partition; then each timed by CUDA-graph replay beside
             its plain version and its one-call PyTorch equivalent.
7. exchange — `make lib tools`, then two ranks on the card under
             build/acxrun: 64 MiB of f32 in 16 partitions produced and
             flagged by the kernels, published through stream triggers,
             polled by B3/B4 on the receiver and checked value by value
             there (GB/s per publish mode, best of 3 sets of 20 rounds);
             the in-program twin; the 8-byte triggered ping-pong on CUDA
             tensors; and build/bench_pingpong, the host plane alone, for
             comparison in the same run. Every flag kernel must launch.
8. the kernels line (JSON), the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# Kernel vs plain version, three limits per case. f32: both sides compute
# in true f32 (TF32 off); they differ in summation order and the
# online-softmax rescaling. bf16: the plain version rounds the logits to
# bf16 where the kernel keeps them in f32 (the JAX package's kernel/reference
# split).
#  * TOL_ABS, the max abs error. bf16's 4e-2 is the JAX package's own bf16
#    decode parity limit. Alone it is blind on long rows: their outputs are
#    means over many keys, with an RMS near sqrt(e / keys) (about 0.05 at a
#    thousand keys), so a key dropped from a long row moves them by less.
#  * TOL_ROW, the row error against the plain version in the same dtype:
#    the largest |kernel - plain| in an output row (one query row and head,
#    D values) over that row's RMS in an f32 plain run on the same inputs
#    (bf16 inputs widened, not re-drawn).
#  * TOL_ROW_F32, the same row error against that f32 plain run.
# Readings on an H100 over the phase-2 cases (bf16): row error 2.0-4.5e-2
# against the bf16 plain version, whose own row error against f32 is
# 1.5-4.4e-2, and 1.0-1.5e-2 against f32; f32: at most 7.3e-6. The bf16
# limits are about twice the largest reading. A dropped key tile reads
# 0.86-2.1.
TOL_ABS = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
TOL_ROW = {torch.float32: 1e-4, torch.bfloat16: 8e-2}
TOL_ROW_F32 = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# A served token that differs between the kernel path and the plain path is
# a tie when the plain path's logits of the two tokens differ by less than
# TIE (recomputed by a forward pass over the common prefix). The two paths'
# logits over the served sequences must also agree within TIE. Readings on
# an H100: logits differ by at most 3.1e-6 (f32) and 3.9e-2 (bf16); the
# three bf16 divergences of phase 4 sit at margins up to 9.4e-3.
TIE = {torch.float32: 1e-4, torch.bfloat16: 8e-2}
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core and f32 FMA
# rates, HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
H, D = 12, 64           # GPT-2 124M heads and head dim
ROOT = Path(__file__).resolve().parent


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 100) -> float:
    """Mean device time of one ``fn`` call: ``iters`` calls captured in a
    CUDA graph and replayed between two CUDA events, so the Python cost of
    issuing each call (tens of microseconds, more than a decode kernel
    runs) is not in the number. Warmed up on a side stream first."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def randn(shape, dtype, gen):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


# --- phase 1 ---------------------------------------------------------------

def phase_build() -> float:
    from mpi_acx_torch.ops import _build
    t0 = time.perf_counter()
    _build.lib()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.1f} s ({len(_build.SOURCES)} sources, nvcc "
          f"{' '.join(_build.NVCC_FLAGS[:2])}, one process per source)",
          flush=True)
    return dt


# --- phase 2 ---------------------------------------------------------------

def errors(out, ref, ref32) -> dict:
    """Errors of ``out`` (kernel) against ``ref`` (plain version, same
    dtype) and ``ref32`` (plain version in f32 on the same inputs), over
    output rows of D values: max abs error, row error against each, and the
    plain version's own row error against f32 (what bf16 costs it)."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"kernel output: shape {tuple(out.shape)}, plain "
             f"{tuple(ref.shape)}, or non-finite values")
    o, r, r32 = (x.float().reshape(-1, D) for x in (out, ref, ref32))
    rms = r32.square().mean(-1).sqrt()

    def row(a, b):
        return ((a - b).abs().amax(-1) / rms).max().item()
    return {"abs": (o - r).abs().max().item(), "row": row(o, r),
            "row_f32": row(o, r32), "plain_row_f32": row(r, r32)}


def check(name, desc, dtype, e) -> None:
    print(f"kernel {name} {str(dtype)[6:]} {desc}: max_abs_err "
          f"{e['abs']:.3e} (tol {TOL_ABS[dtype]}), row err {e['row']:.3e} "
          f"vs plain (tol {TOL_ROW[dtype]}), {e['row_f32']:.3e} vs f32 "
          f"plain (tol {TOL_ROW_F32[dtype]}); plain's own row err vs f32 "
          f"{e['plain_row_f32']:.3e}", flush=True)
    if not (e["abs"] <= TOL_ABS[dtype] and e["row"] <= TOL_ROW[dtype]
            and e["row_f32"] <= TOL_ROW_F32[dtype]):
        fail(f"{name} disagrees with its plain version")


def k1_errs(S, Sk, causal, dtype, gen):
    from mpi_acx_torch.ops.attention import attention_reference, \
        flash_attention
    q = randn((1, S, H, D), dtype, gen)
    k = randn((1, Sk, H, D), dtype, gen)
    v = randn((1, Sk, H, D), dtype, gen)
    out = flash_attention(q, k, v, causal=causal)
    ref = attention_reference(q, k, v, causal=causal)
    ref32 = attention_reference(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    return errors(out, ref, ref32)


def k2_errs(B, W, n_rep, pos, dtype, gen, max_len=1024):
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    Hkv = H // n_rep
    q = randn((B, W, H, D), dtype, gen)
    kc = randn((B, max_len, Hkv, D), dtype, gen)
    vc = randn((B, max_len, Hkv, D), dtype, gen)
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    out = flash_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    ref = dense_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    ref32 = dense_decode_attend(q.float(), kc.float(), vc.float(), pos_t,
                                max_len, n_rep)
    torch.cuda.synchronize()
    return errors(out, ref, ref32)


def phase_kernels() -> dict:
    """Worst errors per kernel and dtype over the slice's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}

    def keep(name, dtype, e):
        w = worst.setdefault((name, dtype), dict.fromkeys(e, 0.0))
        for key, val in e.items():
            w[key] = max(w[key], val)

    slot_pos = [0, 63, 64, 500, 1023, 1, 255, 777]
    for dtype in (torch.bfloat16, torch.float32):
        cases1 = [(S, S, True) for S in (8, 200, 512, 1024)]
        cases1.append((200, 333, False))
        for S, Sk, causal in cases1:
            e = k1_errs(S, Sk, causal, dtype, gen)
            check("flash_attention", f"B=1 S={S} Sk={Sk} causal={causal} "
                  f"H={H} D={D}", dtype, e)
            keep("flash_attention", dtype, e)
        cases2 = [(1, 1, slot_pos), (1, 1, 300),
                  (3, 2, [0, 63, 64, 500, 1021, 5, 255, 777])]
        for W, n_rep, pos in cases2:
            e = k2_errs(8, W, n_rep, pos, dtype, gen)
            check("flash_decode_attend", f"B=8 W={W} n_rep={n_rep} Hq={H} "
                  f"D={D} max_len=1024 pos={pos}", dtype, e)
            keep("flash_decode_attend", dtype, e)
    return worst


# --- phases 3 and 4 --------------------------------------------------------

def reset_counts():
    from mpi_acx_torch.ops.attention import flash_attention
    from mpi_acx_torch.ops.flash_decode import flash_decode_attend
    flash_attention.launches = 0
    flash_decode_attend.launches = 0


def read_counts():
    from mpi_acx_torch.ops.attention import flash_attention
    from mpi_acx_torch.ops.flash_decode import flash_decode_attend
    return {"flash_attention": flash_attention.launches,
            "flash_decode_attend": flash_decode_attend.launches}


def compare_paths(label, params, cfg, got, want, prompts) -> None:
    """Hold the kernel path's served tokens (``got``) to the plain path's
    (``want``). A divergence passes only at a tie: the plain path's logits
    of the two tokens at that step, recomputed by a plain forward pass over
    the common prefix, differ by less than TIE. Then the two paths' logits
    over every served sequence (forward passes, so K1 at every length the
    sequences reach) must agree within TIE."""
    from mpi_acx_torch.models import serving, transformer as tfm
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    tie = TIE[cfg.dtype]
    ties, spread = [], 0.0
    for rid, (g, w) in enumerate(zip(got, want)):
        for o in (g, w):
            if isinstance(o, serving.RequestRejected):
                fail(f"{label} request {rid} rejected: {o.detail}")
        if not np.array_equal(g, w):
            t = int(np.argmax(g != w))      # first differing position
            ctx = torch.as_tensor(w[:t], device="cuda")[None]
            lp = tfm.forward(params, plain, ctx)[0, -1]
            margin = (lp[int(w[t])] - lp[int(g[t])]).item()
            print(f"{label} request {rid}: tokens diverge at position {t} "
                  f"of {len(w)} (kernel {g[t]}, plain {w[t]}): plain logit "
                  f"margin {margin:.4e} (tie below {tie})", flush=True)
            if not abs(margin) < tie:
                fail(f"{label} request {rid}: divergence at a logit margin "
                     f"{margin:.4e}, not a tie")
            ties.append(rid)
        seq = torch.as_tensor(w[:-1], device="cuda")[None]
        lk = tfm.forward(params, cfg, seq)[0, len(prompts[rid]) - 1:]
        lp = tfm.forward(params, plain, seq)[0, len(prompts[rid]) - 1:]
        spread = max(spread, (lk - lp).abs().max().item())
    print(f"{label}: kernel path vs plain path: tokens equal in "
          f"{len(got) - len(ties)} of {len(got)} requests, ties in {ties}; "
          f"max |logit difference| over the served positions "
          f"{spread:.4e} (tol {tie})", flush=True)
    if not spread < tie:
        fail(f"{label}: kernel-path logits differ from the plain path's by "
             f"{spread:.4e}")


def phase_f32(params32):
    from mpi_acx_torch.models import serving, transformer as tfm
    cfg = dataclasses.replace(tfm.gpt2_small(), dtype=torch.float32)
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    rng = np.random.default_rng(1)
    lens = [16, 40, 64, 100, 23, 77, 50, 128]
    n_new = [8, 16, 12, 20, 8, 16, 12, 20]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    reset_counts()
    got = serving.serve_greedy(params32, cfg, prompts, n_new, n_slots=3,
                               max_len=256, chunk=4)
    counts = read_counts()
    want = serving.serve_greedy(params32, plain, prompts, n_new, n_slots=3,
                                max_len=256, chunk=4)
    if min(counts.values()) == 0:
        fail(f"f32 kernel serve did not launch every kernel: {counts}")
    if got.metrics.requeues or want.metrics.requeues:
        fail("f32 serve requeued a request after a failed step")
    compare_paths("f32 serve (8 requests, 3 slots, GPT-2 124M full width)",
                  params32, cfg, got, want, prompts)
    print(f"f32 serve launches {counts}", flush=True)


def phase_serve(params16, card_str):
    from mpi_acx_torch.models import serving, transformer as tfm
    cfg = tfm.gpt2_small()
    rng = np.random.default_rng(2)
    lens = [32, 128, 256, 512]
    news = [16, 64, 128, 32]
    prompts = [rng.integers(0, cfg.vocab, lens[i % 4]).astype(np.int32)
               for i in range(16)]
    n_new = [news[i % 4] for i in range(16)]
    # Warm-up: library load, cuBLAS handles and allocator pools.
    serving.serve_greedy(params16, cfg, prompts[:2], 4, n_slots=8,
                         max_len=1024, chunk=8)
    torch.cuda.synchronize()
    reset_counts()
    res = serving.serve_greedy(params16, cfg, prompts, n_new, n_slots=8,
                               max_len=1024, chunk=8)
    torch.cuda.synchronize()
    counts = read_counts()
    m = res.metrics
    for rid, (o, p, n) in enumerate(zip(res, prompts, n_new)):
        if isinstance(o, serving.RequestRejected):
            fail(f"bf16 request {rid} rejected: {o.detail}")
        gen = o[len(p):]
        if (len(o) != len(p) + n or not np.array_equal(o[:len(p)], p)
                or gen.min() < 0 or gen.max() >= cfg.vocab):
            fail(f"bf16 request {rid}: wrong output ({len(o)} tokens)")
    if m.requeues or m.rejections:
        fail(f"bf16 serve requeued {m.requeues}, rejected {m.rejections}")
    print(f"serve bf16 GPT-2 124M: 16 requests, 8 slots, max_len 1024, "
          f"chunk 8: {m.new_tokens} tokens in {m.wall_s:.3f} s = "
          f"{m.tokens_per_s:.1f} tokens/s, TTFT p50 {m.ttft_p50_s * 1e3:.2f} "
          f"ms, ITL p50 {m.itl_p50_s * 1e3:.3f} ms, {m.steps} steps "
          f"[{card_str}]", flush=True)
    print(f"launches during serve: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        fail(f"a kernel of the serving path never launched: {counts}")
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    want = serving.serve_greedy(params16, plain, prompts, n_new, n_slots=8,
                                max_len=1024, chunk=8)
    compare_paths("bf16 serve (16 requests, 8 slots)", params16, cfg, res,
                  want, prompts)
    return counts


# --- phase 5 ---------------------------------------------------------------

def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


def phase_timing(card_str) -> dict:
    import torch.nn.functional as F
    from mpi_acx_torch.ops.attention import attention_reference, \
        flash_attention
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    out = {}

    # K1 at the four prefill buckets of phase 4 (4 prefills each, so the
    # mean over the buckets is the mean per launch on that path).
    rows = []
    for S in (32, 128, 256, 512):
        q, k, v = (randn((1, S, H, D), bf, gen) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t_k = time_ms(lambda: flash_attention(q, k, v))
        t_p = time_ms(lambda: attention_reference(q, k, v))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4 * H * D * S * (S + 1) / 2
        nbytes = 4 * S * H * D * 2
        b_ms, b_by = bound_ms(flops, nbytes, bf)
        rows.append((t_k, t_p, t_l, flops, nbytes))
        print(f"time flash_attention bf16 B=1 S={S} H={H} D={D} causal: "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library (sdpa) "
              f"{t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}) [{card_str}]",
              flush=True)
    mean = np.mean(rows, axis=0)
    b_ms, b_by = bound_ms(mean[3], mean[4], bf)
    out["flash_attention"] = dict(ms=mean[0], plain_ms=mean[1],
                                  library_ms=mean[2], bound_ms=b_ms,
                                  bound_by=b_by)

    # K2 at the phase-4 decode shape: 8 slots at mid-request positions,
    # rotating over 12 layers' caches so each call finds its cache cold in
    # L2, as the decode step does.
    B, max_len, L = 8, 1024, 12
    pos_l = [40, 160, 320, 528, 40, 160, 320, 528]
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    q = randn((B, 1, H, D), bf, gen)
    kc = randn((L, B, max_len, H, D), bf, gen)
    vc = randn((L, B, max_len, H, D), bf, gen)
    kt, vt = kc.transpose(2, 3).contiguous(), vc.transpose(2, 3).contiguous()
    qt = q.transpose(1, 2).contiguous()
    mask = (torch.arange(max_len, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    it = iter(range(10 ** 9))

    def run(fn):
        return lambda: fn(next(it) % L)

    t_k = time_ms(run(lambda i: flash_decode_attend(q, kc[i], vc[i], pos,
                                                    max_len, 1)), iters=240)
    t_p = time_ms(run(lambda i: dense_decode_attend(q, kc[i], vc[i], pos,
                                                    max_len, 1)), iters=240)
    t_l = time_ms(run(lambda i: F.scaled_dot_product_attention(
        qt, kt[i], vt[i], attn_mask=mask)), iters=240)
    live = sum(min(p + 1, max_len) for p in pos_l)
    nbytes = live * H * D * 2 * 2 + 2 * B * H * D * 2 + B * 4
    b_ms, b_by = bound_ms(4 * live * H * D, nbytes, bf)
    print(f"time flash_decode_attend bf16 B={B} W=1 H={H} D={D} max_len="
          f"{max_len} pos={pos_l}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"library (sdpa, length mask) {t_l:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}) [{card_str}]", flush=True)
    out["flash_decode_attend"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                      bound_ms=b_ms, bound_by=b_by)
    return out


def phase_step(params16, k2_ms, card_str) -> None:
    """One batched decode step at the phase-4 shape (8 slots at mid-request
    positions): as the server issues it (eager, host clock around steps
    that end in a synchronize) against its device time (the same step
    replayed from a CUDA graph). Their ratio is the device's busy share of
    a served decode step; 12 K2 calls are its attention."""
    from mpi_acx_torch.models import transformer as tfm
    cfg = tfm.gpt2_small()
    gen = torch.Generator(device="cuda").manual_seed(4)
    cache = tfm.init_kv_cache(cfg, 8, 1024)
    for key in ("k", "v"):
        cache[key].normal_(generator=gen)
    cache["pos"] = torch.tensor([40, 160, 320, 528] * 2, dtype=torch.int32,
                                device="cuda")
    tok = torch.randint(0, cfg.vocab, (8,), generator=gen, device="cuda",
                        dtype=torch.int32)

    def step():
        return tfm.decode_step(params16, cfg, cache, tok)

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / n * 1e3
    dev_ms = time_ms(step, iters=10)
    print(f"decode step bf16 GPT-2 124M B=8 max_len=1024: host-issued "
          f"{host_ms:.3f} ms, device {dev_ms:.3f} ms (graph replay): device "
          f"busy {100 * dev_ms / host_ms:.1f}% of the eager step; decode "
          f"attention 12 x {k2_ms:.4f} ms = {100 * 12 * k2_ms / dev_ms:.1f}% "
          f"of device time [{card_str}]", flush=True)


# --- phase 6 ---------------------------------------------------------------

FLAG_KERNELS = ("pready", "pready_many", "parrived", "parrived_all",
                "produce_and_pready")


def same(a, b) -> bool:
    """Exact equality, bit for bit for floats (NaN-safe)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and torch.equal(a, b)


def phase_flags() -> dict:
    """B1-B5 against their plain versions on the card, with exact equality
    (int32 tables, 0/1 polls, f32 payloads bit for bit): tables of n = 1,
    16, 1000, 4096 slots in random states 0-5; indices in range, outside
    it (both sides, and past int32 as a Python int) and repeated; each
    single index as a Python int and as a 0-d int32 tensor on the card; B5
    at 8x128 and at the exchange's 4 MiB partition (1024x1024 f32) with
    each producer the card has. Returns the max abs error and the number
    of cases per kernel."""
    from mpi_acx_torch.ops import flags as fl
    kern = dict(zip(FLAG_KERNELS, fl.select_flags(True)))
    plain = dict(zip(FLAG_KERNELS, fl.select_flags(False)))
    rng = np.random.default_rng(6)
    res = {name: {"abs": 0.0, "cases": 0} for name in FLAG_KERNELS}

    def hold(name, got, want, desc):
        for g, w in zip(got, want):
            if not same(g, w):
                fail(f"{name} {desc}: kernel {g.flatten()[:8].tolist()} != "
                     f"plain {w.flatten()[:8].tolist()}")
            err = (g.double() - w.double()).abs().max().item() if g.numel() \
                else 0.0
            res[name]["abs"] = max(res[name]["abs"], err)
        res[name]["cases"] += 1

    def cuda_i32(v):
        return torch.tensor(v, dtype=torch.int32, device="cuda")

    for n in (1, 16, 1000, 4096):
        for trial in range(2):
            table = cuda_i32(rng.integers(0, 6, n))
            singles = sorted({0, n - 1, n // 2, int(rng.integers(0, n)), -1,
                              n, n + 5, 1023, 4096, -100, 2 ** 31 - 1,
                              -2 ** 31})
            for idx in singles + [2 ** 40]:
                forms = [idx] if idx == 2 ** 40 else [idx, cuda_i32(idx)]
                for i in forms:
                    desc = f"n={n} idx={idx} ({type(i).__name__})"
                    hold("pready", [kern["pready"](table.clone(), i)],
                         [plain["pready"](table.clone(), i)], desc)
                    hold("parrived", [kern["parrived"](table, i)],
                         [plain["parrived"](table, i)], desc)
            lists = [[], list(range(n)), [n // 2] * 5 + [0, 0],
                     [-1, n, 0, n + 300, n - 1],
                     rng.integers(-3, n + 3, 64).tolist()]
            for idxs in lists:
                it = cuda_i32(idxs)
                desc = f"n={n} idxs[{len(idxs)}]={idxs[:6]}"
                hold("pready_many", [kern["pready_many"](table.clone(), it)],
                     [plain["pready_many"](table.clone(), it)], desc)
                hold("parrived_all", [kern["parrived_all"](table, it)],
                     [plain["parrived_all"](table, it)], desc)
            # Tables that are all COMPLETED, so parrived_all reads 1.
            done = torch.full_like(table, fl.COMPLETED)
            for idxs in lists[:3]:
                it = cuda_i32(idxs)
                hold("parrived_all", [kern["parrived_all"](done, it)],
                     [plain["parrived_all"](done, it)], f"n={n} completed")
    gen = torch.Generator(device="cuda").manual_seed(6)
    for shape in ((8, 128), (1024, 1024)):
        x = torch.randn(shape, generator=gen, device="cuda") * 100
        table = cuda_i32(rng.integers(0, 6, 16))
        for produce in (fl.Affine(2.0, 1.0), fl.Affine(-0.37, 5.25),
                        fl.identity):
            for idx in (5, cuda_i32(15), 16, -1):
                desc = f"x {shape} idx={idx}"
                pk, fk = kern["produce_and_pready"](produce, x, table.clone(),
                                                    idx)
                pp, fp = plain["produce_and_pready"](produce, x,
                                                     table.clone(), idx)
                hold("produce_and_pready", [pk, fk], [pp, fp], desc)
    torch.cuda.synchronize()
    for name in FLAG_KERNELS:
        print(f"kernel {name}: {res[name]['cases']} cases equal to the plain "
              f"version exactly (max_abs_err {res[name]['abs']:.1f})",
              flush=True)
    return res


def phase_flag_timing(card_str) -> dict:
    """B1-B5, their plain versions and the one-call PyTorch equivalents at
    the exchange path's shapes (a 16-slot table, 16 indices, a 4 MiB f32
    partition), by CUDA-graph replay. The bound counts the bytes each call
    must move: the index words read, the flag words written or read, the
    0/1 result, and for B5 the payload read and written."""
    from mpi_acx_torch.ops import flags as fl
    gen = torch.Generator(device="cuda").manual_seed(7)
    table = torch.full((16,), fl.RESERVED, dtype=torch.int32, device="cuda")
    idxs = torch.arange(16, dtype=torch.int32, device="cuda")
    idxs64 = idxs.long()
    x = torch.randn((1024, 1024), generator=gen, device="cuda")
    produce = fl.Affine(2.0, 1.0)
    cases = {
        "pready": (lambda: fl.pready(table, 5),
                   lambda: fl.pready_reference(table, 5),
                   lambda: table[5].fill_(fl.PENDING), 4),
        "pready_many": (lambda: fl.pready_many(table, idxs),
                        lambda: fl.pready_many_reference(table, idxs),
                        lambda: table.index_fill_(0, idxs64, fl.PENDING),
                        16 * 4 * 2),
        "parrived": (lambda: fl.parrived(table, 5),
                     lambda: fl.parrived_reference(table, 5),
                     lambda: (table[5] == fl.COMPLETED).int(), 4 + 4),
        "parrived_all": (lambda: fl.parrived_all(table, idxs),
                         lambda: fl.parrived_all_reference(table, idxs),
                         lambda: (table[idxs] == fl.COMPLETED).all(),
                         16 * 4 * 2 + 4),
        "produce_and_pready": (
            lambda: fl.produce_and_pready(produce, x, table, 5),
            lambda: fl.produce_and_pready_reference(produce, x, table, 5),
            None, 2 * x.numel() * 4 + 4),
    }
    out = {}
    for name, (k_fn, p_fn, l_fn, nbytes) in cases.items():
        t_k = time_ms(k_fn)
        t_p = time_ms(p_fn)
        t_l = time_ms(l_fn) if l_fn is not None else None
        b_ms, b_by = bound_ms(0, nbytes, torch.float32)
        print(f"time {name}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library {'-' if t_l is None else f'{t_l:.4f} ms'}, bound "
              f"{b_ms:.6f} ms ({b_by}, {nbytes} bytes) [{card_str}]",
              flush=True)
        out[name] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                         bound_ms=b_ms, bound_by=b_by)
    return out


# --- phase 7 ---------------------------------------------------------------

# The exchange at build/bench_pingpong's size: 64 MiB of f32 in 16
# partitions of 1024x1024, best of 3 sets of 20 rounds, per publish mode.
PARTS, PART_SHAPE, SETS, ROUNDS = 16, (1024, 1024), 3, 20
PINGPONG_ITERS = 2000
RANK_TIMEOUT_S = 300


def run_ranks(args, label) -> str:
    """``build/acxrun -np 2`` on ``args``; fails the run unless both ranks
    exit 0. Returns their standard output."""
    cmd = [str(ROOT / "build" / "acxrun"), "-np", "2", "-timeout",
           str(RANK_TIMEOUT_S), *map(str, args)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=RANK_TIMEOUT_S + 60)
    except subprocess.TimeoutExpired:
        fail(f"{label}: acxrun outlived its timeout")
    if res.returncode != 0:
        fail(f"{label}: exit {res.returncode}\n{res.stdout[-4000:]}\n"
             f"{res.stderr[-4000:]}")
    print(f"{label}: both ranks exit 0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res.stdout


def field(out, tag, key) -> float:
    """The number after ``key=`` in the rank output's ``tag`` record (the
    ranks share one pipe, so a record may not start a line)."""
    m = re.search(rf"{tag}\b[^\n]*?\b{key}=([-\d.]+)", out)
    if m is None:
        fail(f"no {tag} {key}= in the ranks' output\n{out}")
    return float(m.group(1))


def worker_launches(out) -> dict:
    """The flag kernels' launch counts printed by each rank (LAUNCHES
    records, counted from 0 just before the rank's exchange), summed."""
    total = dict.fromkeys(FLAG_KERNELS, 0)
    for js in re.findall(r"LAUNCHES (\{[^}]*\})", out):
        for name, n in json.loads(js).items():
            total[name] += n
    return total


def phase_exchange(card_str) -> dict:
    """The device-triggered exchange between two ranks on the card, over
    the native host plane: builds it, runs the bridge worker at full size
    in each publish mode (B5, plain producer + B1, plain producer + B2;
    the receiver polls with B3 and B4 and checks every value on its card),
    the in-program twin at full size (overlap proved by order), the
    triggered 8-byte ping-pong on CUDA tensors (and, to split its time,
    with the echoing rank on CPU tensors and with both there), and
    build/bench_pingpong, the host plane alone, on the same machine.
    Returns the flag kernels'
    launch counts in the full-size exchange, summed over its two ranks."""
    t0 = time.perf_counter()
    res = subprocess.run(["make", "-C", str(ROOT), "-j8", "lib", "tools"],
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        fail(f"make lib tools: exit {res.returncode}\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    print(f"native host plane: make lib tools {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    py = sys.executable
    mib = PARTS * PART_SHAPE[0] * PART_SHAPE[1] * 4 / 2 ** 20
    shape = [str(v) for v in PART_SHAPE]
    out = run_ranks([py, "tests/torch_bridge_worker.py", "--device", "cuda",
                     "--parts", PARTS, "--part-shape", *shape, "--modes",
                     "produce_and_pready", "pready", "pready_many",
                     "--sets", SETS, "--rounds", ROUNDS],
                    f"exchange ({mib:.0f} MiB in {PARTS} partitions)")
    if out.count(f"BRIDGE_OK {PARTS}") != 2:
        fail(f"exchange: BRIDGE_OK missing\n{out}")
    counts = worker_launches(out)
    bw = {mode: float(gbps) for mode, gbps in
          re.findall(r"BRIDGE_BW mode=(\w+) gbps=([\d.]+)", out)}
    if len(bw) != 3:
        fail(f"exchange: a BRIDGE_BW record is missing\n{out}")
    for mode, gbps in bw.items():
        print(f"exchange torch {mib:.0f} MiB / {PARTS} partitions, publish "
              f"by {mode}, every value checked on the receiving card: "
              f"{gbps:.3f} GB/s (best of {SETS} sets x {ROUNDS} rounds) "
              f"[{card_str}]", flush=True)
    out = run_ranks([py, "tests/torch_bridge_inprogram_worker.py",
                     "--device", "cuda", "--parts", PARTS, "--part-shape",
                     *shape], "in-program exchange (held last partition)")
    if out.count(f"INPROGRAM_OK {PARTS}") != 2:
        fail(f"in-program exchange: INPROGRAM_OK missing\n{out}")
    out = run_ranks([py, "tests/torch_triggers_worker.py", "--device",
                     "cuda", "--pingpong", PINGPONG_ITERS],
                    "triggers (+ 8-byte ping-pong)")
    if out.count("TRIG_OK") != 2:
        fail(f"triggers: TRIG_OK missing\n{out}")
    p50 = field(out, "PINGPONG", "p50_us")
    p99 = field(out, "PINGPONG", "p99_us")
    print("ping-pong legs, CUDA tensors: " + " ".join(re.findall(
        r"\w+_us=[\d.]+", out.split("PINGPONG_SPLIT", 1)[1])[:4]),
        flush=True)
    # Where the ping-pong's time goes: the same exchange with the echoing
    # rank on CPU tensors (one process on the card), and with both ranks on
    # CPU tensors (the binding and trigger threads alone).
    pp = {}
    for label, devs in (("echo on CPU", ["cuda", "--echo-device", "cpu"]),
                        ("CPU tensors", ["cpu"])):
        out = run_ranks([py, "tests/torch_triggers_worker.py", "--device",
                         *devs, "--pingpong", PINGPONG_ITERS],
                        f"triggered ping-pong, {label}")
        pp[label] = (field(out, "PINGPONG", "p50_us"),
                     field(out, "PINGPONG", "p99_us"))
        print(f"ping-pong legs, {label}: " + " ".join(re.findall(
            r"\w+_us=[\d.]+", out.split("PINGPONG_SPLIT", 1)[1])[:4]),
            flush=True)
    out = run_ranks([ROOT / "build" / "bench_pingpong"],
                    "build/bench_pingpong (host plane alone)")
    host_bw = field(out, "BENCH", "part_bw_gbps")
    host_p50 = field(out, "BENCH", "pingpong_p50_us")
    host_p99 = field(out, "BENCH", "pingpong_p99_us")
    print(f"triggered ping-pong torch, 8-byte CUDA tensors: p50 {p50:.3f} "
          f"us, p99 {p99:.3f} us ({PINGPONG_ITERS} iters); " + "; ".join(
              f"{k}: p50 {v[0]:.3f} us, p99 {v[1]:.3f} us"
              for k, v in pp.items()) + f" [{card_str}]", flush=True)

    print(f"bench_pingpong host plane, same machine: 8-byte ping-pong p50 "
          f"{host_p50:.3f} us, p99 {host_p99:.3f} us; partitioned 64 MiB / "
          f"16: {host_bw:.3f} GB/s [{card_str}]", flush=True)
    print(f"port over host plane: ping-pong p50 {p50 / host_p50:.2f}x, "
          f"exchange GB/s {bw['produce_and_pready'] / host_bw:.3f}x (B5 "
          f"path) [{card_str}]", flush=True)
    print(f"launches during the exchanges: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        fail(f"a flag kernel of the exchange never launched: {counts}")
    return counts


KERNELS = {
    "flash_attention": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:126"),
    "flash_decode_attend": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:80"),
    "pready": dict(source="mpi_acx_torch/csrc/flags.cu",
                   replaces="mpi_acx_tpu/ops/flags.py:76"),
    "pready_many": dict(source="mpi_acx_torch/csrc/flags.cu",
                        replaces="mpi_acx_tpu/ops/flags.py:105"),
    "parrived": dict(source="mpi_acx_torch/csrc/flags.cu",
                     replaces="mpi_acx_tpu/ops/flags.py:135"),
    "parrived_all": dict(source="mpi_acx_torch/csrc/flags.cu",
                         replaces="mpi_acx_tpu/ops/flags.py:159"),
    "produce_and_pready": dict(source="mpi_acx_torch/csrc/flags.cu",
                               replaces="mpi_acx_tpu/ops/flags.py:210"),
}


def main() -> int:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false: this smoke run "
              "needs an NVIDIA GPU", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_str = card()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on "
          f"{torch.cuda.get_device_name(0)} [{card_str}]", flush=True)
    t_start = time.perf_counter()

    phase_build()
    errs = phase_kernels()

    from mpi_acx_torch.models import transformer as tfm
    t0 = time.perf_counter()
    params32 = tfm.init_params(dataclasses.replace(
        tfm.gpt2_small(), dtype=torch.float32), seed=0)
    print(f"params: GPT-2 124M, seed 0, {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_f32(params32)
    params16 = tfm.cast_params(params32, torch.bfloat16)
    del params32
    counts = phase_serve(params16, card_str)
    times = phase_timing(card_str)
    phase_step(params16, times["flash_decode_attend"]["ms"], card_str)
    del params16
    torch.cuda.empty_cache()

    flag_errs = phase_flags()
    times.update(phase_flag_timing(card_str))
    counts.update(phase_exchange(card_str))

    line = []
    for name, meta in KERNELS.items():
        t = times[name]
        entry = {"name": name, "route": "cuda", "source": meta["source"],
                 "replaces": meta["replaces"], "launches": counts[name]}
        if name in flag_errs:
            entry.update(max_abs_err=flag_errs[name]["abs"],
                         exact_cases=flag_errs[name]["cases"])
        else:
            entry.update(
                max_abs_err=errs[(name, torch.bfloat16)]["abs"],
                max_row_err=errs[(name, torch.bfloat16)]["row"],
                max_abs_err_f32=errs[(name, torch.float32)]["abs"],
                max_row_err_f32=errs[(name, torch.float32)]["row"])
        entry.update(ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                     library_ms=t["library_ms"])
        line.append(entry)
    print(json.dumps({"kernels": line}), flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
