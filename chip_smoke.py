#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mpi_acx_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py`` (one card, no
arguments). It imports nothing of JAX and needs nothing beyond the sources
in the repository. Phases, each of which exits non-zero on failure:

1. build   — compile the CUDA kernels in mpi_acx_torch/csrc/ for sm_90a
             (one nvcc per source, in parallel) into build/torch_kernels/;
             then count HGMMA, UTMALDG and HMMA in each of the 8 bf16
             instantiations of K1 (head dims 64 and 128, with and without
             the lse) and LDGSTS (cp.async) in each of the 48 decode
             instantiations (K2 and B9 at head dim 64, K2 at 128;
             cuobjdump -sass), with registers, stack and local memory:
             each K1 one must issue wgmma and TMA loads, none the legacy
             mma.sync, and spill nothing; each decode one must issue
             cp.async with no stack and no spills.
2. kernels — each kernel against its plain PyTorch version on the card, at
             the serving path's shapes, in bf16 and f32: max abs error
             and row errors within TOL_ABS, TOL_ROW, TOL_ROW_F32. K1 also
             over the ragged edges of its tiles (S of 1, 63, 65, 127, 129
             and 1000, causal and against Sk of 333 and 1000), at B=4 on
             the strided q/k/v views of a fused qkv product (read in
             place, no copy), with an operand at an odd element offset
             (copied by the wrapper, exactly once); its cases must reach
             both CTA sizes of the wrapper's rule; and on the views one
             rank of a tensor-parallel split makes (GPT-2 at 6 and 3
             local heads, the k view 768 and 384 bytes in), read in place.
             K2 at the split's shapes: 6 KV heads at n_rep 1 (GPT-2, tp =
             2) and 4 KV groups of 4 at D = 128 (Llama, tp = 2), both
             operand forms, W 1 and 4, max_len 1024 and 1000 and each
             candidate chunk stood in for the rule. The
             decode kernels in all four forms: K2 and B9 (paged), each
             over bf16/f32 and int8 caches; B9 over page sizes 16, 64
             and 128 with shuffled tables and an aliased first page; both
             at the edges of the split rule's chunks, at max_len 1000, at
             W * n_rep of 8 and 12, and with each candidate chunk stood
             in for the rule; B9 equal to K2 bit for bit on the same rows
             and each kernel equal to itself over two calls, in every
             case. At head dim 128 (Llama-3-8B: 32 query heads over 8 KV
             groups): K1 over the same ragged edges at H=32 on both CTA
             sizes, and K2 in both operand forms at n_rep 4, W * n_rep of
             4, 8 and 12, max_len 1024 and 1000 and each candidate chunk,
             and at W * n_rep of 16 (speculative decoding's window pass:
             W = 4, one position per slot, two 8-row blocks) at max_len
             1024 and at the window pass's cache length, each equal to
             itself over two calls; all under the same limits.
2b. train kernels — B10 (flash_attention_lse, bf16 and f32, B=4) over
             causal S = Sk of 64, 1000, 1024, 1025 and 1088 and four
             non-causal Sk != S: o within the phase-2 limits, the lse
             within TOL_LSE; B7 (the streaming entry) at S = Sk = 16384 on
             its first, middle and last 128 query rows, each over its
             whole key prefix; the backward (dq, dk, dv of flash_attention
             and flash_attention_lse, random dO and dLSE) against autograd
             through the plain versions, within TOL_GRAD, causal at the
             training shape and, for flash_attention_lse, at a ring
             step's non-causal block (B=2, S = Sk = 512: phase 7c's
             earlier K/V block, whose lse cotangent is nonzero). Each at
             GPT-2's heads (H=12, D=64) and again at Llama-3-8B's (H=32,
             D=128).
3. f32     — GPT-2 124M at full width in float32 served through the kernels
             and through the plain versions: the tokens must be equal (a
             divergence passes only at a true tie, see TIE), and the two
             paths' logits over the served sequences within TIE. Here and
             on the paths of phases 4, 4b and 5b and the long-context
             call, K1's wrapper must copy no operand.
4. serve   — GPT-2 124M in bf16, 16 requests through 8 slots (max_len
             1024, chunk 8): every request gets its tokens, tokens/s, TTFT
             and ITL are printed, and both kernels must have launched;
             every prefill seated in its slot, replayed from the captured
             pass of its bucket, the first of the call run eagerly, one
             capture a bucket (PREFILL_COUNTS). The same requests then go
             through the plain versions, held to the kernel path's tokens
             and logits as in phase 3.
4b. paged  — the same requests through serve_paged_greedy (128-token
             pages): (a) tokens equal to phase 4's exactly, through B9;
             (b) int8 caches, fixed-slot through K2's int8 form and paged
             through B9's, equal to each other exactly and each held to
             its plain path; (c) a 16-page pool, so requests are
             preempted and replayed, tokens equal to (a) exactly; (d) 16
             requests sharing a 256-token system prompt with the prefix
             cache on: 15 hits, pages reused, a lower page high-water mark
             than the same requests cold, tokens held to the cold run.
             Every decode kernel form must have launched.
4e (GPT-2) — after 4b, on GPT-2's bf16 weights: serve_sample over phase 4's
             requests at temperature 0 (tokens exactly phase 4's), then at
             temperature 0.8, top_k 40, top_p 0.95 with chunk 8 and chunk
             1 (each request's tokens bit-equal between the two, every
             drawn token inside its step's top-k set); int8 weights
             (quantize_weights_int8) under speculative decoding (a 1-layer
             int8 draft from seed 7, k = 4, 4 rows of 128 tokens, 64 new)
             held to the int8-weight greedy tokens up to the first tie
             within TIE.
4f. disagg — (after 4e, on GPT-2's bf16 weights; the only in-process
             Runtime of the run, over the native host plane built here
             with `make -j8 lib tools`, finalized before phase 7) phase 4's
             16 requests with int8 slots: (a) serve_greedy(kv_int8=True),
             the baseline of the same call; (b) serve_disagg_greedy in
             loopback (a layerwise prefill per request, each layer's codes
             and scales shipped as one partition of a partitioned send to
             this process and spliced into the slot) with the prefill's
             K/V quantized at the wire, quantized at compute, and shipped
             only after the whole prompt pass: each one's tokens exactly
             (a)'s, K1 launched exactly handoffs x 12, K2's int8 form
             launched and its bf16 form not, each handoff's wire bytes
             12 x layer_part_bytes of its bucket; the p50 of prefill,
             ship, pickup and exposed-publish time, TTFT, ITL and tokens/s
             of (a) and of each (b); (d) a peer loss raised before layer 6
             of one handoff requeues it uncharged at max_request_retries=0
             (tokens still (a)'s), a plain error there is charged.
4c. llama  — (runs after phase 5's GPT-2 timings, with GPT-2's parameters
             freed) Llama-3-8B (seed-0 weights drawn on the card): at full
             width cut to 4 layers in f32, 8 requests through the kernels
             and the plain versions (tokens and logits as phase 3); then
             at full width and depth in bf16 (16.06 GB), phase 4's 16
             requests with bf16 and then int8 KV caches, each held to the
             same requests through the plain versions (ties within
             TIE_LLAMA; with bf16 KV the kernel path's logits no farther
             from an f32 forward of the same weights than the plain
             path's), K1's launches exactly the prefills x 32 layers, the
             prefills counted as phase 4's; tokens/s, TTFT, ITL, the D = 128 kernels timed at the path's
             shapes (with the split rule's A/B and K1's CTA sizes there),
             and a decode step issued against its device time. In the f32
             run also speculative decoding (k = 4, 4 rows of 128 tokens, 64
             new) with a 1-layer draft and with draft = target: tokens
             equal to greedy up to ties within TIE, and with draft =
             target rounds <= ceil(64 / 4) + 1 and accepted >= 3 x
             (rounds - 1) in every row.
4e (Llama) — sampling, int8 weights and speculative decoding on
             phase 4c's bf16 weights, before they are freed: (a)
             serve_sample as in GPT-2's 4e, with bf16 and int8 KV,
             tokens/s, TTFT and ITL beside serve_greedy's and the
             host cost of a slot's draw; (b) quantize_weights_int8 on the
             card (weight_bytes printed against bf16's), phase 4's
             requests served through the kernels and the plain versions
             (ties within TIE_LLAMA), the tokens agreeing with the
             bf16-weight serve counted, a decode step timed; (c)
             speculative decoding with a 1-layer draft at full width (seed
             7), k = 4, 4 rows of 128 tokens, 64 new: tokens equal to
             llama.generate up to the first near tie (TIE_LLAMA), K1
             launched exactly 32 + 1 times and K2 rounds x (32 + 4) times,
             rounds, acceptance and ms per emitted token beside plain
             greedy's; draft = target (the same tensors) likewise, its
             rounds and acceptance printed; speculative_sample twice with
             one seed, bit-equal; then K2 timed at the window pass's shape
             (W = 4, 16 rows a KV group) beside its plain version, SDPA
             with the window's mask and its bound.
4d. moe    — (after 4c, Llama's weights freed) the MoE family
             (moe_transformer's default configuration: GPT-2 small's
             attention, 8 experts of d_ff 3072, top-1, 12 layers, 520.7 M
             parameters; served at capacity factor 8.0, the drop-free
             rule): at full width cut to 2 layers in f32, 8 requests
             through the kernels and the plain versions (tokens and logits
             as phase 3, routing decisions apart only at ties); then at
             full width and depth (seed-0 weights drawn on the card, cast
             to bf16) phase 4's 16 requests with bf16 and then int8 KV
             caches, each held to the same requests through the plain
             versions (ties within TIE_MOE; with bf16 KV the routing
             decisions apart counted and the kernel path's logits no
             farther from an f32 forward of the same weights than the
             plain path's), K1's launches exactly the prefills x 12
             layers, K2 launched in the cache's form alone, the prefills
             counted as phase 4's; tokens/s,
             TTFT, ITL, and a decode step
             issued against its device time and profiled into router with
             dispatch and combine, the experts' upcasts, their products,
             K2 and the rest.
4f. deepseek — (after 4d, its weights freed) DeepSeek-V2-Lite's kernels
             (ops/mla.py, ops/moe_experts.py; Triton) at the served path's
             shapes, each held to its plain version: the MLA decode kernel
             over 64 slots of 4096 (16 heads of 512 + 64, one slot at
             position 0, one full, ~34k live rows), the MLA prefill kernel
             (K1 at q/k 192, v 128; S = 161, 1000 and 1024, and B = 2 at
             S = 333) within TOL_ROW_F32 of their plain versions in f32,
             and the routed experts
             (64 tokens, top-6 of 64 experts of 1408) within
             TOL_EXPERTS_ROW; each timed beside its plain version, SDPA
             where one call does the same, and its bound. Then the model
             at its published widths and full depth (15.7 B parameters,
             seed-0 bf16 weights drawn on the card) serves 64 requests
             (phase 4's mix, 64 slots of 4096, chunk 4) through
             serve_greedy after a warm-up call on the same
             make_server_fns result that serves one prompt of each length:
             every decode step and every prefill replayed from the
             captured ones, none captured or run eagerly, the launches
             exactly the prefills x 27 (MLA prefill), the steps x 27 (MLA
             decode) and the prefills run eagerly or captured in the call
             x 26 (routed experts, here 0: a replayed step or prefill
             issues them inside its graph), K1 none, 384 pairs a MoE layer a step (the device
             counter: none dropped); four requests held to generate's
             tokens (ties within TIE_DEEPSEEK).
5. timing  — each kernel, its plain version, the equivalent PyTorch
             library call (where one call computes the same function) and
             the roofline bound at the phase-4 and 4b shapes
             (device time: the calls are replayed from a CUDA graph); the
             decode kernels also with every slot at its last row (the full
             cache), the split rule's candidates at both shapes, and K2's
             wrapper's host cost per call; and one decode step as the
             server issues it against its device time (the device's busy
             share of a step).
5b. train  — GPT-2 124M at full width and depth (seed-0 f32 params, bf16
             compute) trained through the port's train step on a 1x1x1
             mesh: 5 AdamW steps of 2 microbatches of 4 x 1024 tokens (the
             ramp task of examples/train_distributed.py) through B10 and
             one more step profiled (split into forward, backward,
             optimizer and the device's busy share); then, that run's
             state freed, the same 5 from the same init (drawn again from
             its seed) through the dense ring blocks: per-step losses
             within TOL_TRAIN_LOSS0 (step 0) and TOL_TRAIN_LOSS, the loss
             after step 5 below step 0's, B10 launched exactly 12 x 2 x 5
             times and not at all in the dense run; step time, tokens/s
             and each run's peak memory.
5c. moe train — the MoE configuration at full width and depth (capacity
             factor 2.0, so tokens past capacity drop) trained as in 5b:
             the same checks and figures, B10 launched exactly 12 x 2 x 5
             times, and each step's load-balance term.
5d. llama train — Llama-3-8B at full width cut to 4 layers (1.923 B
             parameters: seed-0 f32 drawn on the card, bf16 compute)
             trained as in 5b: B10 at head dim 128 launched exactly
             4 x 2 x 5 times, the same checks and figures. Then B7's path,
             a long-context flash_attention at S = 16384, forward and
             backward, through the streaming entry at both head dims; then
             B10 and B7 at both head dims timed like phase 5, and one
             blockwise attention backward per layer at each.
5e. train entry — (after 5d; its files under build/, removed after) the
             training entry point at full width, held to 5b-5d's GPipe
             kernel runs: (a) GPT-2 124M fed from a uint16 ramp token
             file through TokenDataset, batches(seed=0) and prefetch onto
             the card, 5 AdamW steps whose losses must equal those of the
             same windows handed over as tensors made on the card; two
             such direct runs set the limit (0 if the step is
             deterministic: bit-equal); (b) a checkpoint saved after
             step 2 with wait=False, restored into a fresh model and
             AdamW, steps 3-4 run: losses and final parameters equal to
             the uninterrupted run's within that limit, the checkpoint's
             bytes and save/wait/restore ms printed; (c) StepTimer's
             summary over (a)'s steps, and a trace of one more step in
             which the annotation 'train_step' must be found; (d) 5 steps
             each of GPipe (again, the same-call baseline), remat,
             n_virtual=2, 1f1b and 1f1b with n_virtual=2 from 5b's init
             and batch, losses within TOL_TRAIN_LOSS0 / TOL_TRAIN_LOSS
             of 5b's; (e) GPipe and 1F1B, 2 steps each at
             M = 2 and 8: 1F1B's peak at M = 8 within FLAT_TOL of its
             peak at M = 2 and below GPipe's at M = 8; (f) Llama-3-8B (4
             layers) under remat and 1f1b, held to 5d's, each peak
             printed beside 5d's; (g) MoE under 1f1b (the router-aux
             seeds), held to 5c's. In every run B10's launches must be
             exactly what the port's schedule gives (b10_per_step: 1F1B
             re-runs each chunk for its backward, remat recomputes each
             layer), ms per step and peak memory printed.
6. flags   — the flag kernels B1-B5 (csrc/flags.cu) against their plain
             versions with exact equality over tables of 1 to 4096 slots,
             indices in and out of range, repeated, as ints and as tensors
             on the card, and B5's payload bit for bit at 8x128 and at the
             4 MiB partition, with its compiled producers and a general
             one (tanh(t) * 3, computed on the stream with B1's flag store
             behind it); then each timed by CUDA-graph replay beside
             its plain version and its one-call PyTorch equivalent (B1
             and its one-store equivalent in B1_REPEATS turns each, with
             their spread).
7. exchange — `make lib tools`, then two ranks on the card under
             build/acxrun: 64 MiB of f32 in 16 partitions produced and
             flagged by the kernels, published through stream triggers,
             polled by B3/B4 on the receiver and checked value by value
             there (GB/s per publish mode, best of 3 sets of 20 rounds);
             the in-program twin; the 8-byte triggered ping-pong on CUDA
             tensors; and build/bench_pingpong, the host plane alone, for
             comparison in the same run. Every flag kernel must launch.
7b. disagg fleet — two ranks on the card under build/acxrun
             (ACX_ROLE=prefill,decode) running tests/torch_disagg_worker.py
             at GPT-2 124M's full width: the prefill rank ships per-layer
             handoffs, the decode rank serves them from fixed int8 slots,
             then from 64-token int8 pages, and holds its outputs to its
             own monolithic int8 serve exactly. Over the two ranks K1 runs
             exactly requests x 12 times; the fixed run launches K2's int8
             form and no B9, the paged run B9's int8 form and no K2. A
             third run ships each handoff only after its whole prompt
             pass (fixed slots), the baseline of per-layer Pready. The
             ranks' TTFT split and figures are printed (correctness-grade:
             the two ranks share the card).
7c. multi-rank train — eight ranks of tests/torch_rank_worker.py under
             build/acxrun on the one card (gloo groups: NCCL refuses two
             ranks on one device), each calling multihost.initialize(),
             global_mesh({dp: 2, pp: 2, tp: 2}), shard_params and the
             port's train step on GPT-2 124M at full width, its depth cut
             to MULTI_LAYERS = 4 of 12 (2 layers a stage, so that the
             whole run stays near 750 s beside phase 7d), with phase 5b's
             batch and seed-0 weights: (a)
             f32 step 0 (TF32 off), the ranks' gradient shards assembled
             by unshard_params and held with the loss to the one-rank
             step's on the same weights and batch (TOL_MULTI_F32,
             TOL_MULTI_LOSS); (b) the same under 1F1B with n_virtual=2,
             held to (a); (c) dp_quant_bits=8, the loss equal to (a)'s
             and each leaf within the quantized sync's bounds of (a)'s;
             (d) bf16 compute on f32 weights, 3 AdamW steps, the losses
             held to the one-rank kernel run at the same depth
             (TOL_TRAIN_LOSS0,
             TOL_MULTI_TRAIN_LOSS); B10's launches per rank and run exactly
             what the code gives (b10_multirank); per rank the step ms,
             peak memory, bytes handed to the wire per axis and the
             backend, correctness-grade (8 ranks share one card).
7d. serving and MoE across ranks — two ranks of
             tests/torch_rank_worker.py (``tp --full-width``, its sub-runs
             in tests/torch_tp_smoke.py) under build/acxrun on the one
             card over gloo, every rank's results equal to the other's bit
             for bit: (a) GPT-2 124M bf16 at tp = 2 through
             make_tp_server_fns under serve_greedy (phase 4's requests, 8
             slots, chunk 8), bf16 and int8 KV, held to phases 4 and 4b's
             one-rank tokens (a divergence only at a tie within TIE, the
             margin from the rank's own logits over the common prefix), K1
             exactly prefills x 12 a rank; make_tp_generate sampled
             (temperature 0.8, top-k 40, top-p 0.95) twice with one seed,
             bit-equal, every token inside its step's top-k set; (b)
             Llama-3-8B at full width and depth, each rank drawing only its
             KV-group slice of the seed-0 bf16 weights leaf by leaf, served
             with bf16 and int8 KV, held to phase 4c's tokens (TIE_LLAMA);
             (c) the MoE transformer (phase 4d's configuration) with auto
             (sharded all_to_all dispatch) and replicated experts, held to
             phase 4d (TIE_MOE), the routed calls dispatched sharded
             printed; (d) TP speculative decoding (GPT-2 target, 1-layer
             draft, k = 4, 4 rows of 128, 64 new) held to one-rank
             speculative_generate up to the first near tie, K1 exactly 12 +
             1 and K2 rounds x (12 + 4) a rank; (e) the DP+EP train step
             of the MoE transformer (f32, capacity factor 8.0, one
             sequence of 1024 a rank) and make_moe_train_step at d 768,
             d_ff 3072, 8 experts, each held to its one-rank step on the
             whole batch (TOL_MULTI_LOSS, TOL_MULTI_F32 per leaf); (f)
             Ulysses at S = 4096, heads 12 x 64 and 32 x 128, bf16 and f32,
             each rank's block held to one-rank K1 within phase 2's limits,
             K1 once a call at H / 2 heads; (g) the partitioned exchange
             of 64 MiB of int32 in 16 partitions, with and without a
             consumer, and the pipeline, exact. Tokens/s and launches per
             rank printed; correctness-grade (two ranks share one card, the
             wire goes through the host): no speed claim.
8. the kernels line (JSON), the card's name and power limit, and last the
   result line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import json
import math
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
# 0.86-2.1. K1's wgmma form over the ragged-tile, strided and odd-offset
# cases as well: row error up to 6.4e-2 against the bf16 plain version,
# where that version's own row error against f32 is 6.3e-2 (S=1000 against
# Sk=333), and at most 1.8e-2 against f32; f32 at most 9.7e-6. A V stage
# read one slot off reads 3.8. The int8 forms with bf16 queries are held
# to the bf16 limits:
# their plain version rounds q and the probabilities to bf16 where the
# kernels keep them in f32. Readings on an H100 over the phase-2 cases:
# K2-int8 row error up to 2.8e-2 against its plain version (whose own row
# error against f32 is up to 2.7e-2) and 1.3e-2 against f32; B9 up to
# 4.3e-2 and 1.4e-2 (its plain version's own: 4.2e-2), B9-int8 up to
# 3.8e-2 and 1.3e-2 (3.1e-2); every f32 form at most 9.6e-6. The split
# decode template (chunks merged on chip) over the wider phase-2 grid of
# chunk edges: bf16 and int8 forms up to 4.5e-2 against their plain
# versions (whose own is up to 4.7e-2) and 1.6e-2 against f32; every f32
# form at most 4.4e-6. B9 equals K2 bit for bit on the same rows, so its
# limits are K2's.
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
# The same rule for Llama-3-8B in bf16 at full depth (phase 4c), whose plain
# path differs from itself by more than TIE: over its 16 served sequences
# (probes/bf16_paths.py llama, on an H100) its forward pass and its own
# decode, replayed, differ by up to 0.60 in a logit (a max over 128256
# logits at each of up to 640 positions, bf16 through 32 layers); 171 of
# the 960 tokens its server emitted are not its own forward's argmax, at
# forward margins up to 0.44; the kernel path's forward differs from the
# plain path's by 0.43-0.57. The f32 run at full width (4 layers) holds the
# same path to TIE[f32], and against an f32 forward of the same weights
# the kernel path's logits read RMS 7.70e-2 (max 0.46), the plain path's
# 8.80e-2 (0.61): phase 4c requires the kernel path to be no farther.
# Limit: about twice the plain path's own largest disagreement.
TIE_LLAMA = 1.2
# The same rule for the MoE configuration in bf16 at full depth (phase
# 4d), whose plain path also differs from itself by more than TIE: over
# phase 4's 16 requests (probes/bf16_paths.py moe, on an H100) its
# forward pass and its own decode, replayed, differ by up to 0.64 in a
# logit, because 71 of their 11520 routing decisions (a token's expert in
# one layer) differ, at plain gate margins up to 0.35 (a token routed to
# another expert moves by a whole expert's output); 3 of its 960 served
# tokens are not its own forward's argmax (margins up to 0.027). The kernel
# path's forward differs from the plain path's by up to 0.79 (813 of
# 55872 routing decisions apart), and against an f32 forward of the same
# weights it reads RMS 3.25e-2, the plain path 3.45e-2: phase 4d requires
# the kernel path to be no farther. Limit: about twice the plain path's
# own largest disagreement.
TIE_MOE = 1.3
# B10's lse (f32 in both dtypes), max abs error against the plain version
# in the same dtype and against an f32 plain run on the same inputs, q
# taken as the kernel (and the TPU kernel) takes it: scaled by 1/sqrt(D)
# and rounded to the input type. At D = 64 the scale is 1/8 and the
# rounding exact; at D = 128 it is part of the function the kernel
# computes and lies far above f32's rounding, so the f32 run must see it.
# Readings on an H100 over the phase-2b cases: bf16 1.4e-2 (D = 64) and
# 1.8e-3-1.2e-2 (D = 128) against the bf16 plain version (whose logits are
# rounded to bf16) and 9.5e-7 / 1.9e-6 against f32 (the kernel's logits
# are exact products of the bf16 operands summed in f32); f32 9.5e-7 /
# 1.9e-6 (one or two ulps at lse 8-16). Limits: about twice the bf16
# reading, five ulps where the reading is one.
TOL_LSE = {torch.float32: 5e-6, torch.bfloat16: 3e-2}
TOL_LSE_F32 = {torch.float32: 5e-6, torch.bfloat16: 5e-6}
# The backward (dq, dk, dv of flash_attention and flash_attention_lse at
# the training shape, random dO and dLSE) against autograd through the
# plain versions: max abs error and the row errors of ``errors``, each
# row's RMS taken no smaller than the whole gradient's (GRAD_RMS_FLOOR;
# dq of a causal first row is exactly 0: one visible key). f32: both sides
# in f32. bf16: the kernel path's backward runs in f32 from bf16 inputs,
# but its D = rowsum(dO * O) reads the bf16 O, as the JAX package's does;
# in the early causal rows dP - D cancels, so dq there carries that
# rounding. Readings on an H100: bf16 abs 3.1e-2, row 5.6e-2 against the
# bf16 plain version (whose own row error against f32 is 3.9-5.0e-2) and
# 4.9e-2 against f32; f32 abs 9.5e-6, row 1.0e-5. Limits: about twice
# the readings (f32 abs at 1e-4). The non-causal ring block (B = 2, S =
# Sk = 512, random dLSE; two runs on an H100) reads within them: bf16 row
# 4.3-5.2e-2 against the bf16 plain version (whose own row error against
# f32 is 3.9-4.6e-2) and 1.3-1.4e-2 against f32 at D = 64, 4.0-5.0e-2 and
# 1.4-1.5e-2 at D = 128 (plain's own 3.5-4.9e-2); f32 1.6-4.6e-6 at D =
# 64 and 2.1-5.5e-6 at D = 128. So the same limits hold it.
TOL_GRAD = {torch.float32: dict(abs=1e-4, row=2e-5, row_f32=2e-5),
            torch.bfloat16: dict(abs=6e-2, row=0.12, row_f32=0.1)}
# The same at Llama-3-8B's heads (H = 32, D = 128), where dq reads more
# than at D = 64, in its first causal rows (dk, dv as at D = 64): bf16
# 0.11-0.15 against both the bf16 plain version and f32, f32 2.4-2.6e-5.
# The same blockwise backward run on the plain forward's own O, no kernel
# in it, reads the same: bf16 0.09-0.15, f32 2.4-2.6e-5 to the digit; at
# D = 64 bf16 0.073 where the kernel path reads 0.063, f32 6.8e-6 both
# (probes/bwd_paths.py, on an H100). The excess is that recipe's D =
# rowsum(dO * O) at 32 heads of 128, not K1's. Limits: about twice the
# recipe's largest reading.
TOL_GRAD_D128 = {torch.float32: dict(abs=1e-4, row=5e-5, row_f32=5e-5),
                 torch.bfloat16: dict(abs=6e-2, row=0.3, row_f32=0.3)}
GRAD_RMS_FLOOR = 1.0
# Training: the kernel run's losses against the dense-block run's, both in
# bf16 compute. Step 0 sees the same parameters, so it compares the
# forwards alone: reading 9.0e-5 on an H100 (B10's o is rounded to bf16
# where the dense blocks keep f32). After that the two are two AdamW
# trajectories, and AdamW divides each gradient by its own RMS, so
# rounding-level differences in near-zero gradients become whole steps of
# lr: readings 3.1e-4 to 6.9e-2 at steps 1-4 and 1.9e-2 after step 5,
# not growing steadily, while the loss falls 0.3-1.1 a step. Limits: about
# five times step 0's reading, twice the largest later one. The
# trajectories cannot see a gradient error of attention's size; phase 2b's
# backward check holds those.
TOL_TRAIN_LOSS0 = 5e-4
TOL_TRAIN_LOSS = 0.15
# H100 SXM peaks (NVIDIA data sheet): dense bf16 tensor-core and f32 FMA
# rates, HBM bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              torch.int8: 1979e12}
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


def sm_count() -> int:
    """The card's SMs: K1's CTA-size rule reads them."""
    return torch.cuda.get_device_properties(0).multi_processor_count


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


SASS_OPS = ("HGMMA", "UTMALDG", "HMMA")
DECODE_TYPES = {"f": "f32", "t": "bf16", "a": "int8"}


def decode_name(fn):
    """``<q type, cache type, D, R, paged>`` of a decode_kernel
    instantiation from its mangled name, or None for another function."""
    t = re.search(r"decode_kernelI([fta])([fta])Li(\d+)ELi(\d)ELb(\d)E",
                  fn)
    if t is None:
        return None
    return (f"<{DECODE_TYPES[t.group(1)]}, {DECODE_TYPES[t.group(2)]}, "
            f"D={t.group(3)}, R={t.group(4)}, "
            f"{'paged' if t.group(5) == '1' else 'fixed'}>")


def k1_name(fn):
    """``<consumer warpgroups, D, EmitLse>`` of a flash_fwd_bf16
    instantiation from its mangled name."""
    t = re.search(r"flash_fwd_bf16ILi(\d)ELi(\d+)ELb(\d)EE", fn)
    if t is None:
        return fn
    return (f"<{t.group(1)}, D={t.group(2)}, "
            f"{'true' if t.group(3) == '1' else 'false'}>")


# Instantiations in the library: K1's bf16 form at D = 64 and 128 (1 or 2
# consumer warpgroups, with and without the lse); the decode template at
# D = 64 (2 q types x 2 cache forms x 4 row blocks x contiguous and paged)
# and at D = 128 (contiguous only).
K1_INSTANTIATIONS = 8
DECODE_INSTANTIATIONS = 48


def phase_sass() -> None:
    """From ``cuobjdump -sass`` of the built library: counts of wgmma
    (HGMMA), TMA load (UTMALDG) and legacy mma.sync (HMMA) instructions in
    each bf16 instantiation of K1 (head dims 64 and 128, with and without
    the lse), and of cp.async (LDGSTS) in each of the 48 decode
    instantiations (K2 and B9, both operand forms, at head dim 64; K2 at
    128); beside each its registers at launch, stack and local memory
    (``cuobjdump -res-usage``). Fails unless every K1 one issues HGMMA and
    UTMALDG and no HMMA with no local memory (no spills), and every decode
    one issues LDGSTS with no stack and no local memory."""
    from mpi_acx_torch.ops import _build
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    res = subprocess.run([str(cuobjdump), "-sass",
                          str(_build.BUILD_DIR / _build.LIB_NAME)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass failed: {res.stderr.strip()[-2000:]}")
    counts, decode, fn = {}, {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            if "flash_fwd_bf16" in fn:
                counts[fn] = dict.fromkeys(SASS_OPS, 0)
            elif decode_name(fn):
                decode[fn] = 0
            else:
                fn = None
        elif fn in counts:
            for op in SASS_OPS:
                counts[fn][op] += len(re.findall(rf"\b{op}\b", line))
        elif fn in decode:
            decode[fn] += len(re.findall(r"\bLDGSTS\b", line))
    # Registers, stack and local memory (spills) per function.
    res = subprocess.run([str(cuobjdump), "-res-usage",
                          str(_build.BUILD_DIR / _build.LIB_NAME)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -res-usage failed: {res.stderr.strip()[-2000:]}")
    usage, fn = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            fn = m.group(1)
        elif (fn in counts or fn in decode) and "REG:" in line:
            usage[fn] = dict(re.findall(r"(REG|STACK|LOCAL):(\d+)", line))

    def res_str(fn):
        u = usage.get(fn, {})
        return (f"registers at launch {u.get('REG', 'missing')}, stack "
                f"{u.get('STACK', 'missing')} B, local (spills) "
                f"{u.get('LOCAL', 'missing')} B")
    for fn, c in sorted(counts.items(), key=lambda kv: k1_name(kv[0])):
        print(f"sass flash_fwd_bf16{k1_name(fn)} (consumer warpgroups, head "
              f"dim, EmitLse): " + ", ".join(f"{op} {n}" for op, n in c.items())
              + f"; {res_str(fn)}", flush=True)
    for fn, n in sorted(decode.items(), key=lambda kv: decode_name(kv[0])):
        print(f"sass decode_kernel{decode_name(fn)}: LDGSTS {n}; "
              f"{res_str(fn)}", flush=True)
    if len(counts) != K1_INSTANTIATIONS:
        fail(f"expected {K1_INSTANTIATIONS} bf16 instantiations of K1 in the "
             f"library, found {len(counts)}")
    if len(decode) != DECODE_INSTANTIATIONS:
        fail(f"expected {DECODE_INSTANTIATIONS} decode instantiations in the "
             f"library, found {len(decode)}")
    for d in (64, 128):
        if not any(f"D={d}," in k1_name(fn) for fn in counts) or not any(
                f"D={d}," in decode_name(fn) for fn in decode):
            fail(f"no head dim {d} instantiation of K1 or of the decode "
                 f"template in the library")
    missing = set(counts) | set(decode)
    if set(usage) != missing:
        fail(f"cuobjdump -res-usage gave no registers for "
             f"{sorted(missing - set(usage))}")
    for fn, c in counts.items():
        local = int(usage[fn].get("LOCAL", 1))
        if c["HGMMA"] == 0 or c["UTMALDG"] == 0 or c["HMMA"] or local:
            fail(f"flash_fwd_bf16{k1_name(fn)}: HGMMA {c['HGMMA']}, UTMALDG "
                 f"{c['UTMALDG']}, HMMA {c['HMMA']}, local {local} B")
    for fn, n in decode.items():
        u = usage[fn]
        if n == 0 or int(u.get("STACK", 1)) or int(u.get("LOCAL", 1)):
            fail(f"decode_kernel{decode_name(fn)}: LDGSTS {n}, stack "
                 f"{u.get('STACK')}, local {u.get('LOCAL')}")


# --- phase 2 ---------------------------------------------------------------

def errors(out, ref, ref32, rms_floor: float = 0.0, head_dim: int = D
           ) -> dict:
    """Errors of ``out`` (kernel) against ``ref`` (plain version, same
    dtype) and ``ref32`` (plain version in f32 on the same inputs), over
    output rows of ``head_dim`` values: max abs error, row error against
    each, and the plain version's own row error against f32 (what bf16
    costs it). A row's RMS is taken no smaller than ``rms_floor`` times the
    whole tensor's."""
    if out.shape != ref.shape or not torch.isfinite(out.float()).all():
        fail(f"kernel output: shape {tuple(out.shape)}, plain "
             f"{tuple(ref.shape)}, or non-finite values")
    o, r, r32 = (x.float().reshape(-1, head_dim) for x in (out, ref, ref32))
    rms = r32.square().mean(-1).sqrt().clamp(
        min=rms_floor * r32.square().mean().sqrt().item())

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


def k1_errs(S, Sk, causal, dtype, gen, B=1, heads=H, head_dim=D):
    q = randn((B, S, heads, head_dim), dtype, gen)
    k = randn((B, Sk, heads, head_dim), dtype, gen)
    v = randn((B, Sk, heads, head_dim), dtype, gen)
    return k1_check(q, k, v, causal)


def qkv_views(B, S, dtype, gen, heads=H):
    """q, k, v as ``transformer._qkv`` (and one rank of the tensor-parallel
    split, ``heads`` of them) hands them to K1: [B, S, heads, D] views of
    one fused [B, S, 3 heads D] product (seq stride 3 heads D, element
    offsets 0, heads D and 2 heads D)."""
    qkv = randn((B, S, 3 * heads * D), dtype, gen)
    return tuple(t.reshape(B, S, heads, D)
                 for t in qkv.split(heads * D, dim=-1))


def odd_offset(x):
    """``x``'s values in a tensor whose base lies one element past an
    aligned address: TMA cannot read it in place."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def k1_check(q, k, v, causal):
    from mpi_acx_torch.ops.attention import attention_reference, \
        flash_attention
    out = flash_attention(q, k, v, causal=causal)
    ref = attention_reference(q, k, v, causal=causal)
    ref32 = attention_reference(q.float(), k.float(), v.float(),
                                causal=causal)
    torch.cuda.synchronize()
    return errors(out, ref, ref32, head_dim=q.shape[-1])


def k2_errs(B, W, n_rep, pos, dtype, gen, max_len=1024, heads=H,
            head_dim=D, twice=False):
    """K2 against its plain version; with ``twice`` the kernel runs again
    on the same inputs and must give the same bits."""
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    Hkv = heads // n_rep
    q = randn((B, W, heads, head_dim), dtype, gen)
    kc = randn((B, max_len, Hkv, head_dim), dtype, gen)
    vc = randn((B, max_len, Hkv, head_dim), dtype, gen)
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    out = flash_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    if twice and not same(out, flash_decode_attend(q, kc, vc, pos_t, max_len,
                                                   n_rep)):
        fail(f"flash_decode_attend {dtype} D={head_dim} n_rep={n_rep} W={W}: "
             f"two calls on the same inputs differ")
    ref = dense_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    ref32 = dense_decode_attend(q.float(), kc.float(), vc.float(), pos_t,
                                max_len, n_rep)
    torch.cuda.synchronize()
    return errors(out, ref, ref32, head_dim=head_dim)


def quantize(c):
    from mpi_acx_torch.ops.kvquant import kv_quant
    return kv_quant(c)


def paged_errs(form, pt, W, n_rep, pos, gen, B=8, max_len=1024):
    """B9 against its plain version on a pool whose pages hold a
    [B, max_len] cache in shuffled order, every slot's first page aliased
    to one shared page; and B9 against K2 on the same rows (gathered into
    the contiguous layout), which must agree bit for bit. Each kernel runs
    twice and must give the same bits both times. ``form`` is (q dtype,
    int8 cache?). Returns B9's errors and K2's (on the gathered rows)
    against the plain version."""
    from mpi_acx_torch.ops.flash_decode import flash_decode_attend, \
        paged_flash_decode_attend, paged_gather_attend
    dtype, int8 = form
    Hkv, max_pages = H // n_rep, max_len // pt
    P = B * max_pages + 3
    q = randn((B, W, H, D), dtype, gen)
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(pt))
    table = perm[:B * max_pages].reshape(B, max_pages).clone()
    table[:, 0] = table[0, 0]                       # a shared first page
    table = table.to(torch.int32).cuda()
    pools = []
    for _ in range(2):
        c = randn((P, pt, Hkv, D), dtype, gen)
        pools.append(quantize(c) if int8 else c)
    kp, vp = pools
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    out = paged_flash_decode_attend(q, kp, vp, table, pos_t, pt, n_rep)
    again = paged_flash_decode_attend(q, kp, vp, table, pos_t, pt, n_rep)
    ref = paged_gather_attend(q, kp, vp, table, pos_t, pt, n_rep)

    def f32(c):
        return c if int8 else c.float()
    ref32 = paged_gather_attend(q.float(), f32(kp), f32(vp), table, pos_t,
                                pt, n_rep)
    idx = table.long()

    def rows(pool):
        if isinstance(pool, tuple):
            return tuple(rows(x) for x in pool)
        return pool[idx].reshape((B, max_len) + tuple(pool.shape[2:]))
    kc, vc = rows(kp), rows(vp)
    fixed = flash_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    fixed2 = flash_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    torch.cuda.synchronize()
    desc = f"{form} pt={pt} W={W} n_rep={n_rep} max_len={max_len}"
    if not (same(out, again) and same(fixed, fixed2)):
        fail(f"decode {desc}: two calls on the same inputs differ (B9 "
             f"{same(out, again)}, K2 {same(fixed, fixed2)} equal)")
    if not same(out, fixed):
        fail(f"paged decode {desc}: B9 differs from K2 on the same rows (max "
             f"{(out.float() - fixed.float()).abs().max().item():.3e})")
    return errors(out, ref, ref32), errors(fixed, ref, ref32)


def k2_int8_errs(B, W, n_rep, pos, dtype, gen, max_len=1024, heads=H,
                 head_dim=D, twice=False):
    """K2's int8 form against the plain version on (codes, scales); with
    ``twice`` as :func:`k2_errs`."""
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    Hkv = heads // n_rep
    q = randn((B, W, heads, head_dim), dtype, gen)
    kc = quantize(randn((B, max_len, Hkv, head_dim), dtype, gen))
    vc = quantize(randn((B, max_len, Hkv, head_dim), dtype, gen))
    pos_t = torch.as_tensor(pos, dtype=torch.int32, device="cuda")
    out = flash_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    if twice and not same(out, flash_decode_attend(q, kc, vc, pos_t, max_len,
                                                   n_rep)):
        fail(f"flash_decode_attend int8 {dtype} D={head_dim} n_rep={n_rep} "
             f"W={W}: two calls on the same inputs differ")
    ref = dense_decode_attend(q, kc, vc, pos_t, max_len, n_rep)
    ref32 = dense_decode_attend(q.float(), kc, vc, pos_t, max_len, n_rep)
    torch.cuda.synchronize()
    return errors(out, ref, ref32, head_dim=head_dim)


def edge_positions(chunk, max_len, W):
    """Eight slot positions at the edges of ``chunk``-position CTAs: 0,
    c - 1, c, 2c - 1 and the last row, then c + 1, 2c and 3c - 1, each
    capped at the last row ``max_len - W``."""
    last = max_len - W
    return [min(p, last) for p in (0, chunk - 1, chunk, 2 * chunk - 1, last,
                                   chunk + 1, 2 * chunk, 3 * chunk - 1)]


# The split rule's candidates (positions per CTA), timed by
# phase_decode_split; 1024 is one chunk per slot at the served max_len.
CHUNKS = (128, 256, 512, 1024)
SPLIT_TIE = 0.03


def decode_split_cases(dtype, gen, keep) -> int:
    """K2 and B9 in both operand forms at the edges of the split rule's
    chunks: at max_len 1024 and 1000 (no multiple of the chunk), at W *
    n_rep of 8 and 12 (two row blocks), and with each of CHUNKS stood in
    for the rule (the ring of stages, full and wrapped). Each case holds
    both kernels to the plain version, B9 to K2 bit for bit, and each to
    itself over two calls. Returns the number of cases."""
    from mpi_acx_torch.ops import flash_decode as fd
    n, sms = 0, sm_count()

    def case(int8, pt, W, n_rep, max_len, chunk=None):
        nonlocal n
        rule = fd.decode_chunk
        if chunk is not None:
            fd.decode_chunk = lambda *_, c=chunk: c
        try:
            c = fd.decode_chunk(8, H // n_rep, W * n_rep, max_len, sms)
            pos = edge_positions(c, max_len, W)
            e9, e2 = paged_errs((dtype, int8), pt, W, n_rep, pos, gen,
                                max_len=max_len)
        finally:
            fd.decode_chunk = rule
        n += 1
        sfx = "_int8" if int8 else ""
        desc = (f"B=8 W={W} n_rep={n_rep} Hq={H} D={D} max_len={max_len} "
                f"page_tokens={pt}, {c}-position chunks"
                + (" (stood in)" if chunk else "") + f", pos={pos}")
        for name, e in ((f"paged_flash_decode_attend{sfx}", e9),
                        (f"flash_decode_attend{sfx}", e2)):
            check(name, desc, dtype, e)
            keep(name, dtype, e)

    for int8 in (False, True):
        case(int8, 16, 1, 1, 1024)
        case(int8, 40, 1, 1, 1000)
        case(int8, 64, 4, 2, 1024)          # W * n_rep = 8
        case(int8, 128, 4, 3, 1024)         # 12: two row blocks of 8
        case(int8, 16, 1, 12, 1024)         # 12, one KV group
        for chunk in CHUNKS:
            case(int8, 128, 1, 1, 1024, chunk)
    return n


# Llama-3-8B's attention: 32 query heads over 8 KV groups, head dim 128.
LLAMA_H, LLAMA_HKV, LLAMA_D = 32, 8, 128
LLAMA_REP = LLAMA_H // LLAMA_HKV


def d128_cases(dtype, gen, keep, rows_seen) -> int:
    """The head dim 128 instantiations at Llama-3-8B's heads: K1 (B6) over
    the ragged edges of its tiles, causal and against Sk of 333 and 1000,
    on both CTA sizes; K2 in both operand forms with 8 KV groups of 4
    query heads, at W * n_rep of 4, 8 and 12, positions at the tiles' and
    the split rule's chunk edges, max_len 1024 and 1000, and with each
    candidate chunk stood in for the rule, each kernel equal to itself
    over two calls. Returns the number of K2 cases."""
    from mpi_acx_torch.ops import flash_decode as fd
    from mpi_acx_torch.ops.attention import block_rows
    sms, Hq, Dh = sm_count(), LLAMA_H, LLAMA_D
    for S, Sk, causal in ([(S, S, True) for S in (1, 63, 65, 127, 129, 200,
                                                   256, 512, 1000)]
                          + [(S, Sk, False) for S in (1, 129, 512)
                             for Sk in (333, 1000)]):
        e = k1_errs(S, Sk, causal, dtype, gen, heads=Hq, head_dim=Dh)
        rows = block_rows(1, S, Hq, sms)
        check("flash_attention_d128", f"B=1 S={S} Sk={Sk} causal={causal} "
              f"H={Hq} D={Dh}" + (f", {rows}-row CTAs"
                                  if dtype == torch.bfloat16 else ""),
              dtype, e)
        keep("flash_attention_d128", dtype, e)
        if dtype == torch.bfloat16:
            rows_seen.add(rows)
    n = 0

    def case(W, max_len, chunk=None):
        nonlocal n
        rule = fd.decode_chunk
        if chunk is not None:
            fd.decode_chunk = lambda *_, c=chunk: c
        try:
            c = fd.decode_chunk(8, LLAMA_HKV, W * LLAMA_REP, max_len, sms,
                                Dh)
            pos = edge_positions(c, max_len, W)
            args = (8, W, LLAMA_REP, pos, dtype, gen)
            kw = dict(max_len=max_len, heads=Hq, head_dim=Dh, twice=True)
            forms = (("flash_decode_attend_d128", k2_errs(*args, **kw)),
                     ("flash_decode_attend_int8_d128",
                      k2_int8_errs(*args, **kw)))
        finally:
            fd.decode_chunk = rule
        n += 1
        desc = (f"B=8 W={W} n_rep={LLAMA_REP} Hq={Hq} D={Dh} max_len="
                f"{max_len}, {c}-position chunks"
                + (" (stood in)" if chunk else "") + f", pos={pos}")
        for name, e in forms:
            check(name, desc, dtype, e)
            keep(name, dtype, e)

    case(1, 1024)
    case(1, 1000)
    case(2, 1024)                   # W * n_rep = 8
    case(3, 1024)                   # 12: two row blocks of 8
    case(4, 1024)                   # 16: the window pass, two full blocks
    case(4, SPEC_S + SPEC_NEW + SPEC_K)     # and at its cache's length
    for chunk in CHUNKS:
        case(1, 1024, chunk)
    return n


def e_size(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def tp_decode_cases(dtype, gen, keep) -> int:
    """K2 in both operand forms at one tensor-parallel rank's heads (tp =
    2): GPT-2's 6 KV heads at n_rep 1 (D = 64) and Llama-3-8B's 4 KV
    groups of 4 query heads (D = 128); W 1 (serving) and 4 (the TP
    speculative window), positions at the split rule's chunk edges,
    max_len 1024 and 1000, and each candidate chunk stood in for the
    rule; each kernel equal to itself over two calls, under the same
    limits. Returns the number of cases."""
    from mpi_acx_torch.ops import flash_decode as fd
    n, sms = 0, sm_count()
    for heads, n_rep, dh, sfx in ((H // 2, 1, D, ""),
                                  (LLAMA_H // 2, LLAMA_REP, LLAMA_D,
                                   "_d128")):
        def case(W, max_len, chunk=None):
            nonlocal n
            rule = fd.decode_chunk
            if chunk is not None:
                fd.decode_chunk = lambda *_, c=chunk: c
            try:
                c = fd.decode_chunk(8, heads // n_rep, W * n_rep, max_len,
                                    sms, dh)
                pos = edge_positions(c, max_len, W)
                args = (8, W, n_rep, pos, dtype, gen)
                kw = dict(max_len=max_len, heads=heads, head_dim=dh,
                          twice=True)
                forms = ((f"flash_decode_attend{sfx}", k2_errs(*args, **kw)),
                         (f"flash_decode_attend_int8{sfx}",
                          k2_int8_errs(*args, **kw)))
            finally:
                fd.decode_chunk = rule
            n += 1
            desc = (f"B=8 W={W} n_rep={n_rep} Hq={heads} D={dh} max_len="
                    f"{max_len} (one rank of tp = 2), {c}-position chunks"
                    + (" (stood in)" if chunk else "") + f", pos={pos}")
            for name, e in forms:
                check(name, desc, dtype, e)
                keep(name, dtype, e)

        case(1, 1024)
        case(1, 1000)
        case(4, 1024)
        case(4, SPEC_S + SPEC_NEW + SPEC_K)
        for chunk in CHUNKS:
            case(1, 1024, chunk)
    return n


def phase_kernels() -> dict:
    """Worst errors per kernel form and dtype over the slice's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}

    def keep(name, dtype, e):
        w = worst.setdefault((name, dtype), dict.fromkeys(e, 0.0))
        for key, val in e.items():
            w[key] = max(w[key], val)

    from mpi_acx_torch.ops.attention import block_rows, flash_attention
    slot_pos = [0, 63, 64, 500, 1023, 1, 255, 777]
    rows_seen = set()
    sms = sm_count()
    for dtype in (torch.bfloat16, torch.float32):
        cases1 = [(1, S, S, True) for S in (8, 200, 512, 1024)]
        cases1.append((1, 200, 333, False))
        # Ragged edges of the 64-row q tiles and the 128-key tiles.
        for S in (1, 63, 65, 127, 129, 1000):
            cases1 += [(1, S, S, True), (1, S, 333, False),
                       (1, S, 1000, False)]
        # 128-row CTAs whose last q tile has its second warpgroup's rows
        # wholly past S (S mod 128 in [1, 64]): its Q box is all zero fill.
        past = [(4, S, Sk, Sk == S) for S in (1025, 1088)
                for Sk in (S, 333, 1000)]
        for B, S, Sk, causal in cases1 + past:
            e = k1_errs(S, Sk, causal, dtype, gen, B=B)
            rows = block_rows(B, S, H, sms)
            check("flash_attention", f"B={B} S={S} Sk={Sk} causal={causal} "
                  f"H={H} D={D}" + (f", {rows}-row CTAs"
                                    if dtype == torch.bfloat16 else ""),
                  dtype, e)
            keep("flash_attention", dtype, e)
            if dtype == torch.bfloat16:
                rows_seen.add(rows)
                if (B, S, Sk, causal) in past and rows != 128:
                    fail(f"B={B} S={S} was to run on 128-row CTAs, not "
                         f"{rows}")
        # q, k, v as the model hands them over: strided views of one fused
        # qkv product, read in place through the tensor maps.
        for S in (129, 1000, 1024):
            n_copies = flash_attention.copies
            e = k1_check(*qkv_views(4, S, dtype, gen), True)
            rows = block_rows(4, S, H, sms)
            check("flash_attention", f"B=4 S=Sk={S} causal H={H} D={D}, "
                  f"q/k/v views of a fused qkv (seq stride {3 * H * D})"
                  + (f", {rows}-row CTAs" if dtype == torch.bfloat16
                     else ""), dtype, e)
            keep("flash_attention", dtype, e)
            if flash_attention.copies != n_copies:
                fail("K1's wrapper copied a strided view of the fused qkv")
            if dtype == torch.bfloat16:
                rows_seen.add(rows)
        # The views one rank of GPT-2's tensor-parallel split hands K1: its
        # Hl heads of a fused [B, S, 3 Hl D] product (tp = 2 and 4).
        for Hl in (H // 2, H // 4):
            for B, S in ((1, 129), (1, 512), (4, 1000)):
                n_copies = flash_attention.copies
                e = k1_check(*qkv_views(B, S, dtype, gen, heads=Hl), True)
                check("flash_attention", f"B={B} S=Sk={S} causal H={Hl} "
                      f"D={D}, one TP rank's q/k/v views (seq stride "
                      f"{3 * Hl * D}, k {Hl * D * e_size(dtype)} bytes in)",
                      dtype, e)
                keep("flash_attention", dtype, e)
                if flash_attention.copies != n_copies:
                    fail("K1's wrapper copied a TP rank's q/k/v view")
        cases2 = [(1, 1, slot_pos), (1, 1, 300),
                  (3, 2, [0, 63, 64, 500, 1021, 5, 255, 777])]
        for W, n_rep, pos in cases2:
            e = k2_errs(8, W, n_rep, pos, dtype, gen)
            check("flash_decode_attend", f"B=8 W={W} n_rep={n_rep} Hq={H} "
                  f"D={D} max_len=1024 pos={pos}", dtype, e)
            keep("flash_decode_attend", dtype, e)
            e = k2_int8_errs(8, W, n_rep, pos, dtype, gen)
            check("flash_decode_attend_int8", f"B=8 W={W} n_rep={n_rep} "
                  f"Hq={H} D={D} max_len=1024 pos={pos}", dtype, e)
            keep("flash_decode_attend_int8", dtype, e)
        # B9 over three page sizes, windows of 1 and 4, GQA and plain
        # heads, scalar and per-slot positions (0 and the last row among
        # them), in each operand form; bit-equal to K2 in every case.
        n_bit = 0
        for int8 in (False, True):
            name = ("paged_flash_decode_attend_int8" if int8
                    else "paged_flash_decode_attend")
            for pt in (16, 64, 128):
                for W, n_rep in ((1, 1), (4, 2), (1, 2), (4, 1)):
                    last = 1024 - W
                    for pos in (slot_pos[:7] + [last], 300, last):
                        e, _ = paged_errs((dtype, int8), pt, W, n_rep, pos,
                                          gen)
                        n_bit += 1
                        check(name, f"B=8 W={W} n_rep={n_rep} Hq={H} D={D} "
                              f"page_tokens={pt} pages=1024/{pt} shuffled, "
                              f"first page shared, pos={pos}", dtype, e)
                        keep(name, dtype, e)
        n_bit += decode_split_cases(dtype, gen, keep)
        n_tp = tp_decode_cases(dtype, gen, keep)
        print(f"K2 at one tensor-parallel rank's heads: equal to itself over "
              f"two calls in all {n_tp} {str(dtype)[6:]} cases of each "
              f"operand form", flush=True)
        print(f"B9 equal to K2 bit for bit on the same rows, and each equal "
              f"to itself over two calls, in all {n_bit} {str(dtype)[6:]} "
              f"cases (bf16/f32 and int8 caches)", flush=True)
        rows128 = set()
        n128 = d128_cases(dtype, gen, keep, rows128)
        print(f"head dim 128: K2 equal to itself over two calls in all "
              f"{n128} {str(dtype)[6:]} cases of each operand form", flush=True)
        if dtype == torch.bfloat16 and rows128 != {64, 128}:
            fail(f"phase 2's head dim 128 K1 cases reached only "
                 f"{sorted(rows128)}-row CTAs")
    if rows_seen != {64, 128}:
        fail(f"phase 2's K1 cases reached only {sorted(rows_seen)}-row CTAs")
    # An operand TMA cannot read in place (odd element offset): the wrapper
    # copies it, once, and the result is the same function.
    bf = torch.bfloat16
    q, k, v = (randn((1, 200, H, D), bf, gen) for _ in range(3))
    n_copies = flash_attention.copies
    e = k1_check(odd_offset(q), k, v, True)
    check("flash_attention", f"B=1 S=Sk=200 causal H={H} D={D}, q at an odd "
          f"element offset", bf, e)
    keep("flash_attention", bf, e)
    if flash_attention.copies != n_copies + 1:
        fail(f"an operand at an odd offset took "
             f"{flash_attention.copies - n_copies} copies, not 1")
    print(f"K1 cases on {sorted(rows_seen)}-row CTAs; the odd-offset operand "
          f"took the wrapper's copy", flush=True)
    return worst


# --- phase 2b --------------------------------------------------------------

STREAM_S = 16384        # B7's check and path: the streaming entry's auto rule
TRAIN_B, TRAIN_S = 4, 1024   # the training path's attention: B=4, S=1024


def b10_errs(S, Sk, causal, dtype, gen, B=TRAIN_B, heads=H, head_dim=D):
    """B10 against its plain version: ``errors`` on o, and the lse's max
    abs error against the plain version and against an f32 plain run on
    q as the kernel takes it (see TOL_LSE)."""
    from mpi_acx_torch.ops.attention import _reference_lse, \
        flash_attention_lse
    q = randn((B, S, heads, head_dim), dtype, gen)
    k = randn((B, Sk, heads, head_dim), dtype, gen)
    v = randn((B, Sk, heads, head_dim), dtype, gen)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    ref, ref_lse = _reference_lse(q, k, v, causal=causal)
    ref32, _ = _reference_lse(q.float(), k.float(), v.float(), causal=causal)
    # bf16: q scaled and rounded as the kernel takes it, then widened and
    # unscaled (the plain version scales the logits).
    scale = 1 / math.sqrt(head_dim)
    q_in = q.float() if dtype == torch.float32 else \
        (q.float() * scale).to(dtype).float() / scale
    _, lse32 = _reference_lse(q_in, k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    if lse.shape != (B, heads, S) or lse.dtype != torch.float32 \
            or not torch.isfinite(lse).all():
        fail(f"B10 lse: shape {tuple(lse.shape)} {lse.dtype} or non-finite")
    e = errors(o, ref, ref32, head_dim=head_dim)
    e["lse"] = (lse - ref_lse).abs().max().item()
    e["lse_f32"] = (lse - lse32).abs().max().item()
    return e


def check_lse(name, desc, dtype, e) -> None:
    print(f"kernel {name} {str(dtype)[6:]} {desc}: lse "
          f"max_abs_err {e['lse']:.3e} vs plain (tol {TOL_LSE[dtype]}), "
          f"{e['lse_f32']:.3e} vs f32 plain (tol {TOL_LSE_F32[dtype]})",
          flush=True)
    if not (e["lse"] <= TOL_LSE[dtype] and e["lse_f32"] <= TOL_LSE_F32[dtype]):
        fail(f"{name}'s lse disagrees with its plain version")


def band_reference(q, k, v, r0):
    """``attention_reference``'s recipe (causal, f32 softmax, probabilities
    in q's dtype) for the query rows [r0, r0 + len(q)) of a longer
    sequence, over the key prefix k, v [0, r0 + len(q))."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(
        q.shape[-1])
    rows = r0 + torch.arange(q.shape[1], device=q.device)[:, None]
    cols = torch.arange(k.shape[1], device=q.device)[None, :]
    logits = logits.masked_fill(cols > rows, -1e30)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def b7_errs(gen, heads=H, head_dim=D) -> dict:
    """B7, the streaming entry point (``streaming=None`` turns it on at
    Sk=16384), against the plain version on three bands of 128 query rows
    (the first, the middle, the last), each over its whole key prefix."""
    from mpi_acx_torch.ops.attention import flash_attention
    bf = torch.bfloat16
    name, counter = stream_form(head_dim)
    q, k, v = (randn((1, STREAM_S, heads, head_dim), bf, gen)
               for _ in range(3))
    n0 = getattr(flash_attention, counter)
    out = flash_attention(q, k, v)
    if getattr(flash_attention, counter) != n0 + 1:
        fail(f"flash_attention at Sk=16384, D={head_dim}, did not take the "
             f"streaming entry")
    worst = {}
    for r0 in (0, STREAM_S // 2 - 64, STREAM_S - 128):
        r1 = r0 + 128
        ref = band_reference(q[:, r0:r1], k[:, :r1], v[:, :r1], r0)
        ref32 = band_reference(q[:, r0:r1].float(), k[:, :r1].float(),
                               v[:, :r1].float(), r0)
        torch.cuda.synchronize()
        e = errors(out[:, r0:r1], ref, ref32, head_dim=head_dim)
        check(name, f"B=1 S=Sk={STREAM_S} causal H={heads} D={head_dim}, "
              f"rows [{r0}, {r1}) over keys [0, {r1})", bf, e)
        for key, val in e.items():
            worst[key] = max(worst.get(key, 0.0), val)
    return worst


def grads(fn, xs, cts):
    """dq, dk, dv of ``fn(q, k, v)`` (one output or a tuple) under the
    cotangents ``cts``."""
    xs = [x.detach().requires_grad_() for x in xs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, xs, cts)


# The backward's cases: (B, S = Sk, causal). The second is a ring step's
# non-causal block at tp = 2 (phase 7c: an earlier K/V block of 512
# positions, 2 sequences a dp rank), whose lse cotangent the ring's
# logaddexp merge makes nonzero.
BACKWARD_CASES = ((TRAIN_B, TRAIN_S, True), (2, 512, False))


def phase_backward(gen, heads=H, head_dim=D) -> dict:
    """The backward of flash_attention and flash_attention_lse (through the
    kernels' forwards) against autograd through the plain versions, with
    random dO and dLSE: at the training shape, causal, and at a ring step's
    non-causal block (flash_attention_lse alone, which the ring calls)."""
    from mpi_acx_torch.ops.attention import _reference_lse, \
        attention_reference, flash_attention, flash_attention_lse
    worst = {}
    for (B, S, causal), dtype in itertools.product(
            BACKWARD_CASES, (torch.bfloat16, torch.float32)):
        shape = (B, S, heads, head_dim)
        xs = [randn(shape, dtype, gen) for _ in range(3)]
        do = randn(shape, dtype, gen)
        dlse = randn((B, heads, S), torch.float32, gen)
        x32 = [x.float() for x in xs]
        forms = (("flash_attention", flash_attention, attention_reference,
                  (do,), (do.float(),)),
                 ("flash_attention_lse", flash_attention_lse, _reference_lse,
                  (do, dlse), (do.float(), dlse)))
        for name, kern, plain, cts, cts32 in forms[0 if causal else 1:]:
            kern = functools.partial(kern, causal=causal)
            plain = functools.partial(plain, causal=causal)
            got = grads(kern, xs, cts)
            ref = grads(plain, xs, cts)
            ref32 = grads(plain, x32, cts32)
            torch.cuda.synchronize()
            tol = (TOL_GRAD_D128 if head_dim == 128 else TOL_GRAD)[dtype]
            bad = []
            for gname, g, r, r32 in zip(("dq", "dk", "dv"), got, ref, ref32):
                e = errors(g, r, r32, rms_floor=GRAD_RMS_FLOOR,
                           head_dim=head_dim)
                print(f"backward {name} {str(dtype)[6:]} {gname} B={B} "
                      f"S=Sk={S} H={heads} D={head_dim} causal={causal}: "
                      f"max_abs_err {e['abs']:.3e} (tol {tol['abs']}), row err "
                      f"{e['row']:.3e} vs plain (tol {tol['row']}), "
                      f"{e['row_f32']:.3e} vs f32 plain (tol "
                      f"{tol['row_f32']}); plain's own row err vs f32 "
                      f"{e['plain_row_f32']:.3e}", flush=True)
                if not all(e[key] <= tol[key] for key in tol):
                    bad.append(gname)
                w = worst.setdefault(dtype, dict.fromkeys(e, 0.0))
                for key, val in e.items():
                    w[key] = max(w[key], val)
            if bad:
                fail(f"the backward of {name} ({', '.join(bad)}, {dtype}, "
                     f"D={head_dim}, causal={causal}) disagrees with "
                     f"autograd through the plain version")
    print(f"backward check passed: dq, dk, dv of flash_attention and "
          f"flash_attention_lse at H={heads} D={head_dim} (and the "
          f"non-causal ring block) within limits in bf16 and f32",
          flush=True)
    return worst


def lse_form(head_dim):
    """(name in the kernels line, counter) of B10 at ``head_dim``."""
    return (("flash_attention_lse_d128", "launches_d128") if head_dim == 128
            else ("flash_attention_lse", "launches"))


def stream_form(head_dim):
    """(name in the kernels line, counter) of B7 at ``head_dim``."""
    return (("flash_attention_stream_d128", "launches_stream_d128")
            if head_dim == 128 else
            ("flash_attention_stream", "launches_stream"))


# The training paths' attention geometries (heads, head dim): GPT-2 and
# the MoE family, and Llama-3-8B (32 query heads; the ring broadcasts its 8
# KV groups before B10, so the kernel sees 32 heads of K/V).
TRAIN_HEADS = ((H, D), (LLAMA_H, LLAMA_D))


def phase_train_kernels() -> dict:
    """Phase 2b, at each of TRAIN_HEADS: B10 in both dtypes over causal
    S = Sk of 64, 1000, 1024, 1025 and 1088 and four non-causal Sk != S at
    B=4 (at S = 1025 and 1088 the last 128-row CTA's second warpgroup lies
    wholly past S); B7 at S = Sk = 16384 (bf16); the backward. Returns the
    worst errors per (kernel form, dtype)."""
    from mpi_acx_torch.ops.attention import block_rows
    gen = torch.Generator(device="cuda").manual_seed(10)
    worst = {}
    sms = sm_count()
    for heads, head_dim in TRAIN_HEADS:
        name = lse_form(head_dim)[0]
        for dtype in (torch.bfloat16, torch.float32):
            w = {}
            for S, Sk, causal in ((64, 64, True), (1000, 1000, True),
                                  (1024, 1024, True), (512, 1000, False),
                                  (1024, 64, False), (1025, 1025, True),
                                  (1088, 1088, True), (1025, 333, False),
                                  (1088, 1000, False)):
                e = b10_errs(S, Sk, causal, dtype, gen, heads=heads,
                             head_dim=head_dim)
                rows = block_rows(TRAIN_B, S, heads, sms)
                desc = (f"B={TRAIN_B} S={S} Sk={Sk} causal={causal} "
                        f"H={heads} D={head_dim}"
                        + (f", {rows}-row CTAs" if dtype == torch.bfloat16
                           else ""))
                if dtype == torch.bfloat16 and S in (1025, 1088) \
                        and rows != 128:
                    fail(f"B10 at B={TRAIN_B} S={S} H={heads} was to run on "
                         f"128-row CTAs, not {rows}")
                check(name, desc, dtype, e)
                check_lse(name, desc, dtype, e)
                for key, val in e.items():
                    w[key] = max(w.get(key, 0.0), val)
            worst[(name, dtype)] = w
        worst[(stream_form(head_dim)[0], torch.bfloat16)] = b7_errs(
            gen, heads, head_dim)
        worst[("backward", head_dim)] = phase_backward(gen, heads, head_dim)
    return worst


# --- phases 3 and 4 --------------------------------------------------------

def attention_counters():
    """(name in the kernels line, wrapper, counter attribute) of every
    attention kernel form."""
    from mpi_acx_torch.ops.attention import flash_attention, \
        flash_attention_lse
    from mpi_acx_torch.ops.flash_decode import flash_decode_attend, \
        paged_flash_decode_attend
    return [("flash_attention", flash_attention, "launches"),
            ("flash_attention_d128", flash_attention, "launches_d128"),
            ("flash_attention_stream", flash_attention, "launches_stream"),
            ("flash_attention_stream_d128", flash_attention,
             "launches_stream_d128"),
            ("flash_attention_lse", flash_attention_lse, "launches"),
            ("flash_attention_lse_d128", flash_attention_lse,
             "launches_d128"),
            ("flash_decode_attend", flash_decode_attend, "launches"),
            ("flash_decode_attend_int8", flash_decode_attend,
             "launches_int8"),
            ("flash_decode_attend_d128", flash_decode_attend,
             "launches_d128"),
            ("flash_decode_attend_int8_d128", flash_decode_attend,
             "launches_int8_d128"),
            ("paged_flash_decode_attend", paged_flash_decode_attend,
             "launches"),
            ("paged_flash_decode_attend_int8", paged_flash_decode_attend,
             "launches_int8")]


def reset_counts():
    from mpi_acx_torch.ops.attention import flash_attention
    for _, fn, attr in attention_counters():
        setattr(fn, attr, 0)
    flash_attention.copies = 0


def check_no_copies(label, copies=None) -> None:
    """The path since the last reset_counts handed K1 only operands its
    tensor maps read in place: the wrapper copied none."""
    from mpi_acx_torch.ops.attention import flash_attention
    copies = flash_attention.copies if copies is None else copies
    print(f"{label}: K1 operand copies {copies}", flush=True)
    if copies:
        fail(f"{label}: K1's wrapper copied {copies} operands")


def read_counts(names=None):
    """Launch counts of the attention kernel forms (those in ``names``,
    or every one)."""
    return {name: getattr(fn, attr) for name, fn, attr in attention_counters()
            if names is None or name in names}


def prefill_counts(fns):
    """The counters of the prefills served through ``fns``' slot cache
    (decoding.PrefillGraphs): (replayed, eager, captures)."""
    pg = fns.slots.cache.prefills
    return pg.replayed, pg.eager, pg.captures


def check_prefills(label, fns, prefills, before=(0, 0, 0), warm=False):
    """The prefills of a serve call through ``fns``, whose counters read
    ``before`` as it started: every one seated and replayed from its
    bucket's capture; with a fresh slot cache the first run eagerly, one
    capture a bucket; after a warm-up (``warm``) that served every bucket,
    none run eagerly or captured. Returns (replayed, eager, captures) in
    the call."""
    pg = fns.slots.cache.prefills
    got = tuple(a - b for a, b in zip(prefill_counts(fns), before))
    print(f"{label}: prefills {prefills}: replayed {got[0]}, eager "
          f"{got[1]}, captures {got[2]}; by bucket since the slot cache was "
          f"drawn {json.dumps(pg.buckets)}", flush=True)
    want = ((prefills, 0, 0) if warm else
            (prefills - 1, 1, len(pg.buckets)))
    if got != want:
        fail(f"{label}: prefills replayed, eager, captured {got}, want "
             f"{want}")
    return got


def forward_logits(fam, params, cfg, toks):
    """The family's forward logits (the MoE family's forward also returns
    its router losses)."""
    out = fam.forward(params, cfg, toks)
    return out[0] if isinstance(out, tuple) else out


@contextlib.contextmanager
def recorded_routes(log=None):
    """Every router call's f32 gate logits and top-k, in call order, into
    ``log`` (a new list by default) while the block runs (``moe._route``
    wrapped; nothing is copied)."""
    from mpi_acx_torch.models import moe
    route = moe._route
    log = [] if log is None else log

    def rec(params, x, cfg, E):
        out = route(params, x, cfg, E)
        log.append((out[0].detach(), cfg.top_k))
        return out

    moe._route = rec
    try:
        yield log
    finally:
        moe._route = route


def route_flips(kernel_log, plain_log):
    """The routing decisions (a token's top-k experts in one router call)
    that differ between two runs over the same tokens: (differing, all,
    the plain run's largest gate margin at a differing one, its smallest
    margin over all), the margin being the gap between the k-th and the
    (k+1)-th largest gate."""
    from mpi_acx_torch.models import moe
    if len(kernel_log) != len(plain_log):
        fail(f"router calls differ: {len(kernel_log)} against "
             f"{len(plain_log)}")
    apart, total, at_flip, least = 0, 0, 0.0, math.inf
    for (gk, k), (gp, _) in zip(kernel_log, plain_log):
        differ = (moe._top_k(gk, k) != moe._top_k(gp, k)).any(-1)
        top = gp.topk(k + 1, dim=-1).values
        margin = top[:, k - 1] - top[:, k]
        apart += int(differ.sum())
        total += differ.numel()
        least = min(least, margin.min().item())
        if differ.any():
            at_flip = max(at_flip, margin[differ].max().item())
    return apart, total, at_flip, least


def plain_logits(params, plain, ctx, S, int8, fam=None):
    """The plain path's next-token logits after ``ctx`` (a served sequence
    cut where two paths diverge): a forward pass, or with ``int8`` the
    int8-cache decode the server ran (the prompt's ``S`` tokens prefilled
    into an int8 cache, then one decode step per generated token).
    ``fam`` is the model family's module (GPT-2's by default)."""
    from mpi_acx_torch.models import transformer
    tfm = fam or transformer
    toks = torch.as_tensor(ctx, device="cuda")[None]
    if not int8:
        return forward_logits(tfm, params, plain, toks)[0, -1]
    logits, cache = tfm.prefill(params, plain, toks[:, :S], len(ctx),
                                last_only=True, kv_int8=True)
    logits = logits[0, -1]
    for j in range(S, len(ctx)):
        logits, cache = tfm.decode_step(params, plain, cache, toks[:, j])
        logits = logits[0]
    return logits


def compare_paths(label, params, cfg, got, want, prompts,
                  int8=False, fam=None, tie=None, ref=None,
                  routes=False) -> None:
    """Hold the kernel path's served tokens (``got``) to the plain path's
    (``want``). A divergence passes only at a tie: the plain path's logits
    of the two tokens at that step, recomputed over the common prefix
    (:func:`plain_logits`), differ by less than TIE. Then, for a bf16/f32
    cache, the two paths' logits over every served sequence (forward
    passes, so K1 at every length the sequences reach) must agree within
    TIE. ``fam`` is the model family's module (GPT-2's by default);
    ``tie`` the limit (TIE of the config's dtype by default). With ``ref``,
    ``(params, config)`` of the same model in f32, both paths' forwards are
    also held to its forward: the kernel path's logits must lie no farther
    from it (RMS over the served positions) than the plain path's. With
    ``routes`` (the MoE family) the two forwards' routing decisions are
    compared (:func:`route_flips`) and printed; in f32 a decision may
    differ only where the plain path's gate margin is below the tie."""
    from mpi_acx_torch.models import serving, transformer
    tfm = fam or transformer
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    tie = TIE[cfg.dtype] if tie is None else tie
    ties, spread, sq, n = [], 0.0, 0.0, 0
    forced = [0, 0, 0.0]    # argmax apart, positions, largest plain margin
    to_ref = {"kernel": 0.0, "plain": 0.0}     # squared error against ref
    flips = [0, 0, 0.0, math.inf]
    record = recorded_routes if routes else (
        lambda: contextlib.nullcontext([]))
    for rid, (g, w) in enumerate(zip(got, want)):
        for o in (g, w):
            if isinstance(o, serving.RequestRejected):
                fail(f"{label} request {rid} rejected: {o.detail}")
        if not np.array_equal(g, w):
            t = int(np.argmax(g != w))      # first differing position
            lp = plain_logits(params, plain, w[:t], len(prompts[rid]), int8,
                              tfm)
            margin = (lp[int(w[t])] - lp[int(g[t])]).item()
            print(f"{label} request {rid}: tokens diverge at position {t} "
                  f"of {len(w)} (kernel {g[t]}, plain {w[t]}): plain logit "
                  f"margin {margin:.4e} (tie below {tie})", flush=True)
            if not abs(margin) < tie:
                fail(f"{label} request {rid}: divergence at a logit margin "
                     f"{margin:.4e}, not a tie")
            ties.append(rid)
        if int8:
            continue
        seq = torch.as_tensor(w[:-1], device="cuda")[None]
        with record() as rk:
            lk = forward_logits(tfm, params, cfg, seq)[
                0, len(prompts[rid]) - 1:]
        with record() as rp:
            lp = forward_logits(tfm, params, plain, seq)[
                0, len(prompts[rid]) - 1:]
        if routes:
            f = route_flips(rk, rp)
            flips = [flips[0] + f[0], flips[1] + f[1], max(flips[2], f[2]),
                     min(flips[3], f[3])]
        spread = max(spread, (lk - lp).abs().max().item())
        sq += (lk - lp).double().square().sum().item()
        n += lk.numel()
        # Teacher-forced: both paths' next-token argmax at every served
        # position of the same sequence, and where they differ the plain
        # path's margin between the two (reported, not held).
        ak, ap = lk.argmax(-1), lp.argmax(-1)
        apart = ak != ap
        forced[0] += int(apart.sum())
        forced[1] += ak.numel()
        if apart.any():
            gap = (lp.gather(-1, ap[:, None]) - lp.gather(-1, ak[:, None]))
            forced[2] = max(forced[2], gap[apart].max().item())
        if ref is not None:
            l32 = forward_logits(tfm, *ref, seq)[0, len(prompts[rid]) - 1:]
            for key, lx in (("kernel", lk), ("plain", lp)):
                to_ref[key] += (lx - l32).double().square().sum().item()
    print(f"{label}: kernel path vs plain path: tokens equal in "
          f"{len(got) - len(ties)} of {len(got)} requests, ties in {ties}"
          + ("" if int8 else f"; max |logit difference| over the served "
             f"positions {spread:.4e} (tol {tie}), RMS "
             f"{math.sqrt(sq / n):.4e}; teacher-forced argmax apart at "
             f"{forced[0]} of {forced[1]} positions, plain margins there up "
             f"to {forced[2]:.4e}"), flush=True)
    if routes and not int8:
        print(f"{label}: routing decisions apart between the two paths' "
              f"forwards: {flips[0]} of {flips[1]} (router calls x tokens), "
              f"the plain path's gate margin there up to {flips[2]:.4e}; "
              f"smallest plain margin anywhere {flips[3]:.4e}", flush=True)
        if cfg.dtype == torch.float32 and flips[0] and not flips[2] < tie:
            fail(f"{label}: a routing decision differs at a gate margin "
                 f"{flips[2]:.4e}, not a tie")
    if not spread < tie:
        fail(f"{label}: kernel-path logits differ from the plain path's by "
             f"{spread:.4e}")
    if ref is not None:
        rms = {k: math.sqrt(v / n) for k, v in to_ref.items()}
        print(f"{label}: logits against an f32 forward of the same weights, "
              f"RMS over the served positions: kernel path {rms['kernel']:.4e}"
              f", plain path {rms['plain']:.4e}", flush=True)
        if not rms["kernel"] <= rms["plain"]:
            fail(f"{label}: the kernel path lies farther from f32 than the "
                 f"plain path")


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
    counts = read_counts(("flash_attention", "flash_decode_attend"))
    check_no_copies("f32 serve")
    want = serving.serve_greedy(params32, plain, prompts, n_new, n_slots=3,
                                max_len=256, chunk=4)
    if min(counts.values()) == 0:
        fail(f"f32 kernel serve did not launch every kernel: {counts}")
    if got.metrics.requeues or want.metrics.requeues:
        fail("f32 serve requeued a request after a failed step")
    compare_paths("f32 serve (8 requests, 3 slots, GPT-2 124M full width)",
                  params32, cfg, got, want, prompts)
    print(f"f32 serve launches {counts}", flush=True)


def serve_requests(vocab):
    """Phase 4's requests: 16 prompts of 32/128/256/512 tokens asking for
    16/64/128/32 new tokens."""
    rng = np.random.default_rng(2)
    lens = [32, 128, 256, 512]
    news = [16, 64, 128, 32]
    prompts = [rng.integers(0, vocab, lens[i % 4]).astype(np.int32)
               for i in range(16)]
    return prompts, [news[i % 4] for i in range(16)]


def check_served(label, res, prompts, n_new, vocab) -> None:
    """Every request served in full: its prompt, then n_new tokens in the
    vocabulary; no requeue, no rejection."""
    from mpi_acx_torch.models import serving
    for rid, (o, p, n) in enumerate(zip(res, prompts, n_new)):
        if isinstance(o, serving.RequestRejected):
            fail(f"{label} request {rid} rejected: {o.detail}")
        gen = o[len(p):]
        if (len(o) != len(p) + n or not np.array_equal(o[:len(p)], p)
                or gen.min() < 0 or gen.max() >= vocab):
            fail(f"{label} request {rid}: wrong output ({len(o)} tokens)")
    if res.metrics.requeues or res.metrics.rejections:
        fail(f"{label} requeued {res.metrics.requeues}, rejected "
             f"{res.metrics.rejections}")


def exactly_equal(label, got, want) -> None:
    """Two serve calls' outputs equal token for token."""
    for rid, (g, w) in enumerate(zip(got, want)):
        if not np.array_equal(g, w):
            t = int(np.argmax(g != w))
            fail(f"{label}: request {rid} differs at position {t} ({g[t]} "
                 f"vs {w[t]})")


def served_figures(m) -> str:
    return (f"{m.new_tokens} tokens in {m.wall_s:.3f} s = "
            f"{m.tokens_per_s:.1f} tokens/s, TTFT p50 "
            f"{m.ttft_p50_s * 1e3:.2f} ms, ITL p50 {m.itl_p50_s * 1e3:.3f} "
            f"ms, {m.steps} steps")


# One-rank served tokens of phases 4, 4b, 4c and 4d, by run: phase 7d holds
# the tensor-parallel serves of the same requests to them.
SERVED = {}


def phase_serve(params16, card_str):
    from mpi_acx_torch.models import serving, transformer as tfm
    cfg = tfm.gpt2_small()
    prompts, n_new = serve_requests(cfg.vocab)
    # Warm-up: library load, cuBLAS handles and allocator pools.
    serving.serve_greedy(params16, cfg, prompts[:2], 4, n_slots=8,
                         max_len=1024, chunk=8)
    fns = serving.make_server_fns(params16, cfg, tfm, chunk=8)
    torch.cuda.synchronize()
    reset_counts()
    res = serving.serve_greedy(params16, cfg, prompts, n_new, n_slots=8,
                               max_len=1024, chunk=8, server_fns=fns)
    torch.cuda.synchronize()
    counts = read_counts(("flash_attention", "flash_decode_attend"))
    check_no_copies("bf16 serve")
    check_served("bf16 serve", res, prompts, n_new, cfg.vocab)
    check_prefills("bf16 serve", fns, res.metrics.prefills)
    print(f"serve bf16 GPT-2 124M: 16 requests, 8 slots, max_len 1024, "
          f"chunk 8: {served_figures(res.metrics)} [{card_str}]", flush=True)
    print(f"launches during serve: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        fail(f"a kernel of the serving path never launched: {counts}")
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    want = serving.serve_greedy(params16, plain, prompts, n_new, n_slots=8,
                                max_len=1024, chunk=8)
    compare_paths("bf16 serve (16 requests, 8 slots)", params16, cfg, res,
                  want, prompts)
    SERVED["gpt2_bf16"] = [np.asarray(o) for o in res]
    return counts, res


# --- phase 4b --------------------------------------------------------------

PAGE_TOKENS = 128
PRESSURE_PAGES = 16     # the cold schedule peaks at 24 pages of the 64


def phase_paged(params16, fixed, card_str) -> dict:
    """Phase 4's requests through the paged server and the int8 caches
    (see the module docstring, 4b). ``fixed`` is phase 4's kernel-path
    result. Returns the launch counts of the decode kernel forms over the
    four runs (a)-(d) (K1 launches there too)."""
    from mpi_acx_torch.models import serving, transformer as tfm
    cfg = tfm.gpt2_small()
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    prompts, n_new = serve_requests(cfg.vocab)
    kw = dict(n_slots=8, max_len=1024, chunk=8)
    pkw = dict(kw, page_tokens=PAGE_TOKENS)

    # (d)'s requests: a 256-token system prompt and suffixes of 16-40.
    rng = np.random.default_rng(5)
    system = rng.integers(0, cfg.vocab, 2 * PAGE_TOKENS).astype(np.int32)
    shared = [np.concatenate([system, rng.integers(
        0, cfg.vocab, 16 + 8 * (i % 4)).astype(np.int32)]) for i in range(16)]
    # Warm-up of the new paths (first launches, allocator pools, and the
    # prefix-hit prefill's shapes, one per suffix bucket).
    for int8 in (False, True):
        serving.serve_paged_greedy(params16, cfg, prompts[:2], 4,
                                   kv_int8=int8, **pkw)
    serving.serve_greedy(params16, cfg, prompts[:2], 4, kv_int8=True, **kw)
    serving.serve_paged_greedy(params16, cfg, shared[:4], 4,
                               prefix_cache=True, **pkw)
    torch.cuda.synchronize()
    print(f"paged serve, phase 4 fixed-slot figures for comparison: "
          f"{served_figures(fixed.metrics)} [{card_str}]", flush=True)

    def run(label, fn, **extra):
        res = fn(params16, cfg, prompts_run, n_new_run, **extra)
        torch.cuda.synchronize()
        check_served(label, res, prompts_run, n_new_run, cfg.vocab)
        m = res.metrics
        print(f"{label}: {served_figures(m)}, pages_hwm {m.pages_hwm}, "
              f"preemptions {m.preemptions}, prefix_hits {m.prefix_hits} "
              f"[{card_str}]", flush=True)
        return res

    reset_counts()
    prompts_run, n_new_run = prompts, n_new
    # (a) bf16 pages through B9: phase 4's tokens exactly.
    paged = run("(a) paged bf16, 128-token pages, 64 pages",
                serving.serve_paged_greedy, **pkw)
    exactly_equal("(a) paged bf16 vs fixed-slot (phase 4)", paged, fixed)
    # (b) int8 caches: K2's int8 form (fixed slots) and B9's (pages).
    fixed8 = run("(b) fixed-slot int8", serving.serve_greedy, kv_int8=True,
                 **kw)
    paged8 = run("(b) paged int8", serving.serve_paged_greedy, kv_int8=True,
                 **pkw)
    exactly_equal("(b) paged int8 vs fixed-slot int8", paged8, fixed8)
    SERVED["gpt2_int8"] = [np.asarray(o) for o in fixed8]
    # (c) page pressure: preempted requests replay the same tokens.
    pressed = run(f"(c) paged bf16, {PRESSURE_PAGES} pages",
                  serving.serve_paged_greedy, n_pages=PRESSURE_PAGES, **pkw)
    if pressed.metrics.preemptions == 0:
        fail(f"(c) a {PRESSURE_PAGES}-page pool preempted nothing")
    exactly_equal("(c) paged under page pressure vs (a)", pressed, paged)
    # (d) a shared 256-token system prompt, prefix cache on and off.
    prompts_run, n_new_run = shared, [32] * 16
    hit = run("(d) shared system prompt, prefix cache on",
              serving.serve_paged_greedy, prefix_cache=True, **pkw)
    cold = run("(d) shared system prompt, prefix cache off",
               serving.serve_paged_greedy, **pkw)
    counts = read_counts(("flash_decode_attend_int8",
                          "paged_flash_decode_attend",
                          "paged_flash_decode_attend_int8"))
    check_no_copies("paged serve (a)-(d)")
    m = hit.metrics
    if not (m.prefix_hits >= 15 and m.prefix_pages_reused > 0
            and m.pages_hwm < cold.metrics.pages_hwm):
        fail(f"(d) prefix cache: {m.prefix_hits} hits, "
             f"{m.prefix_pages_reused} pages reused, pages_hwm "
             f"{m.pages_hwm} vs {cold.metrics.pages_hwm} cold")
    print(f"(d) prefix cache: {m.prefix_hits} hits, "
          f"{m.prefix_pages_reused} pages reused, pages_hwm {m.pages_hwm} "
          f"vs {cold.metrics.pages_hwm} cold", flush=True)
    print(f"launches during paged serve: {json.dumps(counts)}", flush=True)
    if min(counts.values()) == 0:
        fail(f"a decode kernel form of the paged path never launched: "
             f"{counts}")
    compare_paths("(d) prefix hits vs cold", params16, cfg, hit, cold,
                  prompts_run)
    prompts_run, n_new_run = prompts, n_new
    for label, fn, got, extra in (
            ("(b) fixed-slot int8", serving.serve_greedy, fixed8, kw),
            ("(b) paged int8", serving.serve_paged_greedy, paged8, pkw)):
        want = fn(params16, plain, prompts, n_new, kv_int8=True, **extra)
        compare_paths(f"{label} vs its plain path", params16, cfg, got, want,
                      prompts, int8=True)
    return counts


# --- phase 5 ---------------------------------------------------------------

def bound_ms(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                 else "bytes")


# (B, S, heads, head dim)
CTA_SHAPES = tuple((B, S, H, D) for B, S in (
    (1, 32), (1, 128), (1, 256), (1, 512),  # B6's buckets
    (1, 704), (1, 768),     # 132 and 144 CTAs of 64 rows
    (4, 129), (4, 1024)))   # B=4: 144 and 768 CTAs of 64 rows
# Llama-3-8B's prefill buckets (32 heads, D = 128): 32-128 CTAs of 64 rows
# up to S = 256, then 160 and 256.
LLAMA_CTA_SHAPES = ((1, 32, 32, 128), (1, 128, 32, 128), (1, 256, 32, 128),
                    (1, 320, 32, 128), (1, 512, 32, 128))


def phase_cta_sizes(card_str, shapes=CTA_SHAPES) -> None:
    """K1's bf16 kernel timed with each CTA size at the same shapes,
    causal, through the wrapper with its rule stood in for, in the order
    64, 128, 128, 64 rows (the means are printed): at B6's four buckets and
    on either side of the rule's one-wave boundary."""
    from mpi_acx_torch.ops import attention as attn
    gen = torch.Generator(device="cuda").manual_seed(4)
    rule, sms, agree = attn.block_rows, sm_count(), 0
    for B, S, Hs, Dh in shapes:
        q, k, v = (randn((B, S, Hs, Dh), torch.bfloat16, gen)
                   for _ in range(3))
        ts = {64: [], 128: []}
        try:
            for rows in (64, 128, 128, 64):
                attn.block_rows = lambda *_, r=rows: r
                ts[rows].append(time_ms(
                    lambda: attn.flash_attention(q, k, v), iters=200))
        finally:
            attn.block_rows = rule
        t = {r: float(np.mean(x)) for r, x in ts.items()}
        pick = rule(B, S, Hs, sms)
        faster = min(t, key=t.get)
        agree += pick == faster
        print(f"time flash_attention bf16 B={B} S={S} H={Hs} D={Dh} causal "
              f"by CTA size: 64 rows {t[64]:.5f} ms ({B * Hs * -(-S // 64)} "
              f"CTAs), 128 rows {t[128]:.5f} ms ({B * Hs * -(-S // 128)} "
              f"CTAs), 64/128 {t[64] / t[128]:.3f}; the rule picks {pick} "
              f"[{card_str}]", flush=True)
    print(f"K1's CTA-size rule picked the faster size at {agree} of "
          f"{len(shapes)} shapes ({sms} SMs)", flush=True)


def k1_timing(card_str, heads, head_dim, label) -> dict:
    """K1 at the four prefill buckets of the serving phase (4 prefills
    each, so the mean over the buckets is the mean per launch on that
    path), B = 1, causal, beside its plain version, SDPA and its bound."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops.attention import attention_reference, \
        block_rows, flash_attention
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    rows = []
    for S in (32, 128, 256, 512):
        q, k, v = (randn((1, S, heads, head_dim), bf, gen) for _ in range(3))
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        t_k = time_ms(lambda: flash_attention(q, k, v))
        t_p = time_ms(lambda: attention_reference(q, k, v))
        t_l = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True))
        flops = 4 * heads * head_dim * S * (S + 1) / 2
        nbytes = 4 * S * heads * head_dim * 2
        b_ms, b_by = bound_ms(flops, nbytes, bf)
        rows.append((t_k, t_p, t_l, flops, nbytes))
        print(f"time flash_attention {label}bf16 B=1 S={S} H={heads} "
              f"D={head_dim} causal, "
              f"{block_rows(1, S, heads, sm_count())}-row CTAs: kernel "
              f"{t_k:.4f} ms "
              f"({flops / t_k / 1e9:.1f} TFLOP/s), plain {t_p:.4f} ms, "
              f"library (sdpa) {t_l:.4f} ms, bound {b_ms:.5f} ms ({b_by}) "
              f"[{card_str}]", flush=True)
    mean = np.mean(rows, axis=0)
    b_ms, b_by = bound_ms(mean[3], mean[4], bf)
    return dict(ms=mean[0], plain_ms=mean[1], library_ms=mean[2],
                bound_ms=b_ms, bound_by=b_by)


def phase_timing(card_str) -> dict:
    out = {"flash_attention": k1_timing(card_str, H, D, "")}
    out.update(phase_decode_timing(card_str))
    return out


def decode_bytes(live, B, int8, paged, max_pages=0, hkv=H, hq=H,
                 head_dim=D):
    """Bytes a decode call at W = 1 must move (GPT-2's 12 heads unless
    told otherwise): the live K/V rows of the ``hkv`` groups (int8 codes
    and their f32 scales, or bf16), q and the output of the ``hq`` query
    heads, pos, and for the paged form the table."""
    return (live * hkv * head_dim * (1 if int8 else 2) * 2
            + (live * hkv * 4 * 2 if int8 else 0)
            + 2 * B * hq * head_dim * 2 + B * 4
            + (B * max_pages * 4 if paged else 0))


def phase_decode_timing(card_str) -> dict:
    """K2, K2-int8, B9 and B9-int8 at the phase-4 decode shape (B = 8, W = 1,
    positions 40/160/320/528 twice, 12 layers' caches rotated so each call
    finds its cache cold in L2, as the decode step does; B9 over 128-token
    pages in shuffled order, timed in turns with K2 on the same rows), each
    beside its plain version, the library call where one exists, and its
    bound; then K2 and B9 with every slot at its last row (the full cache);
    the split rule's candidates at both shapes (phase_decode_split); and
    the wrapper's host cost per call."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend, paged_flash_decode_attend, paged_gather_attend
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf = torch.bfloat16
    out = {}
    B, max_len, L = 8, 1024, 12
    pos_l = [40, 160, 320, 528, 40, 160, 320, 528]
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    full = torch.full((B,), max_len - 1, dtype=torch.int32, device="cuda")
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
    nbytes = decode_bytes(live, B, False, False)
    b_ms, b_by = bound_ms(4 * live * H * D, nbytes, bf)
    print(f"time flash_decode_attend bf16 B={B} W=1 H={H} D={D} max_len="
          f"{max_len} pos={pos_l}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
          f"library (sdpa, length mask) {t_l:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}) [{card_str}]", flush=True)
    out["flash_decode_attend"] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                                      bound_ms=b_ms, bound_by=b_by)

    # The int8 form of K2, and B9 in both forms, at the same positions: the
    # same caches as int8 codes and f32 scales, and as 128-token pages in
    # shuffled order. No one PyTorch call gathers pages through a table or
    # reads int8 codes with their scales inside attention: no library time.
    pt, max_pages = PAGE_TOKENS, max_len // PAGE_TOKENS
    P = B * max_pages + B
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(8))
    table = perm[:B * max_pages].reshape(B, max_pages).to(torch.int32).cuda()

    def paginate(c):
        pool = torch.zeros((L, P, pt) + tuple(c.shape[3:]), dtype=c.dtype,
                           device="cuda")
        pool[:, table.long().flatten()] = c.reshape(
            (L, B * max_pages, pt) + tuple(c.shape[3:]))
        return pool

    kc8, vc8 = quantize(kc), quantize(vc)
    kp, vp = paginate(kc), paginate(vc)
    kp8, vp8 = tuple(map(paginate, kc8)), tuple(map(paginate, vc8))

    def pick(c, i):
        return tuple(x[i] for x in c) if isinstance(c, tuple) else c[i]

    def fixed(c, v, at=pos):
        return lambda i: flash_decode_attend(q, pick(c, i), pick(v, i), at,
                                             max_len, 1)

    def paged(c, v, at=pos):
        return lambda i: paged_flash_decode_attend(q, pick(c, i), pick(v, i),
                                                   table, at, pt, 1)

    def turns(name, kern, twin):
        """B9 timed in turns with K2 on the same rows: K2, B9, B9, K2."""
        ts = [time_ms(run(f), iters=240) for f in (twin, kern, kern, twin)]
        print(f"time {name} in turns with K2 on the same rows: K2 "
              f"{ts[0]:.4f} ms, B9 {ts[1]:.4f} ms, B9 {ts[2]:.4f} ms, K2 "
              f"{ts[3]:.4f} ms: B9 / K2 "
              f"{(ts[1] + ts[2]) / (ts[0] + ts[3]):.3f} "
              f"[{card_str}]", flush=True)
        return (ts[1] + ts[2]) / 2, (ts[0] + ts[3]) / 2
    # (kernel, plain version, and for B9 K2 on the same rows)
    cases = {
        "flash_decode_attend_int8": (
            fixed(kc8, vc8), lambda i: dense_decode_attend(
                q, pick(kc8, i), pick(vc8, i), pos, max_len, 1), None, True),
        "paged_flash_decode_attend": (
            paged(kp, vp), lambda i: paged_gather_attend(
                q, kp[i], vp[i], table, pos, pt, 1), fixed(kc, vc), False),
        "paged_flash_decode_attend_int8": (
            paged(kp8, vp8), lambda i: paged_gather_attend(
                q, pick(kp8, i), pick(vp8, i), table, pos, pt, 1),
            fixed(kc8, vc8), True),
    }
    for name, (kern, plain, twin, int8) in cases.items():
        if twin is None:
            t_k = time_ms(run(kern), iters=240)
        else:
            t_k, _ = turns(name, kern, twin)
        t_p = time_ms(run(plain), iters=240)
        nbytes = decode_bytes(live, B, int8, name.startswith("paged"),
                              max_pages)
        b_ms, b_by = bound_ms(4 * live * H * D, nbytes,
                              torch.int8 if int8 else bf)
        print(f"time {name} bf16 q, {'int8' if int8 else 'bf16'} cache, B={B} "
              f"W=1 H={H} D={D} max_len={max_len}"
              + (f" in {pt}-token pages" if name.startswith("paged") else "")
              + f" pos={pos_l}: kernel {t_k:.4f} ms, plain {t_p:.4f} ms, "
              f"library - (no one call), bound {b_ms:.5f} ms ({b_by}, "
              f"{nbytes} bytes) [{card_str}]", flush=True)
        out[name] = dict(ms=t_k, plain_ms=t_p, library_ms=None,
                         bound_ms=b_ms, bound_by=b_by)

    # The full cache: every slot at its last row, the same caches (25.2 MB
    # of live K/V a call), K2 and B9 in turns, then the int8 forms likewise.
    live_f = B * max_len
    for int8, (kf, vf, kpf, vpf) in ((False, (kc, vc, kp, vp)),
                                     (True, (kc8, vc8, kp8, vp8))):
        sfx = "_int8" if int8 else ""
        t9, t2 = turns(f"paged_flash_decode_attend{sfx} (full cache)",
                       paged(kpf, vpf, full), fixed(kf, vf, full))
        for name, t, paged_form in ((f"flash_decode_attend{sfx}", t2, False),
                                    (f"paged_flash_decode_attend{sfx}", t9,
                                     True)):
            nbytes = decode_bytes(live_f, B, int8, paged_form, max_pages)
            b_ms, _ = bound_ms(4 * live_f * H * D, nbytes,
                               torch.int8 if int8 else bf)
            print(f"time {name} full cache B={B} W=1 H={H} D={D} every slot "
                  f"at {max_len - 1}: kernel {t:.4f} ms, bound {b_ms:.5f} ms "
                  f"({nbytes} bytes), {t / b_ms:.2f}x the bound "
                  f"[{card_str}]", flush=True)
            out[name].update(full_cache_ms=t, full_cache_bound_ms=b_ms)

    phase_decode_split(card_str, run, q, kc, vc, pos, full, max_len,
                       label="GPT-2 124M ")

    # The wrapper's host cost per call: an eager loop at the served shape,
    # host clock, no synchronize inside it.
    n = 500
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(n):
        flash_decode_attend(q, kc[k % L], vc[k % L], pos, max_len, 1)
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    out["flash_decode_attend"]["host_us"] = host_us
    print(f"host flash_decode_attend: {host_us:.2f} us a call, eager, issued "
          f"without a synchronize ({n} calls) [{card_str}]", flush=True)
    return out


def phase_decode_split(card_str, run, q, kc, vc, pos, full, max_len,
                       n_rep=1, label="") -> None:
    """The split rule's A/B: K2 (bf16) with each of CHUNKS positions per CTA
    stood in for the rule, through the wrapper, at the served positions and
    the full cache, in the order CHUNKS then reversed (the means are
    printed, with whether the rule's pick is the fastest within SPLIT_TIE).
    At the served shape the pick must beat one chunk per slot (1024). The
    full cache has the same observable inputs, so the rule picks the same
    chunk there. ``kc`` holds the layers' caches [L, B, max_len, Hkv, Dh];
    ``label`` names the model whose decode shape this is."""
    from mpi_acx_torch.ops import flash_decode as fd
    rule, B = fd.decode_chunk, q.shape[0]
    Hq, Hkv, Dh = q.shape[2], kc.shape[3], q.shape[3]
    pick = rule(B, Hkv, n_rep, max_len, sm_count(), Dh)
    served = "[" + ", ".join(map(str, pos.tolist()[:4])) + "] x 2"
    for shape, at in ((f"served pos={served}", pos),
                      (f"full cache pos={max_len - 1}", full)):
        ts = {c: [] for c in CHUNKS}
        try:
            for c in CHUNKS + CHUNKS[::-1]:
                fd.decode_chunk = lambda *_, c=c: c
                ts[c].append(time_ms(run(lambda i: fd.flash_decode_attend(
                    q, kc[i], vc[i], at, max_len, n_rep)), iters=240))
        finally:
            fd.decode_chunk = rule
        t = {c: float(np.mean(x)) for c, x in ts.items()}
        fastest = min(t, key=t.get)
        # A near tie within the run-to-run spread of a graph-replayed
        # kernel (SPLIT_TIE) counts as the fastest.
        ok = t[pick] <= t[fastest] * (1 + SPLIT_TIE)
        verdict = ("the fastest" if ok
                   else f"{t[pick] / t[fastest]:.3f}x the fastest")
        print(f"time flash_decode_attend {label}bf16 B={B} W=1 Hq={Hq} "
              f"Hkv={Hkv} D={Dh} max_len={max_len} {shape} by positions per "
              f"CTA: " + ", ".join(f"{c} {v:.5f} ms" for c, v in t.items())
              + f"; fastest {fastest}, the rule picks {pick} ({verdict}) "
              f"[{card_str}]", flush=True)
        if at is pos and not t[pick] < t[CHUNKS[-1]]:
            fail(f"decode split rule's {pick} positions per CTA at {label}"
                 f"{shape} are not faster than one chunk per slot")


def device_kernels(prof):
    """The device events of a profile that are kernels, copies or memsets:
    a record_function range (ours, or the optimizer's ``Optimizer.step``)
    also appears as a device event spanning its kernels, which a sum of
    device time must not count again."""
    return [ev for ev in prof.events() if ev.device_type.name == "CUDA"
            and not ev.is_user_annotation]


# CUPTI's record of a launch that waited for room in the card's command
# queue: the profiler ties the launch's kernel to it again, once per record
# (46920 times in one Llama-3-8B optimizer step on an H100).
CUPTI_OVERHEAD = ("Command Buffer Full",)


def attributed_kernels(prof):
    """(the CPU op chain from the launching op up, kernel) for every
    kernel the profiler ties to a CPU op, user-annotation spans and CUPTI's
    overhead records left out."""
    spans = {ev.name for ev in prof.events() if ev.is_user_annotation}
    for ev in prof.events():
        if not ev.kernels or ev.name in CUPTI_OVERHEAD:
            continue
        names, up = [], ev
        while up is not None:
            names.append(up.name)
            up = up.cpu_parent
        for k in ev.kernels:
            if k.name not in spans:
                yield names, k


def step_profile(step) -> str:
    """One more call of ``step`` under torch.profiler: the device time of
    its kernels by class (the products: cuBLAS GEMMs; the decode
    attention: K2; everything else: norms, RoPE, activations, copies and
    the cache writes, each its own small kernel), the number of kernels,
    and the three largest by name."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    by_name, n = {}, 0
    for ev in device_kernels(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
        n += 1
    cls = dict.fromkeys(("products", "decode attention", "other"), 0.0)
    for name, us in by_name.items():
        key = ("decode attention" if "decode_kernel" in name else "products"
               if re.search(r"gemm|gemv|xmma|cutlass|nvjet", name, re.I)
               else "other")
        cls[key] += us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    return (f"{n} kernels, device {sum(cls.values()) / 1e3:.3f} ms: "
            + ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in cls.items())
            + "; largest " + "; ".join(f"{nm[:50]} {us / 1e3:.3f} ms"
                                       for nm, us in top))


def phase_step(params, cfg, fam, k2_ms, k2_host_us, card_str,
               label="GPT-2 124M", profile=None) -> None:
    """One batched decode step at the phase-4 shape (8 slots at mid-request
    positions): as the server issues it (eager, host clock around steps
    that end in a synchronize) against its device time (the same step
    replayed from a CUDA graph). Their ratio is the device's busy share of
    a served decode step; one K2 call a layer is its attention. ``fam``
    is the model family's module, ``label`` its name; ``profile``
    (:func:`step_profile` or :func:`moe_step_profile`) splits one more
    step's kernels by class."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cache = fam.init_kv_cache(cfg, 8, 1024)
    for key in ("k", "v"):
        cache[key].normal_(generator=gen)
    cache["pos"] = torch.tensor([40, 160, 320, 528] * 2, dtype=torch.int32,
                                device="cuda")
    tok = torch.randint(0, cfg.vocab, (8,), generator=gen, device="cuda",
                        dtype=torch.int32)

    def step():
        return fam.decode_step(params, cfg, cache, tok)

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
    L = cfg.n_layers
    host = ("" if k2_host_us is None else
            f"; K2's wrapper issues in {k2_host_us:.2f} us a call, {L} x = "
            f"{100 * L * k2_host_us / 1e3 / host_ms:.1f}% of the issued step")
    print(f"decode step bf16 {label} B=8 max_len=1024: host-issued "
          f"{host_ms:.3f} ms, device {dev_ms:.3f} ms (graph replay): device "
          f"busy {100 * dev_ms / host_ms:.1f}% of the eager step; decode "
          f"attention {L} x {k2_ms:.4f} ms = {100 * L * k2_ms / dev_ms:.1f}% "
          f"of device time{host} [{card_str}]", flush=True)
    if profile:
        print(f"decode step bf16 {label} profiled: {profile(step)} "
              f"[{card_str}]", flush=True)


# --- phase 4c: Llama-3-8B ---------------------------------------------------

LLAMA_F32_LAYERS = 4    # the f32 check's depth (full width)


def llama_decode_timing(card_str) -> dict:
    """K2 at Llama-3-8B's decode shape (B = 8, W = 1, 32 query heads over 8
    KV groups, D = 128, max_len 1024, positions 40/160/320/528 twice, 32
    layers' caches rotated), bf16 and int8 caches, each beside its plain
    version, its bound and (bf16) SDPA over the same rows with the length
    mask (a group's 4 query heads as 4 query rows of one head, so one call
    computes the grouped function); then both with every slot at its last
    row, and the split rule's candidates (phase_decode_split)."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf = torch.bfloat16
    B, max_len, L = 8, 1024, 32
    Hq, Hkv, Dh, rep = LLAMA_H, LLAMA_HKV, LLAMA_D, LLAMA_REP
    pos_l = [40, 160, 320, 528] * 2
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    full = torch.full((B,), max_len - 1, dtype=torch.int32, device="cuda")
    q = randn((B, 1, Hq, Dh), bf, gen)
    kc = randn((L, B, max_len, Hkv, Dh), bf, gen)
    vc = randn((L, B, max_len, Hkv, Dh), bf, gen)
    kc8, vc8 = quantize(kc), quantize(vc)
    it = iter(range(10 ** 9))

    def run(fn):
        return lambda: fn(next(it) % L)

    def pick(c, i):
        return tuple(x[i] for x in c) if isinstance(c, tuple) else c[i]

    out = {}
    for name, int8, (k, v) in (("flash_decode_attend_d128", False, (kc, vc)),
                               ("flash_decode_attend_int8_d128", True,
                                (kc8, vc8))):
        t_k = time_ms(run(lambda i: flash_decode_attend(
            q, pick(k, i), pick(v, i), pos, max_len, rep)), iters=240)
        t_p = time_ms(run(lambda i: dense_decode_attend(
            q, pick(k, i), pick(v, i), pos, max_len, rep)), iters=240)
        t_f = time_ms(run(lambda i: flash_decode_attend(
            q, pick(k, i), pick(v, i), full, max_len, rep)), iters=240)
        t_l = None
        if not int8:
            qg = q.reshape(B, Hkv, rep, Dh)
            kt = kc.transpose(2, 3).contiguous()
            vt = vc.transpose(2, 3).contiguous()
            mask = (torch.arange(max_len, device="cuda")[None, :]
                    <= pos[:, None])[:, None, None, :]
            t_l = time_ms(run(lambda i: F.scaled_dot_product_attention(
                qg, kt[i], vt[i], attn_mask=mask)), iters=240)
            del kt, vt
        res = {}
        for label, at_live in (("served", sum(p + 1 for p in pos_l)),
                               ("full", B * max_len)):
            nbytes = decode_bytes(at_live, B, int8, False, hkv=Hkv, hq=Hq,
                                  head_dim=Dh)
            res[label] = (bound_ms(4 * at_live * Hq * Dh, nbytes,
                                   torch.int8 if int8 else bf), nbytes)
        (b_ms, b_by), nbytes = res["served"]
        (bf_ms, _), _ = res["full"]
        lib = ("-" if t_l is None else f"{t_l:.4f} ms")
        print(f"time {name} bf16 q, {'int8' if int8 else 'bf16'} cache, B={B} "
              f"W=1 Hq={Hq} Hkv={Hkv} D={Dh} max_len={max_len} pos={pos_l}: "
              f"kernel {t_k:.4f} ms, plain {t_p:.4f} ms, library (sdpa, "
              f"length mask) {lib}, bound {b_ms:.5f} ms ({b_by}, {nbytes} "
              f"bytes); full cache {t_f:.4f} ms, bound {bf_ms:.5f} ms, "
              f"{t_f / bf_ms:.2f}x [{card_str}]", flush=True)
        out[name] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                         bound_by=b_by, full_cache_ms=t_f,
                         full_cache_bound_ms=bf_ms)
    phase_decode_split(card_str, run, q, kc, vc, pos, full, max_len,
                       n_rep=rep, label="Llama-3-8B ")
    return out


def llama_f32(card_str) -> dict:
    """Llama-3-8B at full width, depth cut to LLAMA_F32_LAYERS, in f32:
    served through the kernels and through the plain versions (tokens and
    logits as phase 3); then speculative decoding with draft = target
    (:func:`llama_f32_speculative`). Returns the launch counts of the
    kernel path."""
    from mpi_acx_torch.models import llama, serving
    cfg = dataclasses.replace(llama.llama3_8b(), n_layers=LLAMA_F32_LAYERS,
                              dtype=torch.float32)
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    params = llama.init_params(cfg, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(1)
    lens = [16, 40, 64, 100, 23, 77, 50, 128]
    n_new = [8, 16, 12, 20, 8, 16, 12, 20]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    kw = dict(n_slots=3, max_len=256, chunk=4, family=llama)
    reset_counts()
    got = serving.serve_greedy(params, cfg, prompts, n_new, **kw)
    counts = read_counts(("flash_attention_d128", "flash_decode_attend_d128"))
    check_no_copies("Llama f32 serve")
    want = serving.serve_greedy(params, plain, prompts, n_new, **kw)
    if min(counts.values()) == 0:
        fail(f"Llama f32 kernel serve did not launch every kernel: {counts}")
    if got.metrics.requeues or want.metrics.requeues:
        fail("Llama f32 serve requeued a request after a failed step")
    compare_paths(f"Llama f32 serve (8 requests, 3 slots, Llama-3-8B full "
                  f"width, {LLAMA_F32_LAYERS} layers)", params, cfg, got, want,
                  prompts, fam=llama)
    print(f"Llama f32 serve launches {counts}", flush=True)
    llama_f32_speculative(params, cfg)
    return counts


def phase_llama(card_str):
    """Llama-3-8B (BASELINE.json configs[4]'s geometry) served on the card
    through the head dim 128 kernels: the f32 check at full width and cut
    depth, then the full model (32 layers, seed-0 bf16 weights drawn on
    the card) serving phase 4's requests with bf16 and then int8 KV
    caches, each held to the same requests through the plain versions;
    the launch counts of the D = 128 forms (K1's exactly the prefills x 32
    layers); the D = 128 kernels timed at the path's shapes, K1's CTA
    sizes at Llama's prefill buckets, and a decode step issued against its
    device time, with phase 4e on the same weights (:func:`phase_llama_4e`)
    before the profiled step. Returns (launch counts, timings)."""
    from mpi_acx_torch.models import llama, serving
    names = ("flash_attention_d128", "flash_decode_attend_d128",
             "flash_decode_attend_int8_d128")
    llama_f32(card_str)
    torch.cuda.empty_cache()
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["unembed"], params["final_norm"],
                   *params["layers"].values()])
    print(f"params: Llama-3-8B, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} query heads over {cfg.n_kv_heads} KV groups, D "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
          f"{n_bytes / 1e9:.2f} GB of bf16 drawn on the card from seed 0 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    prompts, n_new = serve_requests(cfg.vocab)
    kw = dict(n_slots=8, max_len=1024, chunk=8, family=llama)
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    # Warm-up: cuBLAS handles and allocator pools at these shapes.
    serving.serve_greedy(params, cfg, prompts[:2], 4, **kw)
    counts, greedy = {}, {}
    for int8 in (False, True):
        label = f"Llama-3-8B serve {'int8' if int8 else 'bf16'} KV"
        fns = serving.make_server_fns(params, cfg, llama, chunk=8,
                                      kv_int8=int8)
        torch.cuda.synchronize()
        reset_counts()
        res = serving.serve_greedy(params, cfg, prompts, n_new,
                                   kv_int8=int8, server_fns=fns, **kw)
        torch.cuda.synchronize()
        got = read_counts(names)
        check_no_copies(label)
        check_served(label, res, prompts, n_new, cfg.vocab)
        check_prefills(label, fns, res.metrics.prefills)
        del fns
        print(f"serve {label}: 16 requests, 8 slots, max_len 1024, chunk 8: "
              f"{served_figures(res.metrics)} [{card_str}]", flush=True)
        print(f"launches during {label}: {json.dumps(got)}", flush=True)
        k2 = "flash_decode_attend_int8_d128" if int8 else \
            "flash_decode_attend_d128"
        want_k1 = res.metrics.prefills * cfg.n_layers
        if got["flash_attention_d128"] != want_k1 or got[k2] == 0:
            fail(f"{label}: K1 launched {got['flash_attention_d128']} times "
                 f"(the {res.metrics.prefills} prefills x {cfg.n_layers} "
                 f"layers are {want_k1}), {k2} {got[k2]} times")
        counts["flash_attention_d128"] = counts.get(
            "flash_attention_d128", 0) + got["flash_attention_d128"]
        counts[k2] = got[k2]
        greedy[int8] = res
        SERVED["llama_int8" if int8 else "llama_bf16"] = [np.asarray(o)
                                                          for o in res]
        want = serving.serve_greedy(params, plain, prompts, n_new,
                                    kv_int8=int8, **kw)
        # The f32 reference of the bf16 run: the same weights widened
        # (32 GB beside the 16), attention through the plain version.
        ref = None if int8 else (
            {k: ({n: t.float() for n, t in v.items()} if isinstance(v, dict)
                 else v.float()) for k, v in params.items()},
            dataclasses.replace(plain, dtype=torch.float32))
        compare_paths(f"{label} (16 requests, 8 slots)", params, cfg, res,
                      want, prompts, int8=int8, fam=llama, tie=TIE_LLAMA,
                      ref=ref)
        del ref
        torch.cuda.empty_cache()
    times = {"flash_attention_d128": k1_timing(card_str, LLAMA_H, LLAMA_D,
                                               "Llama-3-8B ")}
    times.update(llama_decode_timing(card_str))
    k2_ms = times["flash_decode_attend_d128"]["ms"]
    # Phase 4e runs before the profiled step (torch.profiler), as 4c's
    # serves do.
    more, window = phase_llama_4e(params, cfg, prompts, n_new, greedy, k2_ms,
                                  card_str)
    add_counts(counts, more)
    times["flash_decode_attend_d128"].update(window)
    phase_cta_sizes(card_str, LLAMA_CTA_SHAPES)
    phase_step(params, cfg, llama, k2_ms, None, card_str, label="Llama-3-8B",
               profile=step_profile)
    del params
    torch.cuda.empty_cache()
    return counts, times


# --- phase 4e: sampling, int8 weights and speculative decoding --------------

SAMPLE = dict(temperature=0.8, top_k=40, top_p=0.95)   # generate_text.py's
SAMPLE_KEY = 0
SPEC_K, SPEC_NEW, SPEC_S, SPEC_B = 4, 64, 128, 4       # k, n_new, prompt


def spec_prompts(vocab):
    """The speculative runs' prompts: SPEC_B rows of SPEC_S tokens, numpy
    seed 0."""
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.integers(0, vocab, (SPEC_B, SPEC_S)).astype(
        np.int32)).cuda()


def first_near_ties(fam, params, cfg, seqs, S, tie):
    """Per row of ``seqs`` ([B, S + n] greedy sequences), the first
    generated position whose next-token logits (a forward pass over the
    sequence) have their top two within ``tie`` (n where none has)."""
    logits = forward_logits(fam, params, cfg, seqs[:, :-1])[:, S - 1:]
    top = logits.topk(2, dim=-1).values
    near = (top[..., 0] - top[..., 1]) < tie
    n = near.shape[1]
    return [int(torch.nonzero(r)[0]) if r.any() else n for r in near]


def hold_to_greedy(label, got, want, ties, S) -> list:
    """Each row of ``got`` equals ``want``'s up to the first near tie of
    that row (``ties``, from :func:`first_near_ties`); returns the number
    of leading generated positions that match."""
    matched = []
    for b, (g, w) in enumerate(zip(got.tolist(), want.tolist())):
        if g[:S] != w[:S]:
            fail(f"{label} row {b}: the prompt was not kept")
        gen = list(zip(g[S:], w[S:]))
        t = next((i for i, (x, y) in enumerate(gen) if x != y), len(gen))
        if t < ties[b]:
            fail(f"{label} row {b}: differs from greedy at generated "
                 f"position {t} ({gen[t][0]} vs {gen[t][1]}), before the "
                 f"first near tie at {ties[b]}")
        matched.append(t)
    print(f"{label}: generated positions equal to greedy per row {matched} "
          f"of {got.shape[1] - S}; first near tie per row {ties}",
          flush=True)
    return matched


def spec_perfect_bound(label, st, n_new, k) -> bool:
    """The perfect-draft bound of tests/test_speculative.py: rounds <=
    ceil(n_new / k) + 1 and accepted >= (k - 1)(rounds - 1), per row."""
    rounds, acc = st["rounds"].tolist(), st["drafted_accepted"].tolist()
    ok = all(r <= -(-n_new // k) + 1 and a >= (k - 1) * (r - 1)
             for r, a in zip(rounds, acc))
    print(f"{label}: rounds {rounds}, accepted {acc} of {(k - 1)} a round; "
          f"perfect-draft bound (rounds <= {-(-n_new // k) + 1}, accepted "
          f">= {k - 1} x (rounds - 1)) {'met' if ok else 'not met'}",
          flush=True)
    return ok


def llama_f32_speculative(params, cfg) -> None:
    """Speculative decoding at Llama-3-8B's full width in f32 (phase 4c's
    cut depth), where the window pass and the one-token step agree to
    f32 rounding: with a 1-layer draft from seed 7 and with draft =
    target, every row equal to greedy up to ties within TIE[f32]; with
    draft = target the perfect-draft bound met in every row."""
    from mpi_acx_torch.models import llama
    from mpi_acx_torch.models.speculative import speculative_generate
    prompt = spec_prompts(cfg.vocab)
    cap = SPEC_S + SPEC_NEW + SPEC_K
    want = llama.generate(params, cfg, prompt, SPEC_NEW, max_len=cap)
    ties = first_near_ties(llama, params, cfg, want, SPEC_S,
                           TIE[torch.float32])
    shape = (f"{LLAMA_F32_LAYERS} layers, full width, {SPEC_B} x {SPEC_S} "
             f"prompt, n_new {SPEC_NEW}, k {SPEC_K}")
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = llama.init_params(dcfg, seed=7, dtype=torch.float32)
    got, st = speculative_generate(dparams, dcfg, params, cfg, prompt,
                                   SPEC_NEW, k=SPEC_K)
    label = f"Llama f32 speculative, 1-layer draft ({shape})"
    hold_to_greedy(label, got, want, ties, SPEC_S)
    print(f"{label}: rounds {st['rounds'].tolist()}, accepted "
          f"{st['drafted_accepted'].tolist()}", flush=True)
    del dparams
    got, st = speculative_generate(params, cfg, params, cfg, prompt,
                                   SPEC_NEW, k=SPEC_K)
    label = f"Llama f32 speculative, draft = target ({shape})"
    hold_to_greedy(label, got, want, ties, SPEC_S)
    if not spec_perfect_bound(label, st, SPEC_NEW, SPEC_K):
        fail(f"{label}: the perfect-draft bound does not hold")


@contextlib.contextmanager
def topk_audit(top_k):
    """Every token a sampled serve draws held to the ``top_k`` set of the
    logits it was drawn from: the step's filter (``serving.filter_logits``,
    whose calls record their logits' top-k indices for
    :func:`audited_step`) and the refill's draw (``serving.sample_logits``)
    are wrapped. Yields (the recorded sets, a tally of tokens checked and
    those outside, the latter on the card)."""
    from mpi_acx_torch.models import serving
    filt, samp = serving.filter_logits, serving.sample_logits
    sets = []
    tally = {"checked": 0, "outside": torch.zeros(
        (), dtype=torch.int64, device="cuda")}

    def rec_filter(logits, *args):
        sets.append(logits.topk(top_k, dim=-1).indices)
        return filt(logits, *args)

    def rec_sample(logits, key, *args):
        tok = samp(logits, key, *args)
        idx = logits.topk(top_k, dim=-1).indices
        tally["outside"] += (idx != tok[:, None]).all(-1).sum()
        tally["checked"] += tok.numel()
        return tok

    serving.filter_logits, serving.sample_logits = rec_filter, rec_sample
    try:
        yield sets, tally
    finally:
        serving.filter_logits, serving.sample_logits = filt, samp


def audited_step(step_fn, sets, tally):
    """``step_fn`` with each of its chunk's tokens (every slot's) checked
    against the top-k set its pick recorded."""
    def step(cache, tok, keys=None):
        n0 = len(sets)
        cache, toks = step_fn(cache, tok, keys)
        for c, idx in enumerate(sets[n0:]):
            tally["outside"] += (idx != toks[c][:, None].long()).all(-1).sum()
            tally["checked"] += toks.shape[1]
        del sets[n0:]
        return cache, toks
    return step


def draw_host_us(vocab, n_slots=8, iters=50) -> float:
    """Host microseconds to issue one slot's [1, vocab] Gumbel draw from
    its own generator, as the sampled step issues them (n_slots a step)."""
    from mpi_acx_torch.models.decoding import gumbel
    gens = [torch.Generator(device="cuda").manual_seed(i)
            for i in range(n_slots)]
    for _ in range(3):
        [gumbel((1, vocab), g) for g in gens]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        [gumbel((1, vocab), g) for g in gens]
    us = (time.perf_counter() - t0) / iters / n_slots * 1e6
    torch.cuda.synchronize()
    return us


def sampled_serves(label, params, cfg, fam, prompts, n_new, greedy, card_str,
                   kv_list=(False, True)) -> dict:
    """Phase 4e (a) for one model: serve_sample over phase 4's requests at
    temperature 0 (tokens exactly ``greedy[False]``'s, the same phase's
    bf16-KV serve_greedy), then at SAMPLE with chunk 8 and chunk 1 for each
    KV form in ``kv_list``: each request's tokens bit-equal between the
    two, every sampled token inside its step's top-k set (the chunk-1 run
    audited). Returns the decode launch counts of the chunk-8 runs."""
    from mpi_acx_torch.models import serving
    kw = dict(n_slots=8, max_len=1024, family=fam, key=SAMPLE_KEY)
    t0 = serving.serve_sample(params, cfg, prompts, n_new, chunk=8,
                              temperature=0.0, **kw)
    check_served(f"{label} temperature 0", t0, prompts, n_new, cfg.vocab)
    exactly_equal(f"{label} temperature 0 vs serve_greedy", t0,
                  greedy[False])
    print(f"{label} temperature 0: tokens equal serve_greedy's in all "
          f"{len(t0)} requests; {served_figures(t0.metrics)} [{card_str}]",
          flush=True)
    counts = {}
    for int8 in kv_list:
        kv = "int8" if int8 else "bf16"
        torch.cuda.synchronize()
        reset_counts()
        a = serving.serve_sample(params, cfg, prompts, n_new, chunk=8,
                                 kv_int8=int8, **SAMPLE, **kw)
        torch.cuda.synchronize()
        add_counts(counts, read_counts())
        check_served(f"{label} {kv} KV sampled", a, prompts, n_new,
                     cfg.vocab)
        fns = serving.make_server_fns(params, cfg, fam, chunk=1,
                                      kv_int8=int8,
                                      sample_cfg=tuple(SAMPLE.values()))
        with topk_audit(SAMPLE["top_k"]) as (sets, tally):
            fns = (fns[0], audited_step(fns[1], sets, tally)) + fns[2:]
            b = serving.serve_sample(params, cfg, prompts, n_new, chunk=1,
                                     kv_int8=int8, server_fns=fns,
                                     **SAMPLE, **kw)
            outside = int(tally["outside"])
        exactly_equal(f"{label} {kv} KV sampled, chunk 8 vs chunk 1", a, b)
        same_as_greedy = sum(int(np.array_equal(x, y))
                             for x, y in zip(a, greedy[int8]))
        print(f"{label} {kv} KV, temperature {SAMPLE['temperature']}, top_k "
              f"{SAMPLE['top_k']}, top_p {SAMPLE['top_p']}, key "
              f"{SAMPLE_KEY}: chunk 8 and chunk 1 bit-equal in all "
              f"{len(a)} requests; {tally['checked']} drawn tokens audited, "
              f"{outside} outside their top-{SAMPLE['top_k']}; "
              f"{same_as_greedy} requests equal to greedy", flush=True)
        if outside:
            fail(f"{label} {kv} KV: {outside} sampled tokens outside the "
                 f"top-{SAMPLE['top_k']} set")
        print(f"serve {label} {kv} KV sampled, chunk 8: "
              f"{served_figures(a.metrics)}; chunk 1: "
              f"{served_figures(b.metrics)}; greedy chunk 8: "
              f"{served_figures(greedy[int8].metrics)} [{card_str}]",
              flush=True)
    print(f"{label}: a slot's Gumbel draw [1, {cfg.vocab}] issues in "
          f"{draw_host_us(cfg.vocab):.2f} us of host time (8 a step) "
          f"[{card_str}]", flush=True)
    return counts


def llama_int8_weights(params, cfg, prompts, n_new, greedy, k2_ms,
                       card_str) -> dict:
    """Phase 4e (b): Llama-3-8B's layer weights quantized on the card,
    served greedily through the kernels and through the plain versions
    (held as phase 4c holds bf16), tokens agreeing with the bf16-weight
    serve counted, and a decode step timed. Returns the launch counts."""
    from mpi_acx_torch.models import llama, serving
    from mpi_acx_torch.ops.wquant import (LLAMA_WEIGHTS,
                                          quantize_weights_int8,
                                          weight_bytes)
    t0 = time.perf_counter()
    qparams = quantize_weights_int8(params, LLAMA_WEIGHTS)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    layer = sum(weight_bytes(qparams["layers"][n]) for n in LLAMA_WEIGHTS)
    scales = sum(weight_bytes(qparams["layers"][n + "_scale"])
                 for n in LLAMA_WEIGHTS)
    heads = weight_bytes(params["embed"]) + weight_bytes(params["unembed"])
    print(f"int8 weights: quantize_weights_int8(LLAMA_WEIGHTS) on the card "
          f"in {t_q:.2f} s; weight_bytes {weight_bytes(qparams) / 1e9:.3f} "
          f"GB (int8 layer weights {layer / 1e9:.3f}, bf16 embed and unembed "
          f"{heads / 1e9:.3f}, f32 scales {scales / 1e6:.2f} MB) against "
          f"{weight_bytes(params) / 1e9:.3f} GB in bf16", flush=True)
    kw = dict(n_slots=8, max_len=1024, chunk=8, family=llama)
    label = "Llama-3-8B int8 weights, bf16 KV"
    serving.serve_greedy(qparams, cfg, prompts[:2], 4, **kw)
    torch.cuda.synchronize()
    reset_counts()
    res = serving.serve_greedy(qparams, cfg, prompts, n_new, **kw)
    torch.cuda.synchronize()
    counts = read_counts(("flash_attention_d128", "flash_decode_attend_d128"))
    check_no_copies(label)
    check_served(label, res, prompts, n_new, cfg.vocab)
    print(f"serve {label}: 16 requests, 8 slots, max_len 1024, chunk 8: "
          f"{served_figures(res.metrics)} [{card_str}]", flush=True)
    if counts["flash_attention_d128"] != res.metrics.prefills * cfg.n_layers:
        fail(f"{label}: K1 launched {counts['flash_attention_d128']} times")
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    want = serving.serve_greedy(qparams, plain, prompts, n_new, **kw)
    compare_paths(f"{label} (16 requests, 8 slots)", qparams, cfg, res, want,
                  prompts, fam=llama, tie=TIE_LLAMA)
    agree = total = 0
    for g, w, p in zip(res, greedy[False], prompts):
        agree += int((g[len(p):] == w[len(p):]).sum())
        total += len(g) - len(p)
    print(f"{label}: {agree} of {total} generated tokens equal the "
          f"bf16-weight serve's at the same position (random weights; not "
          f"held)", flush=True)
    phase_step(qparams, cfg, llama, k2_ms, None, card_str,
               label="Llama-3-8B int8 weights")
    del qparams
    torch.cuda.empty_cache()
    return counts


def llama_speculative(params, cfg, card_str) -> dict:
    """Phase 4e (c): Llama-3-8B target, a 1-layer draft at its width (seed
    7), k = SPEC_K, SPEC_B rows of SPEC_S tokens, n_new SPEC_NEW: greedy
    speculation held to llama.generate up to the first near tie per row
    (TIE_LLAMA), with K1's and K2's launches exact; draft = target
    (rounds and acceptance printed, tokens held the same way); the
    sampled form reproducible. Returns the launch counts."""
    from mpi_acx_torch.models import llama
    from mpi_acx_torch.models.speculative import (speculative_generate,
                                                  speculative_sample)
    dcfg = dataclasses.replace(cfg, n_layers=1)
    dparams = llama.init_params(dcfg, seed=7, dtype=torch.bfloat16)
    prompt = spec_prompts(cfg.vocab)
    cap = SPEC_S + SPEC_NEW + SPEC_K
    shape = (f"{SPEC_B} x {SPEC_S} prompt, n_new {SPEC_NEW}, k {SPEC_K}, "
             f"1-layer draft")
    # Warm-up at these shapes (the window pass's first K2 launches).
    speculative_generate(dparams, dcfg, params, cfg, prompt[:, :64], 8,
                         k=SPEC_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = llama.generate(params, cfg, prompt, SPEC_NEW, max_len=cap)
    torch.cuda.synchronize()
    t_greedy = time.perf_counter() - t0
    ties = first_near_ties(llama, params, cfg, want, SPEC_S, TIE_LLAMA)
    reset_counts()
    t0 = time.perf_counter()
    got, st = speculative_generate(dparams, dcfg, params, cfg, prompt,
                                   SPEC_NEW, k=SPEC_K)
    torch.cuda.synchronize()
    t_spec = time.perf_counter() - t0
    counts = read_counts(("flash_attention_d128", "flash_decode_attend_d128"))
    check_no_copies("Llama-3-8B speculative")
    label = f"Llama-3-8B speculative ({shape})"
    hold_to_greedy(label, got, want, ties, SPEC_S)
    R = int(st["rounds"].max())
    want_k2 = R * (cfg.n_layers + SPEC_K * dcfg.n_layers)
    want_k1 = cfg.n_layers + dcfg.n_layers
    print(f"{label}: rounds per row {st['rounds'].tolist()}, accepted "
          f"{st['drafted_accepted'].tolist()} of {SPEC_K - 1} a round; "
          f"launches {json.dumps(counts)} (K1 {want_k1} = {cfg.n_layers} + "
          f"{dcfg.n_layers} prefill layers; K2 {want_k2} = {R} rounds x "
          f"({cfg.n_layers} + {SPEC_K} x {dcfg.n_layers})); "
          f"{t_spec * 1e3 / (SPEC_B * SPEC_NEW):.2f} ms per emitted token "
          f"({t_spec:.3f} s) against plain greedy's "
          f"{t_greedy * 1e3 / (SPEC_B * SPEC_NEW):.2f} ({t_greedy:.3f} s) "
          f"[{card_str}]", flush=True)
    if (counts["flash_attention_d128"] != want_k1
            or counts["flash_decode_attend_d128"] != want_k2):
        fail(f"{label}: launches {counts}, expected K1 {want_k1} and K2 "
             f"{want_k2}")
    # Draft = target: the same tensors, no second draw.
    got2, st2 = speculative_generate(params, cfg, params, cfg, prompt,
                                     SPEC_NEW, k=SPEC_K)
    label2 = f"Llama-3-8B speculative, draft = target (bf16, {SPEC_B} rows)"
    hold_to_greedy(label2, got2, want, ties, SPEC_S)
    spec_perfect_bound(label2, st2, SPEC_NEW, SPEC_K)
    runs = []
    for _ in range(2):
        key = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        runs.append(speculative_sample(dparams, dcfg, params, cfg, prompt,
                                       SPEC_NEW, key, k=SPEC_K,
                                       temperature=SAMPLE["temperature"]))
        torch.cuda.synchronize()
        t_sample = time.perf_counter() - t0
    (a, sa), (b, _) = runs
    if not torch.equal(a, b):
        fail("Llama-3-8B speculative_sample: two calls with the same "
             "generator differ")
    if not (torch.equal(a[:, :SPEC_S], prompt) and a.min() >= 0
            and a.max() < cfg.vocab):
        fail("Llama-3-8B speculative_sample: tokens outside the vocabulary")
    print(f"Llama-3-8B speculative_sample (temperature "
          f"{SAMPLE['temperature']}, {shape}): two calls with one seed "
          f"bit-equal; rounds {sa['rounds'].tolist()}, accepted "
          f"{sa['drafted_accepted'].tolist()}; {t_sample:.3f} s [{card_str}]",
          flush=True)
    del dparams
    torch.cuda.empty_cache()
    return counts


def llama_window_timing(card_str) -> dict:
    """K2 at the speculative window pass's shape (B = SPEC_B, W = SPEC_K,
    32 query heads over 8 KV groups, D = 128, max_len the loop's cache,
    one position per row, 32 layers' caches rotated): W * n_rep = 16
    rows a KV group, two of the kernel's 8-row blocks. Beside its plain
    version, its byte bound and SDPA over the same rows with the window's
    mask (a group's W x 4 query rows as rows of one head)."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops.flash_decode import dense_decode_attend, \
        flash_decode_attend
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf = torch.bfloat16
    B, W, L = SPEC_B, SPEC_K, 32
    max_len = SPEC_S + SPEC_NEW + SPEC_K
    Hq, Hkv, Dh, rep = LLAMA_H, LLAMA_HKV, LLAMA_D, LLAMA_REP
    pos_l = [150, 160, 170, 180]
    pos = torch.tensor(pos_l, dtype=torch.int32, device="cuda")
    q = randn((B, W, Hq, Dh), bf, gen)
    kc = randn((L, B, max_len, Hkv, Dh), bf, gen)
    vc = randn((L, B, max_len, Hkv, Dh), bf, gen)
    it = iter(range(10 ** 9))

    def run(fn):
        return lambda: fn(next(it) % L)

    t_k = time_ms(run(lambda i: flash_decode_attend(
        q, kc[i], vc[i], pos, max_len, rep)), iters=240)
    t_p = time_ms(run(lambda i: dense_decode_attend(
        q, kc[i], vc[i], pos, max_len, rep)), iters=240)
    # Row w * rep + r of group g is query head g * rep + r at window row w.
    qg = q.reshape(B, W, Hkv, rep, Dh).permute(0, 2, 1, 3, 4).reshape(
        B, Hkv, W * rep, Dh).contiguous()
    kt = kc.transpose(2, 3).contiguous()
    vt = vc.transpose(2, 3).contiguous()
    rows = (pos[:, None] + torch.arange(W, device="cuda")).repeat_interleave(
        rep, dim=1)                                       # [B, W * rep]
    mask = (torch.arange(max_len, device="cuda")[None, None, :]
            <= rows[:, :, None])[:, None]
    t_l = time_ms(run(lambda i: F.scaled_dot_product_attention(
        qg, kt[i], vt[i], attn_mask=mask)), iters=240)
    del kt, vt
    # The same rows as one 8-row block (W = 2): a group's K/V read once,
    # where W = 4's two blocks each read it.
    t_1 = time_ms(run(lambda i: flash_decode_attend(
        q[:, :2].contiguous(), kc[i], vc[i], pos, max_len, rep)), iters=240)
    live = sum(min(p + W, max_len) for p in pos_l)
    keys = sum(min(p + w + 1, max_len) for p in pos_l for w in range(W))
    nbytes = (decode_bytes(live, B, False, False, hkv=Hkv, hq=Hq,
                           head_dim=Dh) + (W - 1) * 2 * B * Hq * Dh * 2)
    b_ms, b_by = bound_ms(4 * keys * Hq * Dh, nbytes, bf)
    print(f"time flash_decode_attend_d128 bf16, the window pass: B={B} W={W} "
          f"Hq={Hq} Hkv={Hkv} D={Dh} ({W * rep} rows a KV group, two 8-row "
          f"blocks) max_len={max_len} pos={pos_l}: kernel {t_k:.4f} ms, "
          f"plain {t_p:.4f} ms, library (sdpa, window mask) {t_l:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}, {nbytes} bytes), "
          f"{t_k / b_ms:.2f}x; W=2 (8 rows, one block) {t_1:.4f} ms "
          f"[{card_str}]", flush=True)
    return dict(window_ms=t_k, window_plain_ms=t_p, window_library_ms=t_l,
                window_bound_ms=b_ms)


def phase_llama_4e(params, cfg, prompts, n_new, greedy, k2_ms,
                   card_str) -> tuple:
    """Phase 4e on the Llama-3-8B weights phase 4c drew: (a) sampled
    serving, (b) int8 weights, (c) speculative decoding, then K2 timed at
    the window pass. Returns (launch counts, the window timing)."""
    from mpi_acx_torch.models import llama
    counts = sampled_serves("Llama-3-8B", params, cfg, llama, prompts, n_new,
                            greedy, card_str)
    add_counts(counts, llama_int8_weights(params, cfg, prompts, n_new, greedy,
                                          k2_ms, card_str))
    add_counts(counts, llama_speculative(params, cfg, card_str))
    return counts, llama_window_timing(card_str)


def phase_gpt2_4e(params16, fixed, card_str) -> dict:
    """Phase 4e's GPT-2 counterparts at full width: serve_sample at
    temperature 0 equal to phase 4's serve_greedy, sampled serving with
    bf16 KV as for Llama, and int8 weights under speculative decoding (a
    1-layer draft from seed 7, both quantized, k = SPEC_K) held to the
    int8-weight greedy tokens up to ties within TIE. Returns the launch
    counts."""
    from mpi_acx_torch.models import transformer as tfm
    from mpi_acx_torch.models.speculative import speculative_generate
    from mpi_acx_torch.ops.wquant import GPT2_WEIGHTS, quantize_weights_int8
    cfg = tfm.gpt2_small()
    prompts, n_new = serve_requests(cfg.vocab)
    counts = sampled_serves("GPT-2 124M", params16, cfg, tfm, prompts, n_new,
                            {False: fixed}, card_str, kv_list=(False,))
    dcfg = dataclasses.replace(cfg, n_layers=1)
    qp = quantize_weights_int8(params16, GPT2_WEIGHTS)
    qd = quantize_weights_int8(tfm.cast_params(tfm.init_params(
        dcfg, seed=7), torch.bfloat16), GPT2_WEIGHTS)
    prompt = spec_prompts(cfg.vocab)
    cap = SPEC_S + SPEC_NEW + SPEC_K
    want = tfm.generate(qp, cfg, prompt, SPEC_NEW, max_len=cap)
    reset_counts()
    got, st = speculative_generate(qd, dcfg, qp, cfg, prompt, SPEC_NEW,
                                   k=SPEC_K)
    torch.cuda.synchronize()
    add_counts(counts, read_counts(("flash_attention",
                                    "flash_decode_attend")))
    label = (f"GPT-2 124M int8 weights, speculative ({SPEC_B} x {SPEC_S} "
             f"prompt, n_new {SPEC_NEW}, k {SPEC_K}, 1-layer int8 draft)")
    hold_to_greedy(label, got, want, first_near_ties(
        tfm, qp, cfg, want, SPEC_S, TIE[torch.bfloat16]), SPEC_S)
    print(f"{label}: rounds {st['rounds'].tolist()}, accepted "
          f"{st['drafted_accepted'].tolist()}", flush=True)
    return counts


# --- phase 4f: disaggregated serving in loopback ----------------------------

DISAGG_FAULT_LAYER = 6      # a handoff's failure strikes before this layer


def build_host_plane() -> None:
    """``make -j8 lib tools``: the native host plane (build/libtpuacx.so,
    build/acxrun) the runtime binding and the rank programs use."""
    t0 = time.perf_counter()
    res = subprocess.run(["make", "-C", str(ROOT), "-j8", "lib", "tools"],
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        fail(f"make lib tools: exit {res.returncode}\n{res.stdout[-3000:]}\n"
             f"{res.stderr[-3000:]}")
    print(f"native host plane: make lib tools {time.perf_counter() - t0:.1f} "
          f"s", flush=True)


def p50_ms(xs) -> str:
    return f"{np.median(np.asarray(xs)) * 1e3:.3f}"


def check_disagg_counts(label, counts, handoffs) -> None:
    """A disagg serve with int8 slots: K1 once per layer of every handoff
    (the layerwise prefill), K2's int8 form only."""
    print(f"{label}: launches {json.dumps(counts)}", flush=True)
    if counts["flash_attention"] != handoffs * 12:
        fail(f"{label}: K1 launched {counts['flash_attention']} times, "
             f"{handoffs} handoffs x 12 layers = {handoffs * 12}")
    if counts["flash_decode_attend_int8"] == 0:
        fail(f"{label}: K2's int8 form never launched")
    others = {k: n for k, n in counts.items()
              if k not in ("flash_attention", "flash_decode_attend_int8")
              and n}
    if others:
        fail(f"{label}: kernels off the int8 disagg path launched: {others}")


def phase_disagg(params16, card_str) -> dict:
    """Phase 4f (see the module docstring). Returns the launch counts of
    its serves."""
    from mpi_acx_torch import runtime
    from mpi_acx_torch.models import disagg, serving, transformer as tfm
    from mpi_acx_torch.parallel.kv_ship import layer_part_bytes
    build_host_plane()
    cfg = tfm.gpt2_small()
    prompts, n_new = serve_requests(cfg.vocab)
    kw = dict(n_slots=8, max_len=1024, chunk=8)
    fns = serving.make_server_fns(params16, cfg, tfm, chunk=8, kv_int8=True)
    want_bytes = [12 * layer_part_bytes(min(serving._bucket(len(p)), 1024),
                                        cfg.n_heads, cfg.head_dim)
                  for p in prompts]
    names = ("flash_attention", "flash_decode_attend",
             "flash_decode_attend_int8", "paged_flash_decode_attend",
             "paged_flash_decode_attend_int8")
    total = {}
    rt = runtime.Runtime()
    try:
        # Warm-up: the handoff path's first launches and host buffers.
        disagg.serve_disagg_greedy(params16, cfg, prompts[:2], 4,
                                   server_fns=fns, rt=rt, **kw)
        torch.cuda.synchronize()
        reset_counts()
        mono = serving.serve_greedy(params16, cfg, prompts, n_new,
                                    kv_int8=True, server_fns=fns, **kw)
        torch.cuda.synchronize()
        add_counts(total, read_counts(names))
        check_served("4f (a) monolithic int8", mono, prompts, n_new,
                     cfg.vocab)
        print(f"4f (a) monolithic serve_greedy(kv_int8=True): "
              f"{served_figures(mono.metrics)} [{card_str}]", flush=True)
        for label, variant in (
                ("quantize at wire, per-layer Pready", {}),
                ("quantize at compute, per-layer Pready",
                 dict(prefill_kv_int8=True)),
                ("quantize at wire, ship after prefill",
                 dict(overlap=False))):
            label = f"4f (b) loopback disagg, {label}"
            reset_counts()
            res = disagg.serve_disagg_greedy(params16, cfg, prompts, n_new,
                                             server_fns=fns, rt=rt,
                                             **variant, **kw)
            torch.cuda.synchronize()
            counts = read_counts(names)
            add_counts(total, counts)
            check_served(label, res, prompts, n_new, cfg.vocab)
            exactly_equal(f"{label} vs (a)", res, mono)
            hs = res.metrics.handoffs
            check_disagg_counts(label, counts, len(hs))
            got_bytes = [h.wire_bytes for h in sorted(hs,
                                                      key=lambda h: h.rid)]
            if got_bytes != want_bytes:
                fail(f"{label}: wire bytes {got_bytes}, want {want_bytes}")
            print(f"{label}: tokens equal to (a); {len(hs)} handoffs, "
                  f"{sum(got_bytes)} wire bytes ({min(got_bytes)}-"
                  f"{max(got_bytes)} a handoff); p50 prefill "
                  f"{p50_ms([h.prefill_s for h in hs])} ms, ship "
                  f"{p50_ms([h.ship_s for h in hs])} ms, pickup "
                  f"{p50_ms([h.pickup_s for h in hs])} ms, exposed publish "
                  f"{p50_ms([h.expose_s for h in hs])} ms; "
                  f"{served_figures(res.metrics)} [{card_str}]", flush=True)
        for label, exc, retries in (
                ("peer loss", runtime.AcxPeerDeadError(
                    "tpu-acx: peer dead (injected)", runtime.ERR_PEER_DEAD,
                    0, 0), 0),
                ("plain error", RuntimeError("injected handoff failure"),
                 2)):
            fired = []

            def ship_fault(rid, layer, exc=exc, fired=fired):
                if rid == 1 and layer == DISAGG_FAULT_LAYER and not fired:
                    fired.append(rid)
                    raise exc

            label = f"4f (d) {label} before layer {DISAGG_FAULT_LAYER}"
            reset_counts()
            res = disagg.serve_disagg_greedy(
                params16, cfg, prompts, n_new, server_fns=fns, rt=rt,
                ship_fault=ship_fault, max_request_retries=retries, **kw)
            torch.cuda.synchronize()
            add_counts(total, read_counts(names))
            exactly_equal(f"{label} vs (a)", res, mono)
            m = res.metrics
            retried = [r.retries for r in m.per_request]
            print(f"{label}: requeues {m.requeues}, peer_requeues "
                  f"{m.peer_requeues}, retries {retried}; tokens equal to "
                  f"(a)", flush=True)
            if not fired or m.requeues < 1:
                fail(f"{label}: the fault did not requeue ({fired}, {m})")
            uncharged = isinstance(exc, runtime.AcxPeerDeadError)
            if uncharged and (m.peer_requeues < 1 or any(retried)):
                fail(f"{label}: requeued charged: {retried}")
            if not uncharged and (m.peer_requeues or retried[1] != 1):
                fail(f"{label}: not charged: {retried}")
    finally:
        rt.finalize()
    return total


# --- phase 4d: the MoE family -----------------------------------------------

MOE_F32_LAYERS = 2      # the f32 check's depth (full width)


def moe_serving_config(**kw):
    """MoeTransformerConfig's defaults (GPT-2 small's attention, 8 experts
    each 3072 wide, top-1, 12 layers) with ``capacity_factor = n_experts``:
    the drop-free rule moe_transformer.decode_step prescribes for serving,
    under which a served request's tokens are its solo run's."""
    from mpi_acx_torch.models import moe_transformer as mtf
    cfg = mtf.MoeTransformerConfig(**kw)
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def moe_step_profile(step) -> str:
    """One more decode step under torch.profiler with the MoE layer and its
    experts marked (``moe._moe_forward`` and ``moe._expert_ffn`` wrapped in
    record_function): device time of the router with dispatch and combine
    (the layer less its experts), the experts' upcasts (the f32 copies of
    the bf16 expert weights that JAX's promotion computes with), their
    products and GELU, K2, and the rest (attention's projections, norms,
    the cache writes, the unembedding)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    from mpi_acx_torch.models import moe
    fwd, ffn = moe._moe_forward, moe._expert_ffn

    def marked(name, fn):
        def call(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return call

    moe._moe_forward = marked("moe_layer", fwd)
    moe._expert_ffn = marked("moe_experts", ffn)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    finally:
        moe._moe_forward, moe._expert_ffn = fwd, ffn
    kernels = device_kernels(prof)
    total = sum(ev.device_time_total for ev in kernels)
    k2 = sum(ev.device_time_total for ev in kernels
             if "decode_kernel" in ev.name)
    split = dict.fromkeys(("router, dispatch and combine", "expert upcasts",
                           "expert products and GELU"), 0.0)
    for names, k in attributed_kernels(prof):
        if "decode_kernel" in k.name:
            continue
        if "moe_experts" in names:
            key = ("expert upcasts" if "copy" in k.name
                   else "expert products and GELU")
        elif "moe_layer" in names:
            key = "router, dispatch and combine"
        else:
            continue
        split[key] += k.duration
    split["K2"] = k2
    split["rest"] = max(total - sum(split.values()), 0.0)
    return (f"{len(kernels)} kernels, device {total / 1e3:.3f} ms: "
            + ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / total:.1f}%)"
                        for k, v in split.items()))


def moe_f32(card_str) -> None:
    """The MoE configuration at full width, depth cut to MOE_F32_LAYERS, in
    f32: served through the kernels and through the plain versions (tokens
    and logits as phase 3, routing decisions compared)."""
    from mpi_acx_torch.models import moe_transformer as mtf, serving
    cfg = moe_serving_config(n_layers=MOE_F32_LAYERS, dtype=torch.float32)
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    params = mtf.init_params(cfg, seed=0)
    rng = np.random.default_rng(1)
    lens = [16, 40, 64, 100, 23, 77, 50, 128]
    n_new = [8, 16, 12, 20, 8, 16, 12, 20]
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in lens]
    kw = dict(n_slots=3, max_len=256, chunk=4, family=mtf)
    reset_counts()
    got = serving.serve_greedy(params, cfg, prompts, n_new, **kw)
    counts = read_counts(("flash_attention", "flash_decode_attend"))
    check_no_copies("MoE f32 serve")
    want = serving.serve_greedy(params, plain, prompts, n_new, **kw)
    if min(counts.values()) == 0:
        fail(f"MoE f32 kernel serve did not launch every kernel: {counts}")
    if got.metrics.requeues or want.metrics.requeues:
        fail("MoE f32 serve requeued a request after a failed step")
    compare_paths(f"MoE f32 serve (8 requests, 3 slots, full width, "
                  f"{MOE_F32_LAYERS} layers)", params, cfg, got, want,
                  prompts, fam=mtf, routes=True)
    print(f"MoE f32 serve launches {counts}", flush=True)


def phase_moe(card_str, k2_ms) -> dict:
    """Phase 4d: the MoE family (moe_transformer's default configuration,
    served drop-free) on the card through K1 and K2 at head dim 64: the
    f32 check, then the full model (12 layers, seed-0 f32 weights drawn on
    the card and cast to bf16) serving phase 4's requests with bf16 and
    then int8 KV caches, each held to the same requests through the plain
    versions (ties within TIE_MOE; with bf16 KV the kernel path's logits
    no farther from an f32 forward of the same weights than the plain
    path's);
    K1's launches exactly the prefills x 12 layers, K2 in each cache's
    form; tokens/s, TTFT, ITL, and a decode step issued against its device
    time and profiled by part. Returns the launch counts."""
    from mpi_acx_torch.models import moe_transformer as mtf, serving
    from mpi_acx_torch.models import transformer as tfm
    moe_f32(card_str)
    torch.cuda.empty_cache()
    cfg = moe_serving_config()
    t0 = time.perf_counter()
    params32 = mtf.init_params(cfg, seed=0)
    params = tfm.cast_params(params32, torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["pos"],
                                       params["lnf_g"], params["lnf_b"],
                                       *params["layers"].values()])
    print(f"params: MoE transformer, {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads (D {cfg.head_dim}), {cfg.n_experts} experts "
          f"x d_ff {cfg.d_ff}, top-{cfg.top_k}, capacity factor "
          f"{cfg.capacity_factor}, vocab {cfg.vocab}: {n_params / 1e6:.1f} M "
          f"parameters, {2 * n_params / 1e9:.2f} GB in bf16, drawn on the "
          f"card from seed 0 in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts, n_new = serve_requests(cfg.vocab)
    kw = dict(n_slots=8, max_len=1024, chunk=8, family=mtf)
    plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
    serving.serve_greedy(params, cfg, prompts[:2], 4, **kw)     # warm-up
    counts = {}
    for int8 in (False, True):
        label = f"MoE serve {'int8' if int8 else 'bf16'} KV"
        forms = ("flash_decode_attend", "flash_decode_attend_int8")
        k2, other = forms[::-1] if int8 else forms
        fns = serving.make_server_fns(params, cfg, mtf, chunk=8,
                                      kv_int8=int8)
        torch.cuda.synchronize()
        reset_counts()
        res = serving.serve_greedy(params, cfg, prompts, n_new,
                                   kv_int8=int8, server_fns=fns, **kw)
        torch.cuda.synchronize()
        got = read_counts(("flash_attention", k2, other))
        check_no_copies(label)
        check_served(label, res, prompts, n_new, cfg.vocab)
        check_prefills(label, fns, res.metrics.prefills)
        del fns
        print(f"serve {label}: 16 requests, 8 slots, max_len 1024, chunk 8: "
              f"{served_figures(res.metrics)} [{card_str}]", flush=True)
        print(f"launches during {label}: {json.dumps(got)}", flush=True)
        want_k1 = res.metrics.prefills * cfg.n_layers
        if (got["flash_attention"] != want_k1 or got[k2] == 0
                or got[other]):
            fail(f"{label}: K1 launched {got['flash_attention']} times (the "
                 f"{res.metrics.prefills} prefills x {cfg.n_layers} layers "
                 f"are {want_k1}), {k2} {got[k2]} times, {other} "
                 f"{got[other]}")
        for name, n in got.items():
            counts[name] = counts.get(name, 0) + n
        if not int8:
            SERVED["moe_bf16"] = [np.asarray(o) for o in res]
        want = serving.serve_greedy(params, plain, prompts, n_new,
                                    kv_int8=int8, **kw)
        ref = None if int8 else (
            params32, dataclasses.replace(plain, dtype=torch.float32))
        compare_paths(f"{label} (16 requests, 8 slots)", params, cfg, res,
                      want, prompts, int8=int8, fam=mtf, tie=TIE_MOE,
                      ref=ref, routes=True)
    del params32
    torch.cuda.empty_cache()
    phase_step(params, cfg, mtf, k2_ms, None, card_str,
               label=f"MoE {cfg.n_experts}x{cfg.d_ff}",
               profile=moe_step_profile)
    del params
    torch.cuda.empty_cache()
    print(f"MoE serving launches (phase 4d): {json.dumps(counts)}",
          flush=True)
    return counts


# --- phase 4f --------------------------------------------------------------

# The routed experts against their plain version (ops/moe_experts.py): both
# multiply bf16 operands into f32 sums and round the SwiGLU's h to bf16;
# the kernel's tensor-core sums run in another order, so some h values
# round the other way. The row error is the largest |kernel - plain| in a
# token's output over the plain row's RMS. On the CPU at these widths (16
# experts), relative noise of 1e-6 and 1e-5 in the gate and up products
# moves the plain rows by 1.2e-3 and 2.4e-3, and the rounding of h itself
# moves them by 7.5e-3 from an unrounded f64 run; an H100 reads 3.7e-3.
# The limit is that rounding's own size, rounded up; a pair dropped or sent
# to the wrong expert moves its token's row by about 1 / sqrt(k) of its
# RMS or more.
TOL_EXPERTS_ROW = 1e-2
# A served DeepSeek-V2-Lite token that differs from generate's is a tie
# when the forward pass's logits of the two tokens over the common prefix
# lie within this: the deepseek-v2-lite.serve-chat cell's max_logit_gap
# limit (acxbench/workloads), set between bf16's largest gap to an f32
# reference and float8's smallest.
TIE_DEEPSEEK = 1.0
# The MLA kernels are held to their plain version computed in f32 on the
# same bf16 inputs, within TOL_ROW_F32. Their plain version in bf16 rounds
# the logits, dot products over 576 (decode) or 192 (prefill) dims, to
# bf16: at the decode case it strays from f32 by a row error of 8.2e-2
# itself, farther than the kernel, which keeps them in f32 (1.4e-2; H100).
# The comparison with it is printed, not held. A dropped key tile reads
# 0.86-2.1 (phase 2).


def check_f32(name, desc, e) -> None:
    print(f"kernel {name} bfloat16 {desc}: row err {e['row_f32']:.3e} vs f32 "
          f"plain (tol {TOL_ROW_F32[torch.bfloat16]}); vs bf16 plain: "
          f"max_abs_err {e['abs']:.3e}, row err {e['row']:.3e}, whose own "
          f"row err vs f32 is {e['plain_row_f32']:.3e}", flush=True)
    if not e["row_f32"] <= TOL_ROW_F32[torch.bfloat16]:
        fail(f"{name} disagrees with its plain version")
DS_SLOTS, DS_MAX_LEN, DS_CHUNK = 64, 4096, 4


def event_ms(fn, iters: int = 5) -> float:
    """Mean time of one ``fn`` call between two CUDA events, after a warm
    call: for plain versions that read values back to the host, which a
    CUDA graph cannot hold."""
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(iters):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / iters


def ds_kernel_row(name, card_str, desc, t_k, t_p, t_l, flops, nbytes,
                  library) -> dict:
    b_ms, b_by = bound_ms(flops, nbytes, torch.bfloat16)
    print(f"time {name} bf16 {desc}: kernel {t_k:.5f} ms, plain "
          f"{t_p:.5f} ms, library {library} "
          f"{'—' if t_l is None else f'{t_l:.5f} ms'}, bound {b_ms:.5f} ms "
          f"({b_by}) [{card_str}]", flush=True)
    return dict(ms=t_k, plain_ms=t_p, library_ms=t_l, bound_ms=b_ms,
                bound_by=b_by)


def ds_mla_decode(gen, card_str):
    """The MLA decode kernel at the cell's decode batch: 64 slots of 4096,
    16 heads of 512 + 64, one slot at position 0, one full, the rest at
    0-1069 (about 34k live rows)."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops import mla
    B, T, Hs, r, dr = DS_SLOTS, DS_MAX_LEN, 16, 512, 64
    scale = mla.softmax_scale(192, 40.0, 0.707)
    q = randn((B, 1, Hs, r + dr), torch.bfloat16, gen)
    cache = randn((B, T, 1, r + dr), torch.bfloat16, gen)
    pos = torch.randint(0, 1070, (B,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[1] = 0, T - 1
    live = int((pos + 1).sum())
    out = torch.empty((B, 1, Hs, r), dtype=torch.bfloat16, device="cuda")
    got = mla.mla_decode_attend(q, cache, pos, scale, r, out=out).clone()
    want = mla.mla_decode_reference(q, cache, pos, scale, r)
    want32 = mla.mla_decode_reference(q.float(), cache.float(), pos, scale,
                                      r)
    e = errors(got, want, want32, head_dim=r)
    desc = f"B={B} max_len={T} H={Hs} D={r}+{dr} live={live}"
    check_f32("mla_decode_attend", desc, e)
    mask = (torch.arange(T, device="cuda")[None, :]
            <= pos[:, None])[:, None, None, :]
    k = cache.transpose(1, 2)
    t = ds_kernel_row(
        "mla_decode_attend", card_str, desc,
        time_ms(lambda: mla.mla_decode_attend(q, cache, pos, scale, r,
                                              out=out)),
        time_ms(lambda: mla.mla_decode_reference(q, cache, pos, scale, r),
                iters=10),
        time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k, k[..., :r], attn_mask=mask, scale=scale),
            iters=10),
        2 * Hs * live * (r + dr + r),
        live * (r + dr) * 2 + B * Hs * (r + dr + r) * 2,
        "(sdpa over the whole cache, length mask)")
    return e, t


def ds_mla_prefill(gen, card_str):
    """The MLA prefill kernel (K1 at 192/128) at the cell's prompts: 16
    heads, B = 1 at S = 161, 1000 and 1024, and B = 2 at S = 333; timed at
    161 and 1024 (the row's figures are their means)."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops import mla
    Hs, dqk, dv = 16, 192, 128
    scale = mla.softmax_scale(dqk, 40.0, 0.707)
    worst, rows = None, []
    for B, S in ((1, 161), (1, 1000), (1, 1024), (2, 333)):
        q, k = (randn((B, S, Hs, dqk), torch.bfloat16, gen)
                for _ in range(2))
        v = randn((B, S, Hs, dv), torch.bfloat16, gen)
        got = mla.mla_flash_attention(q, k, v, scale)
        want = mla.mla_attention_reference(q, k, v, scale)
        want32 = mla.mla_attention_reference(q.float(), k.float(),
                                             v.float(), scale)
        e = errors(got, want, want32, head_dim=dv)
        desc = f"B={B} S={S} H={Hs} D={dqk}/{dv} causal"
        check_f32("mla_flash_attention", desc, e)
        worst = e if worst is None else {
            key: max(worst[key], e[key]) for key in e}
        if B > 1 or S == 1000:
            continue
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        pairs = B * S * (S + 1) // 2
        rows.append((
            time_ms(lambda: mla.mla_flash_attention(q, k, v, scale)),
            time_ms(lambda: mla.mla_attention_reference(q, k, v, scale),
                    iters=20),
            time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, scale=scale), iters=20),
            2 * Hs * pairs * (dqk + dv),
            B * S * Hs * (2 * dqk + 2 * dv) * 2))
        ds_kernel_row("mla_flash_attention", card_str, desc, *rows[-1],
                      "(sdpa, causal)")
    mean = np.mean(rows, axis=0)
    t = ds_kernel_row("mla_flash_attention", card_str, "mean of S = 161 "
                      "and 1024", *mean, "(sdpa, causal)")
    return worst, t


def ds_routed_experts(gen, card_str):
    """The routed experts at the cell's decode batch: 64 tokens, top-6 of
    64 experts of 2048 x 1408, routed by ops/moe_experts.route."""
    from mpi_acx_torch.ops import moe_experts as mx
    T, d, E, I, K = DS_SLOTS, 2048, 64, 1408, 6
    x = randn((T, d), torch.bfloat16, gen)
    wg, wu = (randn((E, d, I), torch.float32, gen).mul_(0.02).bfloat16()
              for _ in range(2))
    wd = randn((E, I, d), torch.float32, gen).mul_(0.02).bfloat16()
    router = randn((d, E), torch.float32, gen).mul_(0.02).bfloat16()
    ids, w = mx.route(x, router, K)
    n = mx.expert_counts(ids, E)
    got = mx.routed_experts(x, ids, w, n, wg, wu, wd)
    want = mx.routed_experts_reference(x, ids, w, wg, wu, wd)
    rms = want.square().mean(-1).sqrt()
    e = {"abs": (got - want).abs().max().item(),
         "row": ((got - want).abs().amax(-1) / rms).max().item()}
    touched = int((n > 0).sum())
    desc = f"T={T} d={d} E={E} I={I} k={K} touched={touched}"
    print(f"kernel routed_experts bf16 {desc}: max_abs_err {e['abs']:.3e}, "
          f"row err {e['row']:.3e} vs plain (tol {TOL_EXPERTS_ROW})",
          flush=True)
    if not e["row"] <= TOL_EXPERTS_ROW:
        fail("routed_experts disagrees with its plain version")
    t = ds_kernel_row(
        "routed_experts", card_str, desc,
        time_ms(lambda: mx.routed_experts(x, ids, w, mx.expert_counts(
            ids, E), wg, wu, wd)),
        event_ms(lambda: mx.routed_experts_reference(x, ids, w, wg, wu,
                                                     wd)),
        None, T * K * 3 * 2 * d * I, touched * 3 * d * I * 2 + T * d * 2 * 2,
        "none: no one PyTorch call")
    return e, t


def ds_counts():
    from mpi_acx_torch.ops import mla, moe_experts as mx
    return {"mla_flash_attention": mla.mla_flash_attention.launches,
            "mla_decode_attend": mla.mla_decode_attend.launches,
            "routed_experts": mx.routed_experts.launches}


def ds_reset_counts():
    from mpi_acx_torch.ops import mla, moe_experts as mx
    mla.mla_flash_attention.launches = 0
    mla.mla_decode_attend.launches = 0
    mx.routed_experts.launches = 0
    reset_counts()


def ds_requests(vocab):
    """64 requests, one a slot: prompts of 32/128/256/512 tokens asking
    for 16/64/128/32 new ones (phase 4's mix, four times over)."""
    rng = np.random.default_rng(5)
    lens, news = [32, 128, 256, 512], [16, 64, 128, 32]
    prompts = [rng.integers(0, vocab, lens[i % 4]).astype(np.int32)
               for i in range(DS_SLOTS)]
    return prompts, [news[i % 4] for i in range(DS_SLOTS)]


def phase_deepseek(card_str):
    """Phase 4f: DeepSeek-V2-Lite's kernels at the served path's shapes,
    each held to its plain version, then the model at its published widths
    and full depth served through serve_greedy. Returns (launch counts,
    errors, timings) for the kernels line."""
    from mpi_acx_torch.models import deepseek_v2 as ds, serving
    gen = torch.Generator(device="cuda").manual_seed(19)
    bf = torch.bfloat16
    errs, times = {}, {}
    for name, fn in (("mla_decode_attend", ds_mla_decode),
                     ("mla_flash_attention", ds_mla_prefill),
                     ("routed_experts", ds_routed_experts)):
        errs[(name, bf)], times[name] = fn(gen, card_str)
    torch.cuda.empty_cache()

    cfg = ds.deepseek_v2_lite()
    t0 = time.perf_counter()
    params = ds.init_params(cfg, seed=0, device="cuda", dtype=bf)
    torch.cuda.synchronize()
    def leaves(tree):
        return ([t for v in tree.values() for t in leaves(v)]
                if isinstance(tree, dict) else [tree])
    n_params = sum(t.numel() for t in leaves(params))
    print(f"params: DeepSeek-V2-Lite, {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.q_head}/"
          f"{cfg.v_head} over a {cfg.latent}-wide latent row, "
          f"{cfg.n_experts} experts of {cfg.d_expert} (top-{cfg.top_k}) and "
          f"{cfg.n_shared} shared, vocab {cfg.vocab}: {n_params / 1e9:.3f} B "
          f"parameters, {2 * n_params / 1e9:.2f} GB in bf16, drawn on the "
          f"card from seed 0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    prompts, n_new = ds_requests(cfg.vocab)
    kw = dict(n_slots=DS_SLOTS, max_len=DS_MAX_LEN, chunk=DS_CHUNK,
              family=ds)
    fns = serving.make_server_fns(params, cfg, ds, chunk=DS_CHUNK)
    # Warm-up: one prompt of each length, so every bucket is captured.
    serving.serve_greedy(params, cfg, prompts[:4], [4] * 4, server_fns=fns,
                         **kw)
    gr = fns.slots.cache.graphs
    before = (gr.captures, gr.eager, gr.replayed)
    before_prefills = prefill_counts(fns)
    torch.cuda.synchronize()
    ds_reset_counts()
    res = serving.serve_greedy(params, cfg, prompts, n_new, server_fns=fns,
                               **kw)
    torch.cuda.synchronize()
    got = ds_counts()
    got["flash_attention"] = read_counts(("flash_attention",))[
        "flash_attention"]
    label = "DeepSeek-V2-Lite serve"
    check_served(label, res, prompts, n_new, cfg.vocab)
    _, p_eager, p_captures = check_prefills(
        label, fns, res.metrics.prefills, before_prefills, warm=True)
    captures, eager, replayed = (a - b for a, b in zip(
        (gr.captures, gr.eager, gr.replayed), before))
    rc = np.asarray(res.round_counters, dtype=np.int64)  # [rounds+1, Lm, 2]
    steps = DS_CHUNK * (len(rc) - 1)
    moe = (rc[-1] - rc[0])
    print(f"serve {label}: {len(prompts)} requests, {DS_SLOTS} slots, "
          f"max_len {DS_MAX_LEN}, chunk {DS_CHUNK}: "
          f"{served_figures(res.metrics)}; decode steps {steps}: replayed "
          f"{replayed}, eager {eager}, captures {captures}; experts touched "
          f"{moe[:, 0].sum() / max(steps, 1) / cfg.n_moe:.2f} of "
          f"{cfg.n_experts} a layer a step, pairs {moe[:, 1].sum()}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          f"[{card_str}]", flush=True)
    print(f"launches during {label}: {json.dumps(got)}", flush=True)
    want = dict(mla_flash_attention=res.metrics.prefills * cfg.n_layers,
                mla_decode_attend=steps * cfg.n_layers,
                routed_experts=(p_eager + p_captures) * cfg.n_moe,
                flash_attention=0)
    if (got != want or replayed != steps or eager or captures
            or (moe[:, 1] != steps * DS_SLOTS * cfg.top_k).any()):
        fail(f"{label}: launches {got} (want {want}: the prefills x layers, "
             f"the decode steps x layers, the prefills run eagerly or "
             f"captured x MoE layers: a replayed step or prefill issues the "
             f"experts inside its graph), "
             f"{replayed} of {steps} steps replayed, {eager} eager, "
             f"{captures} captures, pairs per MoE layer "
             f"{moe[:, 1].tolist()} (want {steps * DS_SLOTS * cfg.top_k})")
    # Served tokens against generate's for one request of each length.
    for rid in range(4):
        p, o = prompts[rid], np.asarray(res[rid])
        ref = ds.generate(params, cfg, torch.tensor(p)[None], n_new[rid],
                          max_len=DS_MAX_LEN)[0].cpu().numpy()
        if np.array_equal(o, ref):
            continue
        i = int(np.argmax(o != ref))
        lg = ds.forward(params, cfg, torch.tensor(
            ref[:i], device="cuda")[None])[0, -1]
        margin = float((lg[ref[i]] - lg[o[i]]).abs())
        print(f"{label} request {rid}: served and generate part at position "
              f"{i}, logits {margin:.3e} apart (tie within {TIE_DEEPSEEK})",
              flush=True)
        if margin > TIE_DEEPSEEK:
            fail(f"{label} request {rid}: token {o[i]} against generate's "
                 f"{ref[i]} at position {i}, logits {margin:.3e} apart")
    del fns, res, params
    torch.cuda.empty_cache()
    return got, errs, times


# --- phase 5b --------------------------------------------------------------

TRAIN_M, TRAIN_STEPS, TRAIN_LR = 2, 5, 1e-3


def ramp_batch(vocab, m=TRAIN_M):
    """The synthetic task of examples/train_distributed.py: predict the
    next token of a ramp, [m, mb, S] tokens and targets, made on the
    card."""
    dev = "cuda"
    base = (torch.arange(TRAIN_S, device=dev)[None, None, :]
            + torch.arange(TRAIN_B, device=dev)[None, :, None])
    tokens = (base + torch.arange(m, device=dev)[:, None, None]) % vocab
    return tokens, torch.roll(tokens, -1, dims=-1)


def adamw(params, lr=TRAIN_LR):
    """The training phases' AdamW over the parameters' tensors."""
    from mpi_acx_torch import train
    return torch.optim.AdamW(train.param_leaves(params), lr=lr,
                             betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def one_stage_mesh():
    from mpi_acx_torch.parallel.mesh import mesh_from_devices
    return mesh_from_devices({"dp": 1, "pp": 1, "tp": 1})


def train_run(cfg, params, batch, lr=TRAIN_LR, steps=TRAIN_STEPS,
              final=True, **options):
    """``steps`` AdamW steps (learning rate ``lr``) of the port's train
    step, with its pipeline ``options`` (remat, n_virtual, schedule), on
    ``params`` (stage-sliced, updated in place): per-step losses,
    per-step host
    seconds (each ends in a synchronize), the launch counts of the
    attention kernels over the steps, the peak device memory, the loss
    after the last step (when ``final``), and the step and params (for
    one more step)."""
    from mpi_acx_torch import train
    mesh = one_stage_mesh()
    n_micro = batch[0].shape[0]
    step, n_stages = train.make_train_step_optim(
        cfg, mesh, n_micro, adamw(params, lr), **options)
    if n_stages != 1:
        fail(f"train step has {n_stages} stages on a 1x1x1 mesh")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params = step(params, *batch)
        losses.append(loss.item())              # synchronizes
        secs.append(time.perf_counter() - t0)
    counts = read_counts()
    from mpi_acx_torch.ops.attention import flash_attention
    copies = flash_attention.copies
    peak = torch.cuda.max_memory_allocated()
    if final:
        grad_fn, _ = train.make_loss_and_grads(cfg, mesh, n_micro, **options)
        final = grad_fn(params, *batch)[0].item()
    return dict(losses=losses, secs=secs, counts=counts, copies=copies,
                peak=peak, final=final, step=step, params=params)


def profile_step(step, params, batch) -> dict:
    """One more step under torch.profiler: device time by kernel, split
    into the forward, the backward (the attention's part apart), the
    optimizer and what the profiler did not attribute; the wall time of
    the step; and the device's busy share of it."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    split = dict.fromkeys(("forward", "backward", "attention_backward",
                           "optimizer", "unattributed"), 0.0)
    attributed = 0.0
    for names, k in attributed_kernels(prof):
        us = k.duration
        attributed += us
        if any(n.startswith("Optimizer.step") for n in names):
            split["optimizer"] += us
        elif any(n.startswith("autograd::engine::evaluate_function")
                 for n in names):
            split["backward"] += us
            if any("_FlashLseBackward" in n for n in names):
                split["attention_backward"] += us
        else:
            split["forward"] += us
    by_name = {}
    for ev in device_kernels(prof):
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.device_time_total
    device = sum(by_name.values())
    split["unattributed"] = max(device - attributed, 0.0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(split_ms={k: v / 1e3 for k, v in split.items()},
                device_ms=device / 1e3, wall_ms=wall * 1e3,
                top_ms=[(name[:60], us / 1e3) for name, us in top])


def print_profile(label, prof, step_ms, card_str) -> None:
    sp = prof["split_ms"]
    if prof["device_ms"] <= 0:
        print(f"{label} train step profile: not measured (the profiler saw "
              f"no device time; wall {prof['wall_ms']:.1f} ms)", flush=True)
        return
    print(f"{label} train step profile (one more step, B10): wall "
          f"{prof['wall_ms']:.1f} ms under the profiler, device "
          f"{prof['device_ms']:.1f} ms: busy "
          f"{100 * prof['device_ms'] / prof['wall_ms']:.1f}% of the "
          f"profiled step, {100 * prof['device_ms'] / step_ms:.1f}% of "
          f"the unprofiled step ({step_ms:.1f} ms); forward "
          f"{sp['forward']:.1f} ms, backward {sp['backward']:.1f} ms "
          f"(attention's {sp['attention_backward']:.1f} ms), optimizer "
          f"{sp['optimizer']:.1f} ms, unattributed "
          f"{sp['unattributed']:.1f} ms [{card_str}]", flush=True)
    print(f"{label} train step profile, device time by kernel: "
          + "; ".join(f"{name} {ms:.1f} ms" for name, ms in prof["top_ms"]),
          flush=True)


def train_phase(card_str, label, cfg, make_init, around_kernel_run=None,
                lr=TRAIN_LR):
    """TRAIN_STEPS AdamW steps of M=2 microbatches of 4 x 1024 tokens of
    the ramp task from ``make_init()`` (stage-sliced f32 params, drawn from
    a seed) through B10's kernel, and one more step profiled; then, with
    that run's parameters and optimizer freed, the same steps from a fresh
    ``make_init()`` through the dense ring blocks: per-step losses held to
    each other, the loss to fall, B10's launches (at the config's head
    dim) to be exactly layers x microbatches x steps in the kernel run and
    none in the dense one; step time, tokens/s and each run's peak memory
    printed. ``around_kernel_run`` is a context manager entered around the
    kernel run; ``lr`` is AdamW's learning rate. Returns the kernel run's
    launch counts, per-step losses, step seconds and peak memory."""
    from mpi_acx_torch import train
    plain = dataclasses.replace(cfg, use_flash=False)
    batch = ramp_batch(cfg.vocab)
    n_tok = TRAIN_M * TRAIN_B * TRAIN_S
    lse_name = lse_form(cfg.head_dim)[0]
    init = make_init()
    n = sum(p.numel() for p in train.param_leaves(init))
    print(f"{label} train: {n} parameters ({4 * n / 1e9:.2f} GB in f32), "
          f"{cfg.n_layers} layers", flush=True)
    with around_kernel_run or contextlib.nullcontext():
        kern = train_run(cfg, init, batch, lr)
    del init
    step_ms = 1e3 * float(np.mean(kern["secs"][1:]))
    print_profile(label, profile_step(kern["step"], kern["params"], batch),
                  step_ms, card_str)
    del kern["step"], kern["params"]
    torch.cuda.empty_cache()
    dense = train_run(plain, make_init(), batch, lr)
    del dense["step"], dense["params"]
    torch.cuda.empty_cache()
    want = cfg.n_layers * TRAIN_M * TRAIN_STEPS
    got = kern["counts"][lse_name]
    print(f"{label} train launches, kernel run: {json.dumps(kern['counts'])}"
          f"; dense run: {json.dumps(dense['counts'])}", flush=True)
    check_no_copies(f"{label} train, kernel run", kern["copies"])
    if got != want or dense["counts"][lse_name] != 0:
        fail(f"{label}: {lse_name} launched {got} times in the kernel run "
             f"(want {cfg.n_layers} layers x {TRAIN_M} microbatches x "
             f"{TRAIN_STEPS} steps = {want}) and "
             f"{dense['counts'][lse_name]} in the dense run")
    tols = [TOL_TRAIN_LOSS0] + [TOL_TRAIN_LOSS] * (TRAIN_STEPS - 1)
    ok = True
    for i, (a, b) in enumerate(zip(kern["losses"], dense["losses"])):
        print(f"{label} train step {i}: loss {a:.6f} through B10, {b:.6f} "
              f"through the dense blocks, |diff| {abs(a - b):.3e} (tol "
              f"{tols[i]}); {kern['secs'][i] * 1e3:.1f} ms and "
              f"{dense['secs'][i] * 1e3:.1f} ms", flush=True)
        ok = ok and abs(a - b) <= tols[i]
    print(f"{label} train loss after {TRAIN_STEPS} steps: "
          f"{kern['final']:.6f} through B10, {dense['final']:.6f} dense "
          f"(step 0: {kern['losses'][0]:.6f})", flush=True)
    if not all(math.isfinite(x) for x in kern["losses"] + dense["losses"]
               + [kern["final"], dense["final"]]):
        fail(f"{label}: a training loss is not finite")
    if not ok or abs(kern["final"] - dense["final"]) > TOL_TRAIN_LOSS:
        fail(f"{label}: the kernel run's losses differ from the dense run's")
    if not kern["final"] < kern["losses"][0]:
        fail(f"{label}: training did not lower the loss: "
             f"{kern['losses'][0]:.6f} -> {kern['final']:.6f}")
    # Steady steps: all but the first (which also warms up cuBLAS and the
    # allocator).
    for run, r in (("B10", kern), ("dense", dense)):
        ms = 1e3 * float(np.mean(r["secs"][1:]))
        print(f"train step {label} bf16 (f32 params, AdamW lr {lr:g}), "
              f"M={TRAIN_M} x {TRAIN_B} x {TRAIN_S} tokens, {run}: "
              f"{ms:.1f} ms per step "
              f"(mean of steps 1-{TRAIN_STEPS - 1}), "
              f"{n_tok / ms * 1e3:.0f} tokens/s, peak memory "
              f"{r['peak'] / 2 ** 30:.2f} GiB [{card_str}]", flush=True)
    return {k: kern[k] for k in ("counts", "losses", "peak", "secs")}


def staged(params, n_virtual=1):
    """``params`` stage-sliced for the one-stage mesh, interleaved into
    ``n_virtual`` chunks above 1."""
    from mpi_acx_torch.models import transformer as tfm
    if n_virtual > 1:
        return tfm.stage_slice_interleaved(params, 1, n_virtual)
    return tfm.stage_slice(params, 1)


def gpt2_init(n_virtual=1):
    """GPT-2 124M's seed-0 f32 parameters drawn on the card, staged."""
    from mpi_acx_torch.models import transformer as tfm
    return staged(tfm.init_params(dataclasses.replace(
        tfm.gpt2_small(), dtype=torch.float32), seed=0), n_virtual)


def phase_train(card_str):
    """Phase 5b: GPT-2 124M at full width and depth (seed-0 f32 params,
    bf16 compute) trained through the port's train step on a 1x1x1 mesh
    (:func:`train_phase`). Returns B10's launch count in the kernel run,
    and that run (its losses and peak)."""
    from mpi_acx_torch.models import transformer as tfm
    run = train_phase(card_str, "GPT-2 124M", tfm.gpt2_small(), gpt2_init)
    return {"flash_attention_lse": run["counts"]["flash_attention_lse"]}, run


def phase_moe_train(card_str) -> dict:
    """Phase 5c: the MoE configuration at full width and depth, at its
    training capacity factor (2.0: tokens past capacity drop), trained as
    phase 5b trains GPT-2 (:func:`train_phase`; router loss weights at the
    train step's defaults), with each step's load-balance term printed
    (the mean over its router calls, read from the gates the kernel run
    routed with). Returns B10's launch count in the kernel run, and that
    run."""
    from mpi_acx_torch.models import moe, moe_transformer as mtf
    cfg = mtf.MoeTransformerConfig()
    log = []
    run = train_phase(card_str, "MoE", cfg, lambda: moe_init(cfg),
                      around_kernel_run=recorded_routes(log))
    calls = cfg.n_layers * TRAIN_M      # router calls a step
    for i in range((len(log)) // calls):
        lb = torch.stack([moe.load_balance_loss(g, k) for g, k in
                          log[i * calls:(i + 1) * calls]]).mean().item()
        when = f"step {i}" if i < TRAIN_STEPS else f"after {TRAIN_STEPS} steps"
        print(f"MoE train {when}: load-balance term {lb:.6f} (mean over "
              f"{calls} router calls; 1.0 is uniform routing)", flush=True)
    return {"flash_attention_lse": run["counts"]["flash_attention_lse"]}, run


def moe_init(cfg):
    """The MoE configuration's seed-0 f32 parameters on the card, staged."""
    from mpi_acx_torch.models import moe_transformer as mtf
    return staged(mtf.init_params(dataclasses.replace(
        cfg, dtype=torch.float32), seed=0))


LLAMA_TRAIN_LAYERS = 4      # of Llama-3-8B's 32: the one cut of phase 5d
# Phase 5d's AdamW learning rate: phase 5b's scaled by GPT-2 small's width
# over Llama-3-8B's (768 / 4096). Adam moves every weight by about lr a
# step, so a product over d inputs moves by about lr * d; the same lr * d
# keeps phase 5b's step in the logits. At 5b's own 1e-3 the 4-layer model
# overshoots on an H100 (loss 12.64, 1.28 and 0.11 after one and two
# steps, 11.85 after five), and two runs that differ only in rounding
# part by 0.21 at step 4.
LLAMA_TRAIN_LR = TRAIN_LR * 768 / 4096


def phase_llama_train(card_str) -> dict:
    """Phase 5d: Llama-3-8B at full width (d 4096, 32 query heads over 8
    KV groups, D = 128, SwiGLU 14336, vocab 128256, RoPE theta 500000)
    cut to LLAMA_TRAIN_LAYERS layers, seed-0 f32 parameters drawn on the
    card, bf16 compute, trained as phase 5b trains GPT-2
    (:func:`train_phase`) at LLAMA_TRAIN_LR. Returns B10's D = 128 launch
    count in the kernel run, and that run."""
    cfg = llama_train_config()
    run = train_phase(card_str, "Llama-3-8B (4 layers)", cfg,
                      lambda: llama_init(cfg), lr=LLAMA_TRAIN_LR)
    return ({"flash_attention_lse_d128":
             run["counts"]["flash_attention_lse_d128"]}, run)


def llama_train_config():
    from mpi_acx_torch.models import llama
    return dataclasses.replace(llama.llama3_8b(), n_layers=LLAMA_TRAIN_LAYERS)


def llama_init(cfg):
    """Phase 5d's seed-0 f32 parameters drawn on the card, staged."""
    from mpi_acx_torch.models import llama
    return staged(llama.init_params(cfg, seed=0, dtype=torch.float32))


# --- phase 5e --------------------------------------------------------------

ENTRY_DIR = ROOT / "build" / "smoke_train_entry"   # 5e's files, removed after
SAVE_STEP = 2           # 5e (b): saved after step 2 of 0-4, resumed at 3
# 5e (d): GPipe again first, so that every option's step time is read
# beside it under the same conditions.
SCHEDULES = {"gpipe": {}, "remat": dict(remat=True),
             "n_virtual=2": dict(n_virtual=2), "1f1b": dict(schedule="1f1b"),
             "1f1b, n_virtual=2": dict(schedule="1f1b", n_virtual=2)}
FLAT_M = (2, 8)         # 5e (e): microbatches of TRAIN_B x TRAIN_S tokens
# 5e (e): 1F1B's peak at M = 8 may exceed its peak at M = 2 by this share
# of it. What grows with M under 1F1B is the embedded inputs, M x 4 x
# 1024 x 768 bf16 (6.3 MB a microbatch), against a peak of gigabytes.
FLAT_TOL = 0.10


def b10_per_step(n_layers, n_micro, n_virtual=1, schedule="gpipe",
                 remat=False) -> int:
    """B10's launches in one train step on the one-stage mesh, read from
    the port's own schedule: GPipe (interleaved or not) runs every layer
    once a microbatch; 1F1B runs a chunk of n_layers / n_virtual layers at
    each forward op of its timetable and again at each backward op, which
    re-runs the chunk from its banked input; remat adds the recompute of
    every layer that autograd back-propagates through."""
    again = 2 if remat else 1
    if schedule != "1f1b":
        return n_layers * n_micro * again
    from mpi_acx_torch.parallel.pipeline import _sched_1f1b_tables
    sc = _sched_1f1b_tables(1, n_micro, n_virtual)
    fwd = int((sc.f_m[0] >= 0).sum())
    bwd = int((sc.b_m[0] >= 0).sum())
    return n_layers // n_virtual * (fwd + bwd * again)


def check_b10(label, counts, head_dim, want) -> int:
    name = lse_form(head_dim)[0]
    print(f"{label}: {name} launched {counts[name]} times (the schedule "
          f"gives {want})", flush=True)
    if counts[name] != want:
        fail(f"{label}: {name} launched {counts[name]} times, want {want}")
    return counts[name]


def hold_losses(label, got, want, later=TOL_TRAIN_LOSS) -> None:
    """Per-step losses within TOL_TRAIN_LOSS0 (step 0) and ``later``
    (TOL_TRAIN_LOSS unless given) of a GPipe kernel run's."""
    tols = [TOL_TRAIN_LOSS0] + [later] * (len(got) - 1)
    diffs = [abs(a - b) for a, b in zip(got, want)]
    print(f"{label}: losses {', '.join(f'{x:.6f}' for x in got)}; |diff| "
          f"to the GPipe kernel run {', '.join(f'{d:.3e}' for d in diffs)}"
          f" (tol {TOL_TRAIN_LOSS0} at step 0, then {later})",
          flush=True)
    if not all(math.isfinite(x) for x in got):
        fail(f"{label}: a training loss is not finite")
    if any(d > t for d, t in zip(diffs, tols)):
        fail(f"{label}: the losses differ from the GPipe kernel run's")


def option_run(label, cfg, init, ref, card_str, lr=TRAIN_LR, m=TRAIN_M,
               steps=TRAIN_STEPS, **options) -> dict:
    """``steps`` AdamW steps of the train step with ``options`` from
    ``init`` on the ramp batch of ``m`` microbatches: the losses held to
    ``ref`` (a GPipe kernel run's, when given), B10 held to the schedule's
    count, K1's operand copies to none; ms per step and peak memory
    printed. Returns the launch counts and the peak."""
    run = train_run(cfg, init, ramp_batch(cfg.vocab, m), lr, steps=steps,
                    final=False, **options)
    del run["step"], run["params"]
    torch.cuda.empty_cache()
    if ref is not None:
        hold_losses(label, run["losses"], ref)
    check_b10(label, run["counts"], cfg.head_dim,
              steps * b10_per_step(cfg.n_layers, m, **options))
    check_no_copies(label, run["copies"])
    ms = 1e3 * float(np.mean(run["secs"][1:]))
    print(f"{label}: {ms:.1f} ms per step (mean of steps 1-{steps - 1}), "
          f"M={m} x {TRAIN_B} x {TRAIN_S} tokens, peak memory "
          f"{run['peak'] / 2 ** 30:.2f} GiB [{card_str}]", flush=True)
    return run


def same_state(label, got, want, limit) -> None:
    """Losses (lists) or parameter leaves (tensors) equal within
    ``limit`` (0: bit-equal)."""
    worst = max((abs(a - b) if isinstance(a, float) else
                 (a - b).abs().max().item()) for a, b in zip(got, want))
    print(f"{label}: largest difference {worst:.3e} (limit {limit:.3e})",
          flush=True)
    if len(got) != len(want) or worst > limit:
        fail(f"{label}: differs by {worst:.3e}, limit {limit:.3e}")


def entry_data_checkpoint(card_str) -> int:
    """5e (a)-(c) on GPT-2 124M at full width and depth: the ramp task
    read from a uint16 token file through TokenDataset, batches(seed=0)
    and prefetch onto the card; a checkpoint saved in the background and
    resumed; StepTimer and a trace. Returns B10's launches."""
    import itertools
    import shutil
    from mpi_acx_torch import checkpoint, data, profiling, train
    from mpi_acx_torch.models import transformer as tfm
    cfg = tfm.gpt2_small()
    mesh = one_stage_mesh()
    shape = (TRAIN_M, TRAIN_B, TRAIN_S + 1)
    per_step = b10_per_step(cfg.n_layers, TRAIN_M)
    shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    ENTRY_DIR.mkdir(parents=True)
    path = ENTRY_DIR / "ramp.bin"
    (np.arange(16 * cfg.vocab) % cfg.vocab).astype(np.uint16).tofile(path)
    ds = data.TokenDataset(str(path))
    launches = 0

    def windows(skip=0):
        return itertools.islice(data.batches(
            ds, TRAIN_M * TRAIN_B, TRAIN_S, seed=0, n_batches=TRAIN_STEPS),
            skip, None)

    def on_card(feed):
        return (torch.tensor(w, device="cuda") for w in feed)

    def fresh():
        params = gpt2_init()
        opt = adamw(params)
        return params, opt, train.make_train_step_optim(cfg, mesh, TRAIN_M,
                                                        opt)[0]

    def run(label, params, step, feed, timer=None, after=None):
        nonlocal launches
        reset_counts()
        losses = []
        for i, w in enumerate(feed):
            w = w.view(shape)
            with timer.step() if timer else contextlib.nullcontext() as r:
                loss, _ = step(params, w[..., :-1], w[..., 1:])
                if timer:
                    r.sync(loss)
            losses.append(loss.item())
            if after:
                after(i)
        launches += check_b10(label, read_counts(), cfg.head_dim,
                              per_step * len(losses))
        return losses

    try:
        # Two uninterrupted runs fed with tensors made on the card: their
        # difference is the limit of (a) and (b) (0 if the step is
        # deterministic on this card).
        params, opt, step = fresh()
        direct_timer = profiling.StepTimer()
        direct = run("5e direct", params, step, on_card(windows()),
                     direct_timer)
        ref = [p.detach().clone() for p in train.param_leaves(params)]
        del params, opt, step
        params, opt, step = fresh()
        again = run("5e direct, again", params, step, on_card(windows()))
        limit_loss = max(abs(a - b) for a, b in zip(direct, again))
        limit = max(limit_loss, max((a - b).abs().max().item() for a, b in
                                    zip(train.param_leaves(params), ref)))
        print(f"5e: two uninterrupted runs differ by {limit:.3e} in a loss "
              f"or parameter (the limit of (a) and (b); 0 = bit-equal)",
              flush=True)
        del params, opt, step

        # (a) prefetched, timed, (b) saved after step SAVE_STEP in the
        # background.
        params, opt, step = fresh()
        timer = profiling.StepTimer()
        ckpt = checkpoint.Checkpointer(str(ENTRY_DIR / "ckpt"),
                                       max_to_keep=1)
        ms = {}

        def save(i):
            if i == SAVE_STEP:
                t0 = time.perf_counter()
                ckpt.save(SAVE_STEP, {"params": params,
                                      "opt": opt.state_dict(),
                                      "step": SAVE_STEP}, wait=False)
                ms["save"] = 1e3 * (time.perf_counter() - t0)

        fed = run("5e (a) prefetched", params, step,
                  data.prefetch(windows()), timer, save)
        t0 = time.perf_counter()
        ckpt.wait_until_finished()
        ms["wait"] = 1e3 * (time.perf_counter() - t0)
        same_state("5e (a) prefetched losses against direct ones", fed,
                   direct, limit_loss)
        print(f"5e (c) StepTimer over (a)'s steps: "
              f"{json.dumps(timer.summary())}; over the first direct "
              f"run's: {json.dumps(direct_timer.summary())} [{card_str}]",
              flush=True)
        del params, opt, step

        # (b) a fresh model and optimizer, restored, run steps 3-4.
        params, opt, step = fresh()
        t0 = time.perf_counter()
        state = ckpt.restore(like={"params": params,
                                   "opt": opt.state_dict(), "step": 0})
        with torch.no_grad():
            for p, r in zip(train.param_leaves(params),
                            train.param_leaves(state["params"])):
                p.copy_(r)
        opt.load_state_dict(state["opt"])
        torch.cuda.synchronize()
        ms["restore"] = 1e3 * (time.perf_counter() - t0)
        if state["step"] != SAVE_STEP:
            fail(f"5e (b): restored step {state['step']}, saved {SAVE_STEP}")
        del state
        ckpt_file = ENTRY_DIR / "ckpt" / str(SAVE_STEP) / "state.pt"
        print(f"5e (b) checkpoint of step {SAVE_STEP} (params and AdamW "
              f"state): {ckpt_file.stat().st_size} bytes; save(wait=False) "
              f"returned in {ms['save']:.1f} ms, the background write ended "
              f"{ms['wait']:.1f} ms after the last step, restore into a "
              f"fresh model and AdamW {ms['restore']:.1f} ms [{card_str}]",
              flush=True)
        resumed = run("5e (b) resumed", params, step,
                      data.prefetch(windows(SAVE_STEP + 1)))
        same_state("5e (b) resumed losses against the uninterrupted run's",
                   resumed, direct[SAVE_STEP + 1:], limit_loss)
        same_state("5e (b) resumed final parameters against the "
                   "uninterrupted run's", train.param_leaves(params), ref,
                   limit)
        ckpt.close()

        # (c) one more step traced, its region annotated.
        logdir = ENTRY_DIR / "trace"
        w = next(on_card(windows())).view(shape)
        reset_counts()
        with profiling.trace(str(logdir)):
            with profiling.annotate("train_step"):
                step(params, w[..., :-1], w[..., 1:])[0].item()
        launches += check_b10("5e (c) traced step", read_counts(),
                              cfg.head_dim, per_step)
        files = [f for f in logdir.rglob("*") if f.is_file()]
        names = {ev.get("name") for f in files
                 for ev in json.loads(f.read_text()).get("traceEvents", [])}
        print(f"5e (c) trace: {len(files)} file(s) under its logdir, "
              f"{sum(f.stat().st_size for f in files)} bytes, "
              f"'train_step' {'found' if 'train_step' in names else 'absent'}"
              f" among {len(names)} event names", flush=True)
        if not files or "train_step" not in names:
            fail("5e (c): the trace holds no 'train_step' annotation")
        del params, opt, step
    finally:
        shutil.rmtree(ENTRY_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def phase_train_entry(card_str, gpt2_run, moe_run, llama_run) -> dict:
    """Phase 5e: the training entry point (data, checkpoint, profiling,
    and the pipeline options remat, n_virtual and 1F1B) at full width,
    held to phases 5b-5d's GPipe kernel runs. Returns B10's launches."""
    from mpi_acx_torch.models import moe_transformer as mtf
    from mpi_acx_torch.models import transformer as tfm
    t_start = time.perf_counter()
    b10 = entry_data_checkpoint(card_str)

    # (d) each option on GPT-2 124M, from 5b's init and batch.
    cfg = tfm.gpt2_small()
    for name, options in SCHEDULES.items():
        b10 += option_run(f"5e (d) GPT-2 124M {name}", cfg,
                          gpt2_init(options.get("n_virtual", 1)),
                          gpt2_run["losses"], card_str,
                          **options)["counts"]["flash_attention_lse"]

    # (e) the peak against the microbatch count.
    peaks = {}
    for m in FLAT_M:
        for schedule in ("gpipe", "1f1b"):
            run = option_run(f"5e (e) GPT-2 124M {schedule} M={m}", cfg,
                             gpt2_init(), None, card_str, m=m, steps=2,
                             schedule=schedule)
            b10 += run["counts"]["flash_attention_lse"]
            peaks[schedule, m] = run["peak"]
    lo, hi = FLAT_M
    print("5e (e) peak memory, GPT-2 124M: " + "; ".join(
        f"{s} M={m} {peaks[s, m] / 2 ** 30:.2f} GiB" for m in FLAT_M
        for s in ("gpipe", "1f1b")) + f" [{card_str}]", flush=True)
    if peaks["1f1b", hi] > (1 + FLAT_TOL) * peaks["1f1b", lo]:
        fail(f"5e (e): 1F1B's peak grew from M={lo} to M={hi} by more than "
             f"{FLAT_TOL:.0%}")
    if not peaks["1f1b", hi] < peaks["gpipe", hi]:
        fail(f"5e (e): 1F1B's peak at M={hi} is not below GPipe's")

    # (f) Llama-3-8B at full width, 4 layers, at 5d's lr.
    cfg = llama_train_config()
    b128 = 0
    for name, options in (("remat", dict(remat=True)),
                          ("1f1b", dict(schedule="1f1b"))):
        run = option_run(f"5e (f) Llama-3-8B (4 layers) {name}", cfg,
                         llama_init(cfg), llama_run["losses"], card_str,
                         lr=LLAMA_TRAIN_LR, **options)
        b128 += run["counts"]["flash_attention_lse_d128"]
        print(f"5e (f) Llama-3-8B (4 layers) {name}: peak "
              f"{run['peak'] / 2 ** 30:.2f} GiB against 5d's GPipe "
              f"{llama_run['peak'] / 2 ** 30:.2f} GiB [{card_str}]",
              flush=True)

    # (g) MoE under 1F1B (the router-aux seeds), at 5c's capacity factor.
    cfg = mtf.MoeTransformerConfig()
    b10 += option_run("5e (g) MoE 1f1b", cfg, moe_init(cfg),
                      moe_run["losses"], card_str,
                      schedule="1f1b")["counts"]["flash_attention_lse"]
    print(f"5e: {time.perf_counter() - t_start:.1f} s", flush=True)
    return {"flash_attention_lse": b10, "flash_attention_lse_d128": b128}


def phase_long_context() -> dict:
    """B7's path: the port's flash_attention at S = Sk = 16384 (causal,
    bf16, B=1) at each of TRAIN_HEADS, where streaming=None takes the
    streaming entry, as a user's long-context call would, forward and
    backward. Returns the streaming entry's launches in that run, per
    head dim."""
    from mpi_acx_torch.ops.attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    for heads, head_dim in TRAIN_HEADS:
        name, _ = stream_form(head_dim)
        shape = (1, STREAM_S, heads, head_dim)
        xs = [randn(shape, torch.bfloat16, gen).requires_grad_()
              for _ in range(3)]
        do = randn(shape, torch.bfloat16, gen)
        reset_counts()
        flash_attention(*xs).backward(do)
        torch.cuda.synchronize()
        counts = read_counts()
        print(f"long-context attention S={STREAM_S} H={heads} D={head_dim}: "
              f"launches {counts}", flush=True)
        check_no_copies(f"long-context attention D={head_dim}")
        if counts[name] != 1 or sum(counts.values()) != 1:
            fail(f"the long-context call at D={head_dim} did not go through "
                 f"the streaming entry alone")
        if not all(torch.isfinite(x.grad.float()).all() for x in xs):
            fail(f"long-context backward at D={head_dim}: non-finite "
                 f"gradients")
        out[name] = counts[name]
        del xs, do
    return out


def headwise(fn, heads):
    """``fn`` over head groups of at most ``heads`` heads, concatenated:
    the plain version of B7 at S = 16384 materializes f32 logits of 1.07
    GB a head, so it runs as many heads a call as fit the card."""
    def run(q, k, v):
        return torch.cat([fn(q[:, :, h:h + heads], k[:, :, h:h + heads],
                             v[:, :, h:h + heads])
                          for h in range(0, q.shape[2], heads)], dim=2)
    return run


def phase_train_timing(card_str) -> dict:
    """B10 and B7 at each of TRAIN_HEADS timed by CUDA-graph replay at their
    path's shapes, beside their plain versions, the one-call PyTorch
    equivalent (B10: the SDPA flash kernel, which returns the logsumexp as
    well; B7: SDPA) and the roofline bound; and one blockwise backward of
    the attention at the training shape."""
    import torch.nn.functional as F
    from mpi_acx_torch.ops.attention import _flash_bwd_blockwise, \
        _reference_lse, attention_reference, block_rows, flash_attention, \
        flash_attention_lse
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf = torch.bfloat16
    lib = getattr(torch.ops.aten, "_scaled_dot_product_flash_attention",
                  None)
    out = {}
    for heads, head_dim in TRAIN_HEADS:
        cases = (
            (lse_form(head_dim)[0], TRAIN_B, TRAIN_S,
             lambda q, k, v: flash_attention_lse(q, k, v),
             lambda q, k, v: _reference_lse(q, k, v), 100, heads * 4),
            (stream_form(head_dim)[0], 1, STREAM_S,
             lambda q, k, v: flash_attention(q, k, v),
             headwise(attention_reference, H), 5, 0))
        for name, B, S, kern, plain, plain_iters, lse_bytes in cases:
            q, k, v = (randn((B, S, heads, head_dim), bf, gen)
                       for _ in range(3))
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            t_k = time_ms(lambda: kern(q, k, v), iters=20 if B == 1 else 100)
            t_p = time_ms(lambda: plain(q, k, v), iters=plain_iters)
            if B == 1:
                t_l = time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True), iters=20)
                lib_name = "sdpa, causal"
            elif lib is not None:
                t_l = time_ms(lambda: lib(qt, kt, vt, 0.0, True), iters=100)
                lib_name = "aten._scaled_dot_product_flash_attention, causal"
            else:
                t_l, lib_name = None, "- (this torch has no flash SDPA op)"
            flops = 4 * B * heads * head_dim * S * (S + 1) / 2
            nbytes = 4 * B * S * heads * head_dim * 2 + B * S * lse_bytes
            b_ms, b_by = bound_ms(flops, nbytes, bf)
            print(f"time {name} bf16 B={B} S={S} H={heads} D={head_dim} "
                  f"causal, {block_rows(B, S, heads, sm_count())}-row CTAs: "
                  f"kernel {t_k:.4f} ms "
                  f"({flops / t_k / 1e9:.1f} TFLOP/s), plain {t_p:.4f} ms, "
                  f"library ({lib_name}) "
                  + ("-" if t_l is None else f"{t_l:.4f} ms")
                  + f", bound {b_ms:.5f} ms ({b_by}: {nbytes / 1e6:.2f} MB, "
                  f"{flops / 1e9:.2f} GFLOP) [{card_str}]", flush=True)
            out[name] = dict(ms=t_k, plain_ms=t_p, library_ms=t_l,
                             bound_ms=b_ms, bound_by=b_by)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
        q, k, v, o, do = (randn((TRAIN_B, heads, TRAIN_S, head_dim), bf, gen)
                          for _ in range(5))
        lse = randn((TRAIN_B, heads, TRAIN_S), torch.float32, gen)
        dlse = randn((TRAIN_B, heads, TRAIN_S), torch.float32, gen)
        t_b = time_ms(lambda: _flash_bwd_blockwise(
            q, k, v, o, do, True, 512, 512, lse=lse, dlse=dlse), iters=20)
        print(f"time attention backward (blockwise, eager PyTorch) per "
              f"layer, bf16 B={TRAIN_B} S={TRAIN_S} H={heads} D={head_dim} "
              f"causal, blocks 512: {t_b:.4f} ms [{card_str}]", flush=True)
    return out


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
    each producer compiled into its kernel and with a general one (tanh(t)
    * 3: PyTorch on the stream, then B1). Returns the max abs error and
    the number of cases per kernel."""
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
        # A producer the fused kernel does not hold: the caller's own
        # PyTorch code on the stream, then B1's flag store behind it.
        b1 = fl.pready.launches
        for idx in (5, cuda_i32(15), 16, -1):
            desc = f"x {shape} idx={idx}, produce tanh(t) * 3"
            pk, fk = kern["produce_and_pready"](
                lambda t: torch.tanh(t) * 3.0, x, table.clone(), idx)
            pp, fp = plain["produce_and_pready"](
                lambda t: torch.tanh(t) * 3.0, x, table.clone(), idx)
            hold("produce_and_pready", [pk, fk], [pp, fp], desc)
        if fl.pready.launches != b1 + 4:
            fail(f"produce_and_pready with a general producer launched B1 "
                 f"{fl.pready.launches - b1} times for 4 calls")
    torch.cuda.synchronize()
    for name in FLAG_KERNELS:
        print(f"kernel {name}: {res[name]['cases']} cases equal to the plain "
              f"version exactly (max_abs_err {res[name]['abs']:.1f})",
              flush=True)
    return res


B1_REPEATS = 8          # B1 and its one-store library call, in turns


def b1_spread(k_fn, l_fn, card_str):
    """B1 and ``flags[idx] = PENDING`` (a one-store launch: the card's
    launch floor) timed in turns, kernel, library, library, kernel, ...,
    B1_REPEATS times each: the min, median and max of each and of the
    kernel-over-library ratio of each adjacent pair, so a gap can be told
    from the run's noise. Returns the two medians."""
    ks, ls = [], []
    for i in range(B1_REPEATS):
        pair = ((ks, k_fn), (ls, l_fn))
        for out, fn in (pair if i % 2 == 0 else pair[::-1]):
            out.append(time_ms(fn))
    ratio = sorted(k / lib for k, lib in zip(ks, ls))

    def spread(xs, fmt):
        xs = sorted(xs)
        return (f"min {xs[0]:{fmt}}, median {float(np.median(xs)):{fmt}}, "
                f"max {xs[-1]:{fmt}}")

    print(f"time pready over {B1_REPEATS} turns with flags[idx] = PENDING: "
          f"kernel {spread(ks, '.5f')} ms; library {spread(ls, '.5f')} ms; "
          f"kernel/library {spread(ratio, '.3f')} [{card_str}]", flush=True)
    return float(np.median(ks)), float(np.median(ls))


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
        if name == "pready":
            t_k, t_l = b1_spread(k_fn, l_fn, card_str)
        else:
            t_k = time_ms(k_fn)
            t_l = time_ms(l_fn) if l_fn is not None else None
        t_p = time_ms(p_fn)
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


def run_ranks(args, label, np_=2, env=None, timeout=RANK_TIMEOUT_S) -> str:
    """``build/acxrun -np np_`` on ``args`` with ``env`` added to the
    environment and ``timeout`` seconds; fails the run unless every rank
    exits 0. Returns their standard output."""
    import os
    cmd = [str(ROOT / "build" / "acxrun"), "-np", str(np_), "-timeout",
           str(timeout), *map(str, args)]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=timeout + 60,
                             env=dict(os.environ, **(env or {})))
    except subprocess.TimeoutExpired:
        fail(f"{label}: acxrun outlived its timeout")
    if res.returncode != 0:
        fail(f"{label}: exit {res.returncode}\n{res.stdout[-4000:]}\n"
             f"{res.stderr[-4000:]}")
    print(f"{label}: {np_} ranks exit 0 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return res.stdout


def field(out, tag, key) -> float:
    """The number after ``key=`` in the rank output's ``tag`` record (the
    ranks share one pipe, so a record may not start a line)."""
    m = re.search(rf"{tag}\b[^\n]*?\b{key}=([-\d.]+)", out)
    if m is None:
        fail(f"no {tag} {key}= in the ranks' output\n{out}")
    return float(m.group(1))


def worker_launches(out, names=None) -> dict:
    """The launch counts printed by each rank (LAUNCHES records, counted
    from 0 just before the rank's exchange or serve), summed over the
    ranks, of ``names`` (the flag kernels unless given)."""
    total = dict.fromkeys(FLAG_KERNELS if names is None else names, 0)
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
    build_host_plane()
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


# Phase 7b's fleet: requests of 32-512 prompt tokens through one decode rank
# (the worker's full-width load: 4 slots, chunk 8, max_len 1024).
FLEET_REQUESTS = 8
FLEET_PAGE_TOKENS = 64
FLEET_COUNTS = ("flash_attention", "flash_decode_attend",
                "flash_decode_attend_int8", "paged_flash_decode_attend",
                "paged_flash_decode_attend_int8")


def phase_disagg_fleet(card_str) -> dict:
    """Phase 7b (see the module docstring). Returns the attention kernels'
    launch counts of the three fleet serves, summed over their ranks."""
    total = {}
    for label, extra, decode_form in (
            ("fixed int8 slots", [], "flash_decode_attend_int8"),
            (f"{FLEET_PAGE_TOKENS}-token int8 pages",
             ["--page-tokens", FLEET_PAGE_TOKENS],
             "paged_flash_decode_attend_int8"),
            ("fixed int8 slots, ship after prefill", ["--no-overlap"],
             "flash_decode_attend_int8")):
        label = f"7b disagg fleet, GPT-2 124M, {label}"
        out = run_ranks([sys.executable, "tests/torch_disagg_worker.py",
                         "--device", "cuda", "--full-width", "--requests",
                         FLEET_REQUESTS, *extra], label,
                        env={"ACX_ROLE": "prefill,decode"})
        if "DISAGG_OK rank=1" not in out or "DISAGG_SHIPPED rank=0" not in out:
            fail(f"{label}: DISAGG_OK / DISAGG_SHIPPED missing\n{out}")
        counts = worker_launches(out, FLEET_COUNTS)
        print(f"{label}: launches over both ranks {json.dumps(counts)}",
              flush=True)
        if counts["flash_attention"] != FLEET_REQUESTS * 12:
            fail(f"{label}: K1 launched {counts['flash_attention']} times, "
                 f"want {FLEET_REQUESTS} handoffs x 12 layers")
        if counts[decode_form] == 0 or any(
                n for k, n in counts.items()
                if k not in ("flash_attention", decode_form)):
            fail(f"{label}: the decode rank's kernels: {counts} (only "
                 f"{decode_form} may decode)")
        add_counts(total, counts)
        for row in re.findall(r"DISAGG_ROW (\{[^}]*\})", out):
            r = json.loads(row)
            if r["role"] != "decode":
                print(f"{label}: prefill rank wall {r['wall_s']:.3f} s",
                      flush=True)
                continue
            print(f"{label}: decode rank (outputs equal to its monolithic "
                  f"int8 serve) {r['requests']} requests, {r['new_tokens']} "
                  f"tokens, {r['tokens_per_s']:.1f} tokens/s, TTFT p50 "
                  f"{r['ttft_p50_s'] * 1e3:.2f} ms (handoff prefill p50 "
                  f"{r['prefill_p50_s'] * 1e3:.2f} ms, pickup p50 "
                  f"{r['pickup_p50_s'] * 1e3:.3f} ms, exposed publish p50 "
                  f"{r['expose_p50_s'] * 1e3:.3f} ms), ITL p50 "
                  f"{r['itl_p50_s'] * 1e3:.3f} ms, "
                  f"{r['handoff_wire_bytes']} wire bytes; correctness-grade: "
                  f"two ranks share the card [{card_str}]", flush=True)
    return total


# --- phase 7c --------------------------------------------------------------

MULTI_DIR = ROOT / "build" / "smoke_multirank"    # 7c's files, removed after
MULTI_MESH = {"dp": 2, "pp": 2, "tp": 2}
# 7c's depth: GPT-2 124M's width cut to 4 of its 12 layers (2 a stage, one
# a chunk under n_virtual=2), so that the whole run stays near 750 s with
# phase 7d beside it.
MULTI_LAYERS = 4
MULTI_STEPS = 3         # the rank program's bf16 AdamW steps (SMOKE_STEPS)
# The wire of 7c's groups. Its eight ranks share the one card, and NCCL
# refuses two ranks on one device (probes/nccl_one_card.py), so the groups
# are gloo's: each collective copies its CUDA tensors to the host and back
# explicitly.
MULTI_BACKEND = "gloo"
# f32 step 0 of the 2x2x2 step against the one-rank step on the same
# weights and batch, TF32 off on both sides: the two differ only in
# reduction order (the tp halves of each FFN product summed by psum, the
# ring's logaddexp merge of two blocks, the gradients' psums). Each
# gradient leaf's largest difference over its largest magnitude, and the
# loss's relative difference. Readings on an H100: leaves
# 0.91-2.41e-6 (1F1B with n_virtual=2 against GPipe: at most 1.23e-6),
# the loss 8.7e-8 (1F1B: 0). Limits: about four times the largest leaf's
# reading, and about ten times the loss's (one f32 ulp of a loss of 11 is
# 1e-7 of it).
TOL_MULTI_F32 = 1e-5
TOL_MULTI_LOSS = 1e-6
# (d) bf16 AdamW, steps 1 and 2 of the 2x2x2 run against phase 5b's
# one-rank kernel run. Phase 5b's one-rank kernel and dense-block runs
# disagree there by at most 1.79e-3 (readings on an H100: 2.1e-5 at step
# 1, 1.79e-3 at step 2); the 2x2x2 run's own readings were 2.1e-4 and
# 4.2e-4. Limit: about twice 5b's reading. Step 0 keeps TOL_TRAIN_LOSS0.
TOL_MULTI_TRAIN_LOSS = 4e-3
# dp_quant_bits=8 against the exact step's gradients, per leaf: the JAX
# package's own bounds for its quantized sync (max error < 2.5% and mean
# < 0.6% of the leaf's max-norm).
TOL_QUANT_MAX, TOL_QUANT_MEAN = 0.025, 0.006


def b10_multirank(ti, n_layers=MULTI_LAYERS, n_micro=TRAIN_M, n_virtual=1,
                  schedule="gpipe", pp=2) -> int:
    """B10's launches in one step on a rank of tp index ``ti`` of the
    2x2x2 mesh, from the port's code: the ring calls B10 on the diagonal
    block and on the ti earlier ones (a later block is masked and
    skipped), for every layer a stage runs. GPipe runs every stage's
    n_layers / pp layers at each of its n_micro + pp - 1 ticks (the bubble
    ticks compute too); 1F1B runs a chunk of n_layers / (pp * n_virtual)
    layers at each forward op of its timetable and again at each backward
    op, which re-runs the chunk from its banked input."""
    if schedule != "1f1b":
        return (n_micro + pp - 1) * (n_layers // pp) * (ti + 1)
    from mpi_acx_torch.parallel.pipeline import _sched_1f1b_tables
    sc = _sched_1f1b_tables(pp, n_micro, n_virtual)
    ops = [int((sc.f_m[s] >= 0).sum() + (sc.b_m[s] >= 0).sum())
           for s in range(pp)]
    if len(set(ops)) != 1:
        fail(f"1F1B's timetable gives stages {ops} ops")
    return ops[0] * (n_layers // (pp * n_virtual)) * (ti + 1)


def layer_major(tree, n_virtual=1):
    """Gradient leaves with the layer leaves as [L, ...], from the
    stage-sliced [pp, L / pp, ...] or the interleaved [pp, v, L / (pp v),
    ...] (global stage j * pp + s at [s, j])."""
    out = {}
    for k, v in tree.items():
        if k != "layers":
            out[k] = v
            continue
        for name, a in v.items():
            if n_virtual > 1:
                a = a.transpose(0, 1)
            out[name] = a.reshape((-1,) + tuple(a.shape[
                (3 if n_virtual > 1 else 2):]))
    return out


def leaf_errors(got, want) -> dict:
    """Per leaf, the largest |got - want| over the largest |want|."""
    return {k: ((got[k].float() - w.float()).abs().max()
                / w.float().abs().max().clamp(min=1e-30)).item()
            for k, w in want.items()}


def multirank_config():
    """7c's configuration: GPT-2 124M at MULTI_LAYERS layers, bf16."""
    from mpi_acx_torch.models import transformer as tfm
    return dataclasses.replace(tfm.gpt2_small(), n_layers=MULTI_LAYERS)


def multirank_init():
    """7c's seed-0 f32 parameters drawn on the card, staged."""
    from mpi_acx_torch.models import transformer as tfm
    return staged(tfm.init_params(dataclasses.replace(
        multirank_config(), dtype=torch.float32), seed=0))


def multirank_reference():
    """Phase 7c's one-rank references on the 1x1x1 mesh: the f32 loss and
    gradients (on the host, layer-major) of the seed-0 weights on the ramp
    batch at step 0, and the losses of MULTI_STEPS bf16 AdamW steps (phase
    5b's kernel run at 7c's depth)."""
    from mpi_acx_torch import train
    cfg16 = multirank_config()
    cfg = dataclasses.replace(cfg16, dtype=torch.float32)
    grad_fn, _ = train.make_loss_and_grads(cfg, one_stage_mesh(), TRAIN_M)
    loss, grads = grad_fn(multirank_init(), *ramp_batch(cfg.vocab))
    grads = {k: g.cpu() for k, g in layer_major(grads).items()}
    del grad_fn
    torch.cuda.empty_cache()
    run = train_run(cfg16, multirank_init(), ramp_batch(cfg.vocab),
                    steps=MULTI_STEPS, final=False)
    torch.cuda.empty_cache()
    return loss.item(), grads, run["losses"]


def assembled(label, n_virtual):
    """The ranks' gradient shards of run ``label``, assembled (the
    reading copies, written by the dp = 0 ranks) into layer-major
    leaves."""
    from mpi_acx_torch import train
    from mpi_acx_torch.models import transformer as tfm
    shards = {r: torch.load(MULTI_DIR / f"{label}.rank{r}.pt")
              for r in range(4)}
    specs = train.step_specs(multirank_config(), n_virtual)
    return layer_major(train.unshard_params(shards, specs, MULTI_MESH),
                       n_virtual)


def phase_multirank(card_str) -> dict:
    """Phase 7c (see the module docstring). Returns B10's launches summed
    over the eight ranks."""
    import shutil
    ref_loss, ref, ref_losses = multirank_reference()
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    MULTI_DIR.mkdir(parents=True)
    label = (f"7c multi-rank train, GPT-2 124M at {MULTI_LAYERS} layers, "
             f"dp x pp x tp = 2 x 2 x 2")
    run_ranks([sys.executable, "tests/torch_rank_worker.py", "smoke",
               "--device", "cuda", "--backend", MULTI_BACKEND, "--layers",
               MULTI_LAYERS, "--out", MULTI_DIR], label, np_=8,
              env={"ACX_COORDINATOR": f"file://{MULTI_DIR / 'rdv'}"})
    recs = [r for rank in range(8) for r in torch.load(
        MULTI_DIR / f"smoke.rank{rank}.pt", weights_only=False)["records"]]
    runs = {}
    for r in recs:
        runs.setdefault(r["run"], {})[r["rank"]] = r
    grade = (f"correctness-grade: 8 ranks share one card and the "
             f"{MULTI_BACKEND} wire goes through the host; no speed claim "
             f"[{card_str}]")

    # (a) f32 step 0 against the one-rank step.
    f32 = runs["f32"]
    loss_err = max(abs(r["loss"] - ref_loss) / abs(ref_loss)
                   for r in f32.values())
    got = assembled("f32", 1)
    errs = leaf_errors(got, ref)
    worst = max(errs, key=errs.get)
    print(f"{label}, f32 step 0 vs the one-rank step: loss {ref_loss:.7f} "
          f"(largest relative difference over the ranks {loss_err:.3e}, "
          f"limit {TOL_MULTI_LOSS}); largest leaf error {errs[worst]:.3e} "
          f"({worst}; limit {TOL_MULTI_F32}); every leaf: " + ", ".join(
              f"{k} {v:.2e}" for k, v in errs.items()), flush=True)
    if loss_err > TOL_MULTI_LOSS or errs[worst] > TOL_MULTI_F32:
        fail(f"{label}: the f32 step differs from the one-rank step")
    # (b) 1F1B with n_virtual=2 against the GPipe run.
    errs = leaf_errors(assembled("f32_1f1b_v2", 2), got)
    worst = max(errs, key=errs.get)
    loss_err = max(abs(r["loss"] - f32[r["rank"]]["loss"])
                   / abs(ref_loss) for r in runs["f32_1f1b_v2"].values())
    print(f"{label}, 1f1b n_virtual=2 vs GPipe, f32 step 0: loss relative "
          f"difference {loss_err:.3e}, largest leaf error {errs[worst]:.3e} "
          f"({worst}; limits {TOL_MULTI_LOSS}, {TOL_MULTI_F32})", flush=True)
    if loss_err > TOL_MULTI_LOSS or errs[worst] > TOL_MULTI_F32:
        fail(f"{label}: 1F1B with n_virtual=2 differs from GPipe")
    # (c) dp_quant_bits=8: the loss is the exact run's (it is computed
    # before the sync), the gradients within the quantized sync's bounds.
    quant = runs["f32_quant"]
    qmax = max(r["quant_max"] for r in quant.values())
    qmean = max(r["quant_mean"] for r in quant.values())
    same = all(r["loss"] == f32[k]["loss"] for k, r in quant.items())
    print(f"{label}, dp_quant_bits=8 vs the exact sync, f32 step 0: loss "
          f"equal {same}; gradient error over each leaf's max-norm: largest "
          f"max {qmax:.3e} (limit {TOL_QUANT_MAX}), largest mean "
          f"{qmean:.3e} (limit {TOL_QUANT_MEAN})", flush=True)
    if not same or qmax > TOL_QUANT_MAX or qmean > TOL_QUANT_MEAN:
        fail(f"{label}: the quantized dp sync is out of its bounds")
    # (d) bf16 compute on f32 weights, AdamW: the losses of the one-rank
    # kernel run on the same init, batch and learning rate.
    bf16 = runs["bf16_adamw"]
    steps = len(bf16[0]["losses"])
    for r in bf16.values():
        if r["losses"] != bf16[0]["losses"]:
            fail(f"{label}: ranks disagree on the bf16 losses: {r}")
    hold_losses(f"{label}, bf16 AdamW vs the one-rank run",
                bf16[0]["losses"], ref_losses[:steps],
                later=TOL_MULTI_TRAIN_LOSS)
    # B10 launches, per rank and run, from the code.
    total = 0
    for run, kw, n_steps in (("f32", {}, 1),
                             ("f32_1f1b_v2", dict(schedule="1f1b",
                                                  n_virtual=2), 1),
                             ("f32_quant", {}, 1),
                             ("bf16_adamw", {}, steps)):
        for rank, r in sorted(runs[run].items()):
            got_b10 = sum(r["b10"]) if isinstance(r["b10"], list) \
                else r["b10"]
            want = n_steps * b10_multirank(r["coords"]["tp"], **kw)
            if got_b10 != want:
                fail(f"{label}, {run}: rank {rank} launched B10 {got_b10} "
                     f"times, the code gives {want}")
            total += got_b10
        print(f"{label}, {run}: B10 launches per rank "
              f"{[runs[run][k]['b10'] for k in sorted(runs[run])]} (as the "
              f"code gives: (ti + 1) blocks a layer)", flush=True)
    for run, rr in runs.items():
        for rank, r in sorted(rr.items()):
            ms = r["ms"] if isinstance(r["ms"], list) else [r["ms"]]
            print(f"{label}, {run}, rank {rank} {r['coords']}: step ms "
                  f"{', '.join(f'{x:.1f}' for x in ms)}, peak "
                  f"{r['peak'] / 2 ** 30:.2f} GiB, wire bytes a step "
                  f"{json.dumps(r['wire'])}, backend {r['backend']}; "
                  f"{grade}", flush=True)
    shutil.rmtree(MULTI_DIR, ignore_errors=True)
    return {"flash_attention_lse": total}


# --- phase 7d --------------------------------------------------------------

TP_DIR = ROOT / "build" / "smoke_tp"        # 7d's files, removed after
TP_TIMEOUT_S = 600
# Per-record numbers phase 7d prints (the rest are held, not printed).
TP_FIELDS = ("tokens_per_s", "wall_s", "steps", "prefills", "equal", "ties",
             "launches", "rounds", "accepted", "one_rank_rounds", "matched",
             "near_ties", "audited", "outside", "sharded", "routed", "loss",
             "ref_loss", "loss_err", "leaf_err", "step_s", "peak", "errors",
             "ms", "exchange_ms", "consumer_ms", "pipeline_ms",
             "exchange_gbps")
# Fields both ranks must hold equal, bit for bit.
TP_SAME = ("tokens", "rounds", "accepted", "ties", "equal", "audited",
           "outside", "sharded", "routed", "loss")


def phase_tp(card_str) -> dict:
    """Phase 7d (see the module docstring): phases 4-4d's one-rank tokens
    handed to two ranks of tests/torch_rank_worker.py ``tp --full-width``
    (tests/torch_tp_smoke.py), which check each sub-run and return its
    records; here the ranks are held to each other. Returns K1's and K2's
    launches summed over the ranks."""
    import shutil
    missing = {"gpt2_bf16", "gpt2_int8", "llama_bf16", "llama_int8",
               "moe_bf16"} - set(SERVED)
    if missing:
        fail(f"7d: the one-rank tokens of {sorted(missing)} were not kept")
    shutil.rmtree(TP_DIR, ignore_errors=True)
    TP_DIR.mkdir(parents=True)
    torch.save(SERVED, TP_DIR / "refs.pt")
    label = "7d serving and MoE across ranks, tp = 2"
    run_ranks([sys.executable, "tests/torch_rank_worker.py", "tp",
               "--full-width", "--device", "cuda", "--backend",
               MULTI_BACKEND, "--out", TP_DIR], label, np_=2,
              env={"ACX_COORDINATOR": f"file://{TP_DIR / 'rdv'}"},
              timeout=TP_TIMEOUT_S)
    runs = [torch.load(TP_DIR / f"tp.rank{r}.pt", weights_only=False)[
        "records"] for r in range(2)]
    if [r["run"] for r in runs[0]] != [r["run"] for r in runs[1]]:
        fail(f"{label}: the ranks ran different sub-runs")
    counts = {}
    for a, b in zip(*runs):
        for key in TP_SAME:
            if a.get(key) != b.get(key):
                fail(f"{a['run']}: the ranks disagree on {key}")
        for rec in (a, b):
            add_counts(counts, rec.get("launches", {}))
        print(f"{a['run']}: " + "; ".join(
            f"rank {rec['rank']} " + json.dumps(
                {k: rec[k] for k in TP_FIELDS if k in rec})
            for rec in (a, b)) + f"; {a['grade']} [{card_str}]", flush=True)
    shutil.rmtree(TP_DIR, ignore_errors=True)
    print(f"{label}: launches over both ranks {json.dumps(counts)}",
          flush=True)
    return counts


KERNELS = {
    "flash_attention": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:126"),
    "flash_decode_attend": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:80"),
    "flash_attention_d128": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:126"),
    "flash_decode_attend_d128": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:80"),
    "flash_decode_attend_int8_d128": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:80"),
    "flash_decode_attend_int8": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:80"),
    "paged_flash_decode_attend": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:235"),
    "paged_flash_decode_attend_int8": dict(
        source="mpi_acx_torch/csrc/flash_decode.cu",
        replaces="mpi_acx_tpu/ops/flash_decode.py:235"),
    "flash_attention_stream": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:269"),
    "flash_attention_lse": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:483"),
    "flash_attention_lse_d128": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:483"),
    "flash_attention_stream_d128": dict(
        source="mpi_acx_torch/csrc/flash_attention.cu",
        replaces="mpi_acx_tpu/ops/attention.py:269"),
    "mla_flash_attention": dict(
        source="mpi_acx_torch/ops/mla.py", route="triton",
        replaces="none: new for models/deepseek_v2.py"),
    "mla_decode_attend": dict(
        source="mpi_acx_torch/ops/mla.py", route="triton",
        replaces="none: new for models/deepseek_v2.py"),
    "routed_experts": dict(
        source="mpi_acx_torch/ops/moe_experts.py", route="triton",
        replaces="none: new for models/deepseek_v2.py"),
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


def add_counts(counts, more) -> None:
    """Add a path's launch counts to the kernels line's."""
    for name, n in more.items():
        counts[name] = counts.get(name, 0) + n


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
    phase_sass()
    errs = phase_kernels()
    errs.update(phase_train_kernels())

    from mpi_acx_torch.models import transformer as tfm
    t0 = time.perf_counter()
    params32 = tfm.init_params(dataclasses.replace(
        tfm.gpt2_small(), dtype=torch.float32), seed=0)
    print(f"params: GPT-2 124M, seed 0, {time.perf_counter() - t0:.1f} s",
          flush=True)
    phase_f32(params32)
    params16 = tfm.cast_params(params32, torch.bfloat16)
    del params32
    counts, fixed = phase_serve(params16, card_str)
    counts.update(phase_paged(params16, fixed, card_str))
    add_counts(counts, phase_gpt2_4e(params16, fixed, card_str))
    add_counts(counts, phase_disagg(params16, card_str))
    times = phase_timing(card_str)
    phase_cta_sizes(card_str)
    k2 = times["flash_decode_attend"]
    phase_step(params16, tfm.gpt2_small(), tfm, k2["ms"], k2["host_us"],
               card_str)
    del params16
    torch.cuda.empty_cache()

    llama_counts, llama_times = phase_llama(card_str)
    add_counts(counts, llama_counts)
    times.update(llama_times)
    add_counts(counts, phase_moe(card_str, k2["ms"]))
    c, e, t = phase_deepseek(card_str)
    add_counts(counts, c)
    errs.update(e)
    times.update(t)

    c, gpt2_run = phase_train(card_str)
    counts.update(c)
    c, moe_run = phase_moe_train(card_str)
    add_counts(counts, c)
    c, llama_run = phase_llama_train(card_str)
    counts.update(c)
    add_counts(counts, phase_train_entry(card_str, gpt2_run, moe_run,
                                         llama_run))
    counts.update(phase_long_context())
    times.update(phase_train_timing(card_str))
    torch.cuda.empty_cache()

    flag_errs = phase_flags()
    times.update(phase_flag_timing(card_str))
    counts.update(phase_exchange(card_str))
    add_counts(counts, phase_disagg_fleet(card_str))
    add_counts(counts, phase_multirank(card_str))
    add_counts(counts, phase_tp(card_str))

    line = []
    for name, meta in KERNELS.items():
        t = times[name]
        entry = {"name": name, "route": meta.get("route", "cuda"),
                 "source": meta["source"],
                 "replaces": meta["replaces"], "launches": counts[name]}
        if name in flag_errs:
            entry.update(max_abs_err=flag_errs[name]["abs"],
                         exact_cases=flag_errs[name]["cases"])
        for dtype, sfx in ((torch.bfloat16, ""), (torch.float32, "_f32")):
            e = errs.get((name, dtype))
            if e is not None:
                entry[f"max_abs_err{sfx}"] = e["abs"]
                entry[f"max_row_err{sfx}"] = e["row"]
                if "lse" in e:
                    entry[f"max_lse_err{sfx}"] = e["lse"]
        entry.update(ms=t["ms"], plain_ms=t["plain_ms"],
                     bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                     library_ms=t["library_ms"])
        entry.update({k: t[k] for k in ("full_cache_ms",
                                        "full_cache_bound_ms", "host_us",
                                        "window_ms", "window_plain_ms",
                                        "window_library_ms",
                                        "window_bound_ms")
                      if k in t})
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
