"""Phase 7d of chip_smoke.py: the full-width runs of tests/torch_rank_worker.py's
``tp``, ``ep``, ``ulysses`` and ``partitioned`` cases (``--full-width``),
two ranks sharing one card over gloo.

``tp --full-width`` runs every sub-run in one job, in order: (a) GPT-2
124M served tensor-parallel (bf16 and int8 KV) and sampled, (b)
Llama-3-8B at full width and depth served with bf16 and int8 KV, each
rank drawing only its slice, (c) the MoE transformer served with auto
and replicated expert dispatch, (d) TP speculative decoding, then (e)
EP training, (f) Ulysses attention and (g) the partitioned exchange,
which ``ep``, ``ulysses`` and ``partitioned`` with ``--full-width`` run
alone. The served runs are held to the one-rank tokens of phases 4, 4b,
4c and 4d (``refs.pt`` in the output directory, written by chip_smoke.py
before the ranks start); a divergence passes only at a tie, the margin
taken from this rank's own logits over the common prefix. The other runs
compute their one-rank references on the rank. Each rank checks its own
results (exiting non-zero through ``chip_smoke.fail``), prints one
``RANK_RUN {json}`` record a sub-run and returns them; chip_smoke.py
holds the ranks to each other.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from mpi_acx_torch.parallel import collective as col
from mpi_acx_torch.parallel.mesh import Mesh, PartitionSpec as P

GRADE = "correctness-grade: ranks share one card over gloo"
K1 = ("flash_attention", "flash_attention_d128")
K2 = ("flash_decode_attend", "flash_decode_attend_int8",
      "flash_decode_attend_d128", "flash_decode_attend_int8_d128")
EP_READ_LR = 1e4    # the SGD step's update carries the gradient in f32
EP_S = 1024


class Rank:
    """This rank's records and its checks against the other rank."""

    def __init__(self, rank, n, args):
        self.rank, self.n = rank, n
        self.dev = torch.device(args.device)
        self.out = Path(args.out)
        self.mesh = Mesh({"tp": n})
        self.card = cs.card()
        self.records = []

    def record(self, run, **kw):
        rec = dict(rank=self.rank, run=run, card=self.card, grade=GRADE, **kw)
        self.records.append(rec)
        print("RANK_RUN " + json.dumps(rec), flush=True)

    def same_everywhere(self, label, *tensors) -> str:
        """Fail unless every rank holds the same bytes: a digest of
        ``tensors`` gathered over the ranks."""
        h = hashlib.sha256()
        for t in tensors:
            h.update(np.ascontiguousarray(
                torch.as_tensor(t).cpu().numpy()).tobytes())
        mine = torch.tensor(list(h.digest()[:8]), dtype=torch.int64)
        with self.mesh:
            every = col.all_gather(mine, "tp")
        if not (every == mine).all():
            cs.fail(f"{label}: the ranks' results differ")
        return h.hexdigest()[:16]


def counted(fn):
    """``fn()`` with the attention kernels' launches counted from 0;
    returns (result, counts, seconds)."""
    torch.cuda.synchronize()
    cs.reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, cs.read_counts(K1 + K2), time.perf_counter() - t0


def context_logits(me, ops, params, cfg, ctx, S, int8):
    """This rank's next-token logits after ``ctx`` through the TP ops
    (prefill, decode): a prefill of ``ctx``, or with ``int8`` the served
    path's int8 cache (the prompt's ``S`` tokens prefilled, then one
    decode step per generated token)."""
    prefill, decode = ops
    toks = torch.as_tensor(np.asarray(ctx), device=me.dev)[None]
    with me.mesh, torch.no_grad():
        if not int8:
            return prefill(params, cfg, toks, len(ctx), last_only=True)[0][0, -1]
        logits, cache = prefill(params, cfg, toks[:, :S], len(ctx),
                                last_only=True)
        logits = logits[0, -1]
        for j in range(S, len(ctx)):
            logits, cache = decode(params, cfg, cache, toks[:, j])
            logits = logits[0]
    return logits


def hold_served(me, label, ops, params, cfg, res, want, prompts, n_new,
                tie, int8):
    """The served outputs ``res`` equal to the one-rank ``want`` but at
    ties: at a request's first divergence this rank's logits over the
    common prefix put the two tokens within ``tie``. Returns the ties as
    (request, position, margin)."""
    cs.check_served(label, res, prompts, n_new, cfg.vocab)
    me.same_everywhere(label, *res)
    ties = []
    for rid, (g, w) in enumerate(zip(res, want)):
        if np.array_equal(g, w):
            continue
        t = int(np.argmax(g != w))
        if t < len(prompts[rid]):
            cs.fail(f"{label} request {rid}: the prompt differs from the "
                    f"one-rank run's")
        lg = context_logits(me, ops, params, cfg, w[:t], len(prompts[rid]),
                            int8)
        margin = (lg[int(w[t])] - lg[int(g[t])]).item()
        if not abs(margin) < tie:
            cs.fail(f"{label} request {rid}: diverges from the one-rank "
                    f"tokens at position {t} at a logit margin {margin:.4e}, "
                    f"not a tie (< {tie})")
        ties.append((rid, t, margin))
    return ties


def serve_run(me, label, params, cfg, family, fam_name, want, tie, k1_per,
              int8=False, around=contextlib.nullcontext, **fns_kw):
    """One TP serve of phase 4's requests (8 slots, max_len 1024, chunk
    8), held to ``want``; K1 exactly prefills x layers. ``around()`` is
    entered for the measured serve alone."""
    from mpi_acx_torch.models import serving
    from mpi_acx_torch.parallel import tp_inference as tpi
    prompts, n_new = cs.serve_requests(cfg.vocab)
    kw = dict(n_slots=8, max_len=1024, chunk=8, family=family,
              kv_int8=int8, device=me.dev)
    fns = tpi.make_tp_server_fns(params, cfg, me.mesh, chunk=8,
                                 family=fam_name, kv_int8=int8,
                                 device=me.dev, **fns_kw)
    serving.serve_greedy(params, cfg, prompts[:2], 4, server_fns=fns, **kw)
    with around():
        res, counts, secs = counted(lambda: serving.serve_greedy(
            params, cfg, prompts, n_new, server_fns=fns, **kw))
    cs.check_no_copies(label)
    k1 = counts[k1_per[0]]
    if k1 != res.metrics.prefills * k1_per[1]:
        cs.fail(f"{label}: K1 launched {k1} times, the {res.metrics.prefills}"
                f" prefills x {k1_per[1]} layers are "
                f"{res.metrics.prefills * k1_per[1]}")
    if sum(counts[k] for k in K2) == 0:
        cs.fail(f"{label}: K2 never launched")
    if fam_name == "llama":
        tp_ops = tpi._llama_tp_family_ops(cfg, me.n, "tp", kv_int8=int8)
    else:
        tp_ops = tpi._tp_family_ops(
            cfg, me.n, "tp", kv_int8=int8,
            ffn=tpi._make_moe_ffn(cfg, me.n, "tp", fns_kw.get(
                "ep_dispatch", "auto")) if fam_name == "moe" else None)
    ties = hold_served(me, label, (tp_ops[0], tp_ops[2]),
                       tp_sliced(me, params, cfg, fam_name), cfg, res, want,
                       prompts, n_new, tie, int8)
    m = res.metrics
    me.record(label, tokens_per_s=m.tokens_per_s, new_tokens=m.new_tokens,
              wall_s=m.wall_s, steps=m.steps, prefills=m.prefills,
              launches=counts, ties=ties, equal=len(want) - len(ties))
    return res


def tp_sliced(me, params, cfg, fam_name):
    from mpi_acx_torch.parallel import tp_inference as tpi
    if fam_name == "llama":
        return tpi._llama_rank_params(cfg, me.mesh, "tp", me.dev)(params)
    specs = tpi.tp_param_specs_moe() if fam_name == "moe" else \
        tpi.tp_param_specs()
    scales = tpi._moe_scale_specs("tp") if fam_name == "moe" else \
        tpi._gpt2_scale_specs("tp")
    return tpi._gpt2_rank_params(cfg, me.mesh, "tp", specs,
                                 tpi.tp_shard_params, scales, "7d",
                                 me.dev)(params)


def gpt2_params(dev, n_layers=None, seed=0):
    from mpi_acx_torch.models import transformer as tfm
    cfg = tfm.gpt2_small()
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    p = tfm.init_params(dataclasses.replace(cfg, dtype=torch.float32),
                        seed=seed, device=dev)
    return cfg, tfm.cast_params(p, torch.bfloat16)


def run_gpt2(me, refs):
    """(a) GPT-2 124M, bf16, tp = n: served with bf16 and int8 KV, held to
    phases 4 and 4b; make_tp_generate sampled twice with one seed, every
    token inside its step's top-k set."""
    from mpi_acx_torch.models import transformer as tfm
    from mpi_acx_torch.parallel import tp_inference as tpi
    cfg, params = gpt2_params(me.dev)
    tie = cs.TIE[torch.bfloat16]
    for int8, key in ((False, "gpt2_bf16"), (True, "gpt2_int8")):
        kind = "int8" if int8 else "bf16"
        serve_run(me, f"7d (a) GPT-2 124M TP serve, {kind} KV", params, cfg,
                  tfm, "gpt2", refs[key], tie,
                  ("flash_attention", cfg.n_layers), int8=int8)
    prompt = cs.spec_prompts(cfg.vocab)
    gen = tpi.make_tp_generate(cfg, me.mesh, cs.SPEC_NEW, device=me.dev,
                               **cs.SAMPLE)
    sample = tpi.sample_logits
    outside = [0, 0]

    def audited(logits, g, temperature, top_k, top_p):
        tok = sample(logits, g, temperature, top_k, top_p)
        idx = logits.topk(top_k, dim=-1).indices
        outside[0] += int((idx != tok[:, None]).all(-1).sum())
        outside[1] += tok.numel()
        return tok

    tpi.sample_logits = audited
    try:
        (a, counts, secs) = counted(lambda: gen(params, prompt, cs.SAMPLE_KEY))
        b = gen(params, prompt, cs.SAMPLE_KEY)
    finally:
        tpi.sample_logits = sample
    label = "7d (a) GPT-2 124M TP make_tp_generate, sampled"
    if not torch.equal(a, b):
        cs.fail(f"{label}: two calls with one seed differ")
    if outside[0] or not torch.equal(a[:, :cs.SPEC_S], prompt):
        cs.fail(f"{label}: {outside[0]} of {outside[1]} tokens outside their "
                f"step's top-{cs.SAMPLE['top_k']}, or the prompt changed")
    me.same_everywhere(label, a)
    me.record(label, tokens_per_s=a.shape[0] * cs.SPEC_NEW / secs,
              launches=counts, audited=outside[1], outside=outside[0],
              sample=cs.SAMPLE, tokens=a.cpu().tolist())
    return params


def llama_slice(me, cfg, seed=0):
    """This rank's slice of Llama's seed-0 bf16 weights, drawn leaf by leaf
    on the card with ``llama.init_params``'s generator and order; each
    leaf is laid out, cut and freed before the next is drawn."""
    from mpi_acx_torch import train
    from mpi_acx_torch.parallel import tp_inference as tpi
    g = torch.Generator(device=me.dev).manual_seed(seed)
    L, d, ff = cfg.n_layers, cfg.d_model, cfg.d_ff
    dh, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    s, bf = 0.02, torch.bfloat16
    out_scale = s / math.sqrt(2 * L)
    specs = tpi.tp_param_specs_llama()["layers"]

    def nrm(*shape, scale=s):
        return torch.randn(shape, generator=g, device=me.dev,
                           dtype=bf).mul_(scale)

    def cut(name, w, laid):
        return train._shard(w.reshape(laid), specs[name], me.mesh)

    def ones(*shape):
        return torch.ones(shape, device=me.dev, dtype=bf)

    embed = nrm(cfg.vocab, d)
    layers = {"attn_norm": ones(L, d)}
    layers["wq"] = cut("wq", nrm(L, d, hq * dh), (L, d, hq, dh))
    layers["wk"] = cut("wk", nrm(L, d, hkv * dh), (L, d, hkv, dh))
    layers["wv"] = cut("wv", nrm(L, d, hkv * dh), (L, d, hkv, dh))
    layers["wo"] = cut("wo", nrm(L, hq * dh, d, scale=out_scale),
                       (L, hq, dh, d))
    layers["mlp_norm"] = ones(L, d)
    for name in ("w_gate", "w_up"):
        layers[name] = cut(name, nrm(L, d, ff), (L, d, ff))
    layers["w_down"] = cut("w_down", nrm(L, ff, d, scale=out_scale),
                           (L, ff, d))
    params = {"embed": embed, "layers": layers, "final_norm": ones(d),
              "unembed": nrm(cfg.vocab, d)}
    torch.cuda.empty_cache()
    return params


def run_llama(me, refs):
    """(b) Llama-3-8B at full width and depth, bf16, tp = n: each rank
    holds its KV-group slice; served with bf16 and int8 KV, held to phase
    4c."""
    from mpi_acx_torch.models import llama
    cfg = llama.llama3_8b()
    t0 = time.perf_counter()
    params = llama_slice(me, cfg)
    torch.cuda.synchronize()
    n_bytes = sum(t.numel() * t.element_size() for t in
                  [params["embed"], params["unembed"], params["final_norm"],
                   *params["layers"].values()])
    print(f"7d (b) rank {me.rank}: Llama-3-8B slice {n_bytes / 1e9:.2f} GB "
          f"drawn in {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    for int8, key in ((False, "llama_bf16"), (True, "llama_int8")):
        kind = "int8" if int8 else "bf16"
        serve_run(me, f"7d (b) Llama-3-8B TP serve, {kind} KV", params, cfg,
                  llama, "llama", refs[key],
                  cs.TIE_LLAMA, ("flash_attention_d128", cfg.n_layers),
                  int8=int8)
    del params
    torch.cuda.empty_cache()


def run_moe(me, refs):
    """(c) The MoE transformer (default configuration, capacity factor
    8.0), bf16, tp = n, with auto and replicated expert dispatch, held to
    phase 4d; the routed calls each mode dispatched sharded."""
    from mpi_acx_torch.models import moe_transformer as mtf
    from mpi_acx_torch.models import transformer as tfm
    cfg = cs.moe_serving_config()
    params = tfm.cast_params(mtf.init_params(cfg, seed=0, device=me.dev),
                             torch.bfloat16)
    torch.cuda.empty_cache()
    ffn = mtf._moe_ffn
    for mode in ("auto", "replicated"):
        calls = {"sharded": 0, "routed": 0}

        def counting(*a, **kw):
            calls["routed"] += 1
            calls["sharded"] += bool(kw.get("sharded_dispatch"))
            return ffn(*a, **kw)

        @contextlib.contextmanager
        def around():
            mtf._moe_ffn = counting
            try:
                yield
            finally:
                mtf._moe_ffn = ffn

        serve_run(me, f"7d (c) MoE TP serve, {mode} dispatch", params, cfg,
                  mtf, "moe", refs["moe_bf16"], cs.TIE_MOE,
                  ("flash_attention", cfg.n_layers), around=around,
                  ep_dispatch=mode)
        me.record(f"7d (c) MoE {mode} dispatch: routed calls", **calls)
        if mode == "replicated" and calls["sharded"]:
            cs.fail("7d (c): replicated dispatch routed a call sharded")
        if mode == "auto" and not calls["sharded"]:
            cs.fail("7d (c): auto dispatch never routed sharded")
    del params
    torch.cuda.empty_cache()


def run_speculative(me, params):
    """(d) TP speculative decoding: GPT-2 124M bf16 target, a 1-layer
    draft (seed 7), k = 4, 4 rows of 128 tokens, 64 new, greedy; held to
    one-rank speculative_generate up to the first near tie; K1 exactly 12
    + 1 and K2 exactly rounds x (12 + 4) launches."""
    from mpi_acx_torch.models import transformer as tfm
    from mpi_acx_torch.models.speculative import speculative_generate
    from mpi_acx_torch.parallel import tp_inference as tpi
    cfg = tfm.gpt2_small()
    dcfg, dparams = gpt2_params(me.dev, n_layers=1, seed=7)
    prompt = cs.spec_prompts(cfg.vocab)
    S, k = cs.SPEC_S, cs.SPEC_K
    want, wst = speculative_generate(dparams, dcfg, params, cfg, prompt,
                                     cs.SPEC_NEW, k=k, device=me.dev)
    ties = cs.first_near_ties(tfm, params, cfg, want, S, cs.TIE[
        torch.bfloat16])
    gen = tpi.make_tp_speculative_generate(dcfg, cfg, me.mesh, cs.SPEC_NEW,
                                           k=k, device=me.dev)
    gen(dparams, params, prompt[:, :64])      # warm-up at these shapes
    (got, st), counts, secs = counted(lambda: gen(dparams, params, prompt))
    label = "7d (d) TP speculative decoding, GPT-2 124M"
    cs.check_no_copies(label)
    matched = cs.hold_to_greedy(label, got, want, ties, S)
    R = int(st["rounds"].max())
    want_k1 = cfg.n_layers + dcfg.n_layers
    want_k2 = R * (cfg.n_layers + k * dcfg.n_layers)
    if counts["flash_attention"] != want_k1 or \
            counts["flash_decode_attend"] != want_k2:
        cs.fail(f"{label}: launches {counts}, expected K1 {want_k1} and K2 "
                f"{want_k2} ({R} rounds)")
    me.same_everywhere(label, got, st["rounds"], st["drafted_accepted"])
    me.record(label, tokens_per_s=prompt.shape[0] * cs.SPEC_NEW / secs,
              launches=counts, rounds=st["rounds"].tolist(),
              accepted=st["drafted_accepted"].tolist(),
              one_rank_rounds=wst["rounds"].tolist(), matched=matched,
              near_ties=ties)


def leaf_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1e-30)).item()


def run_ep(rank, n, args, me=None):
    """(e) EP training: make_moe_transformer_train_step on dp = n (EP over
    the same axis), the MoE default configuration in f32 at capacity
    factor 8.0, one SGD step on n x 1024 ramp tokens (one sequence a
    rank), held to the one-rank step on the whole batch; then
    make_moe_train_step at d_model 768, d_ff 3072, 8 experts the same
    way. The gradients are read from the update of a step at a large
    learning rate, relative to each leaf's largest one-rank value. The
    load-balance loss is left out (``aux_weight=0``): it is a product of
    means over each rank's dispatch group, so with it the EP step is
    another function than the one-rank step on the whole batch (the CPU
    tests hold it, at its default weight, to the JAX package's EP step);
    the cross-entropy, the squared error and the router z-loss are means
    and split exactly."""
    from mpi_acx_torch import train
    from mpi_acx_torch.models import moe, moe_transformer as mtf
    me = me or Rank(rank, n, args)
    one, dp = Mesh({"dp": 1}), Mesh({"dp": n})
    cfg = dataclasses.replace(cs.moe_serving_config(), dtype=torch.float32)
    tokens = (torch.arange(EP_S, device=me.dev)[None]
              + torch.arange(n, device=me.dev)[:, None]) % cfg.vocab
    targets = torch.roll(tokens, -1, dims=-1)
    specs = mtf.param_specs("dp")

    def grads_of(step, params, *batch):
        old = [p.clone() for p in train.param_leaves(params)]
        loss, new = step(params, *batch)
        return loss.item(), [(o - p) / EP_READ_LR for o, p in
                             zip(old, train.param_leaves(new))]

    params = mtf.init_params(cfg, seed=0, device=me.dev)
    ref_loss, ref = grads_of(mtf.make_moe_transformer_train_step(
        cfg, one, "dp", lr=EP_READ_LR, aux_weight=0.0, device=me.dev),
        params, tokens, targets)
    ref = train.param_leaves(train.shard_params(
        train._rebuild(params, iter(ref)), specs, dp))
    params = mtf.init_params(cfg, seed=0, device=me.dev)
    local = train.shard_params(params, specs, dp)
    del params
    torch.cuda.empty_cache()
    step = mtf.make_moe_transformer_train_step(cfg, dp, "dp", lr=EP_READ_LR,
                                               aux_weight=0.0, device=me.dev)
    r = dp.coords["dp"]
    t0 = time.perf_counter()
    loss, got = grads_of(step, local, tokens[r:r + 1], targets[r:r + 1])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    errs = [leaf_err(g, w) for g, w in zip(got, ref)]
    label = "7d (e) EP train step, MoE transformer f32"
    if loss_err > cs.TOL_MULTI_LOSS or max(errs) > cs.TOL_MULTI_F32:
        cs.fail(f"{label}: loss relative difference {loss_err:.3e}, largest "
                f"leaf error {max(errs):.3e} against the one-rank step")
    me.record(label, loss=loss, ref_loss=ref_loss, loss_err=loss_err,
              leaf_err=max(errs), step_s=secs, peak=
              torch.cuda.max_memory_allocated())
    del local, got, ref
    torch.cuda.empty_cache()
    # make_moe_train_step, top-1, drop-free.
    lcfg = moe.MoeConfig(d_model=768, d_ff=3072, n_experts=8,
                         capacity_factor=8.0, top_k=1)
    T = n * EP_S
    g = torch.Generator(device=me.dev).manual_seed(11)
    x = torch.randn((T, 768), generator=g, device=me.dev)
    tgt = torch.randn((T, 768), generator=g, device=me.dev)
    lspecs = {"gate": P(), "w1": P("ep"), "w2": P("ep")}
    ep1, epn = Mesh({"ep": 1}), Mesh({"ep": n})
    params = moe.init_moe_params(lcfg, seed=3, device=me.dev)
    ref_loss, ref = grads_of(moe.make_moe_train_step(lcfg, ep1, "ep",
                                                     lr=EP_READ_LR,
                                                     aux_weight=0.0,
                                                     device=me.dev),
                             {k: v.clone() for k, v in params.items()}, x,
                             tgt)
    ref = dict(zip(params, ref))
    local = train.shard_params(params, lspecs, epn)
    r, Tl = epn.coords["ep"], T // n
    loss, got = grads_of(moe.make_moe_train_step(lcfg, epn, "ep",
                                                 lr=EP_READ_LR,
                                                 aux_weight=0.0,
                                                 device=me.dev), local,
                         x[r * Tl:(r + 1) * Tl], tgt[r * Tl:(r + 1) * Tl])
    got = dict(zip(local, got))
    errs = {k: leaf_err(got[k], train._shard(ref[k], lspecs[k], epn))
            for k in got}
    loss_err = abs(loss - ref_loss) / abs(ref_loss)
    label = "7d (e) EP make_moe_train_step, d 768, d_ff 3072, 8 experts"
    if loss_err > cs.TOL_MULTI_LOSS or max(errs.values()) > cs.TOL_MULTI_F32:
        cs.fail(f"{label}: loss relative difference {loss_err:.3e}, leaf "
                f"errors {errs}")
    me.record(label, loss=loss, ref_loss=ref_loss, loss_err=loss_err,
              leaf_err=errs)
    torch.cuda.empty_cache()
    return {"records": me.records}


ULYSSES_S = 4096


def run_ulysses(rank, n, args, me=None):
    """(f) Ulysses: S_global = 4096 at GPT-2's heads (12, D 64) and
    Llama's (32, D 128), bf16 and f32, causal: each rank's block held to
    one-rank flash_attention over the whole sequence within phase 2's
    limits (and its row error); K1 once a call a rank, at H / n heads."""
    from mpi_acx_torch.ops.attention import attention_reference, \
        flash_attention
    from mpi_acx_torch.parallel import ulysses
    me = me or Rank(rank, n, args)
    sq = ULYSSES_S // n
    for heads, dh in ((12, 64), (32, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=me.dev).manual_seed(heads + dh)
            q, k, v = (cs.randn((1, ULYSSES_S, heads, dh), dtype, g)
                       for _ in range(3))
            ref = flash_attention(q, k, v, causal=True)[0]
            ref32 = attention_reference(q.float(), k.float(), v.float(),
                                        causal=True)[0]
            blk = slice(me.rank * sq, (me.rank + 1) * sq)
            qkv = [t[0, blk].contiguous() for t in (q, k, v)]
            out, counts, secs = counted(
                lambda: ulysses.ulysses_attention_sharded(*qkv, me.mesh,
                                                          "tp"))
            e = cs.errors(out, ref[blk], ref32[blk], head_dim=dh)
            name = "flash_attention" if dh == 64 else "flash_attention_d128"
            desc = (f"7d (f) Ulysses S={ULYSSES_S} H={heads} D={dh} over "
                    f"{n} ranks, rank {me.rank}'s block vs one-rank K1")
            cs.check(name, desc, dtype, e)
            if counts[name] != 1 or sum(counts.values()) != 1:
                cs.fail(f"{desc}: launches {counts}, not one K1 at "
                        f"{heads // n} heads")
            me.record(f"7d (f) Ulysses H={heads} D={dh} {str(dtype)[6:]}",
                      launches=counts, errors=e, ms=1e3 * secs)
            del q, k, v, ref, ref32
    torch.cuda.empty_cache()
    return {"records": me.records}


PARTS, PART_BYTES = 16, 64 << 20


def run_partitioned(rank, n, args, me=None):
    """(g) The partitioned exchange: 64 MiB of int32 in 16 partitions one
    ring step right, with and without a consumer, and the pipeline of 16
    partitions; all exact."""
    from mpi_acx_torch.parallel import partitioned as pt
    me = me or Rank(rank, n, args)
    N = PART_BYTES // 4
    left = (me.rank - 1) % n
    x = torch.arange(N, dtype=torch.int32, device=me.dev) + me.rank * 7
    with me.mesh:
        got, _, secs = counted(lambda: pt.partitioned_ring_exchange(
            x, "tp", PARTS))
        tripled, _, secs3 = counted(lambda: pt.partitioned_ring_exchange(
            x, "tp", PARTS, consume=lambda c: c * 3))
        acc, _, secs_p = counted(lambda: pt.partitioned_pipeline(
            lambda k: torch.full((N // PARTS,), me.rank * 100 + k,
                                 dtype=torch.int32, device=me.dev),
            lambda a, p: a + p,
            torch.zeros(N // PARTS, dtype=torch.int32, device=me.dev),
            PARTS, "tp"))
    want = torch.arange(N, dtype=torch.int32, device=me.dev) + left * 7
    want_acc = sum(left * 100 + k for k in range(PARTS))
    if not (torch.equal(got, want) and torch.equal(tripled, want * 3)
            and bool((acc == want_acc).all())):
        cs.fail("7d (g) the partitioned exchange is not exact")
    me.record("7d (g) partitioned exchange, 64 MiB int32, 16 partitions",
              exchange_ms=1e3 * secs, consumer_ms=1e3 * secs3,
              pipeline_ms=1e3 * secs_p,
              exchange_gbps=PART_BYTES / secs / 1e9)
    return {"records": me.records}


def run(rank, n, args):
    """Every sub-run of phase 7d, in one job."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    me = Rank(rank, n, args)
    refs = torch.load(me.out / "refs.pt", weights_only=False)
    params = run_gpt2(me, refs)
    run_speculative(me, params)
    del params
    torch.cuda.empty_cache()
    run_llama(me, refs)
    run_moe(me, refs)
    run_ep(rank, n, args, me)
    run_ulysses(rank, n, args, me)
    run_partitioned(rank, n, args, me)
    return {"records": me.records}
