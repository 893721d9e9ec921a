"""How far two plain computations of a model in bf16 lie apart, beside how
far the kernel path lies from the plain one: the noise floor against which
chip_smoke's phases 4c (Llama-3-8B, TIE_LLAMA) and 4d (the MoE family,
TIE_MOE) hold the kernel path.

Serves phase 4's 16 requests (8 slots, max_len 1024, chunk 8) with the
phase's seed-0 weights through the kernels and through the plain
versions, then per request prints:

* plain decode vs plain forward: the plain server's tokens against the
  argmax of a forward pass of the plain path over the same sequence (the
  same function computed in another order), how many differ and the
  forward's largest margin against the served token;
* replay vs forward: the plain path's decode replayed for the request
  alone (its prompt prefilled, then one step a token) against the forward
  pass, largest |logit difference| over the generated positions;
* kernel forward vs plain forward: largest |logit difference| (the number
  chip_smoke's compare_paths holds to the tie limit);
* at the first position where the two servers' tokens differ, the plain
  margin between the two tokens by the forward pass and by the replay;

and over all requests both bf16 forwards against an f32 forward of the
same weights (the phase's reference: Llama's bf16 weights widened, the
MoE family's f32 draw), and for the MoE family the routing decisions (a
token's expert in one layer) that differ between the replay and the
forward and between the kernel and plain forwards.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/bf16_paths.py llama|moe [n_requests]``."""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from mpi_acx_torch.models import (llama, moe_transformer,  # noqa: E402
                                  serving, transformer)

family = sys.argv[1]
n_req = int(sys.argv[2]) if len(sys.argv) > 2 else 16
torch.backends.cuda.matmul.allow_tf32 = False
if family == "llama":
    fam, cfg = llama, llama.llama3_8b()
    params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
    params32 = {k: (v.float() if not isinstance(v, dict) else
                    {n: t.float() for n, t in v.items()})
                for k, v in params.items()}
else:
    fam, cfg = moe_transformer, cs.moe_serving_config()
    params32 = moe_transformer.init_params(cfg, seed=0)
    params = transformer.cast_params(params32, torch.bfloat16)
routed = family == "moe"
plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
cfg32 = dataclasses.replace(plain, dtype=torch.float32)
prompts, n_new = cs.serve_requests(cfg.vocab)
kw = dict(n_slots=8, max_len=1024, chunk=8, family=fam)
got = serving.serve_greedy(params, cfg, prompts, n_new, **kw)
want = serving.serve_greedy(params, plain, prompts, n_new, **kw)


def replay(seq, S):
    """The plain path's decode for one request: logits at positions
    S-1 .. len(seq)-2 (each predicting the next token)."""
    toks = torch.as_tensor(seq, device="cuda")[None]
    lg, cache = fam.prefill(params, plain, toks[:, :S], len(seq),
                            last_only=True)
    out = [lg[0, -1]]
    for j in range(S, len(seq) - 1):
        lg, cache = fam.decode_step(params, plain, cache, toks[:, j])
        out.append(lg[0])
    return torch.stack(out)


def per_layer(log, S):
    """A replay's router calls (one a layer for the prefill, then one a
    layer a step) regrouped as a forward's: one [tokens, E] gate tensor a
    layer over positions S-1 .. ."""
    L = cfg.n_layers
    steps = [[g for g, _ in log[i:i + L]] for i in range(0, len(log), L)]
    return [(torch.cat([steps[0][i][-1:]] + [st[i] for st in steps[1:]]),
             cfg.top_k) for i in range(L)]


worst = dict(fwd_vs_decode=0.0, replay_vs_fwd=0.0, kernel_vs_plain=0.0)
flips = dict(replay=[0, 0, 0.0], kernel=[0, 0, 0.0])
sq = dict(kernel=0.0, plain=0.0)
mx = dict(kernel=0.0, plain=0.0)
n_logits = n_diff_tokens = 0
with torch.no_grad():
    for rid in range(n_req):
        p, g, w = prompts[rid], got[rid], want[rid]
        S = len(p)
        seq = torch.as_tensor(w[:-1], device="cuda")[None]
        with cs.recorded_routes() as rp:
            lp = cs.forward_logits(fam, params, plain, seq)[0, S - 1:]
        with cs.recorded_routes() as rk:
            lk = cs.forward_logits(fam, params, cfg, seq)[0, S - 1:]
        with cs.recorded_routes() as rr:
            rl = replay(w, S)
        if routed:
            tail = [(gt[S - 1:], k) for gt, k in rp]
            for key, f in (("replay", cs.route_flips(per_layer(rr, S), tail)),
                           ("kernel", cs.route_flips(rk, rp))):
                flips[key] = [flips[key][0] + f[0], flips[key][1] + f[1],
                              max(flips[key][2], f[2])]
        served = torch.as_tensor(w[S:], device="cuda").long()
        fwd_tok = lp.argmax(-1)
        differ = int((fwd_tok != served).sum())
        gap = (lp.gather(-1, fwd_tok[:, None]) - lp.gather(
            -1, served[:, None])).max().item()
        l32 = cs.forward_logits(fam, params32, cfg32, seq)[0, S - 1:]
        for key, lx in (("kernel", lk), ("plain", lp)):
            d = (lx - l32).double()
            sq[key] += d.square().sum().item()
            mx[key] = max(mx[key], d.abs().max().item())
        n_logits += l32.numel()
        rvf = (rl - lp).abs().max().item()
        kvp = (lk - lp).abs().max().item()
        worst["fwd_vs_decode"] = max(worst["fwd_vs_decode"], gap)
        worst["replay_vs_fwd"] = max(worst["replay_vs_fwd"], rvf)
        worst["kernel_vs_plain"] = max(worst["kernel_vs_plain"], kvp)
        n_diff_tokens += differ
        line = (f"request {rid} (prompt {S}, {len(w) - S} new): plain decode "
                f"vs plain forward: {differ} tokens differ, forward's "
                f"largest margin against the served token {gap:.4f}; replay "
                f"vs forward max |logit diff| {rvf:.4f}; kernel forward vs "
                f"plain forward {kvp:.4f}")
        if not np.array_equal(g, w):
            t = int(np.argmax(g != w))
            i = t - S
            fm = (lp[i, int(w[t])] - lp[i, int(g[t])]).item()
            rm = (rl[i, int(w[t])] - rl[i, int(g[t])]).item()
            line += (f"; servers diverge at {t}: plain margin by forward "
                     f"{fm:.4f}, by replayed decode {rm:.4f}")
        print(line, flush=True)
print(f"worst over {n_req} requests: {worst}; served tokens where the plain "
      f"forward's argmax differs from the plain server's: {n_diff_tokens} "
      f"[{cs.card()}]", flush=True)
if routed:
    for key, (a, n, m) in flips.items():
        print(f"routing decisions apart, {key} vs plain forward: {a} of {n}, "
              f"plain gate margin there up to {m:.4e}", flush=True)
for key in ("kernel", "plain"):
    print(f"{key} path's bf16 forward against the f32 forward: RMS "
          f"{(sq[key] / n_logits) ** 0.5:.4e}, max |logit error| "
          f"{mx[key]:.4e} over {n_logits} logits [{cs.card()}]", flush=True)
