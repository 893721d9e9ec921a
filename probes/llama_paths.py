"""How far two plain computations of Llama-3-8B in bf16 lie apart, beside
how far the kernel path lies from the plain one: the noise floor against
which chip_smoke's Llama phase holds the kernel path.

Serves phase 4's 16 requests (8 slots, max_len 1024, chunk 8) with seed-0
bf16 weights through the kernels and through the plain versions, then per
request prints:

* plain decode vs plain forward: the plain server's tokens against the
  argmax of a forward pass of the plain path over the same sequence (the
  same function computed in another order), how many differ and the
  forward's largest margin against the served token;
* replay vs forward: the plain path's decode replayed for the request
  alone (its prompt prefilled, then one step a token) against the forward
  pass, largest |logit difference| over the generated positions;
* kernel forward vs plain forward: largest |logit difference| (the number
  chip_smoke's compare_paths holds to TIE);
* at the first position where the two servers' tokens differ, the plain
  margin between the two tokens by the forward pass and by the replay;
* both bf16 forwards against an f32 forward of the same weights (widened
  from bf16, f32 attention through the plain version): the RMS and the
  largest |logit error| of each.

Run from the repository root on a machine with one NVIDIA GPU:
``python3 probes/llama_paths.py [n_requests]``."""
import dataclasses
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())
import chip_smoke as cs  # noqa: E402
from mpi_acx_torch.models import llama, serving  # noqa: E402

n_req = int(sys.argv[1]) if len(sys.argv) > 1 else 16
torch.backends.cuda.matmul.allow_tf32 = False
cfg = llama.llama3_8b()
plain = dataclasses.replace(cfg, use_flash=False, decode_flash=False)
params = llama.init_params(cfg, seed=0, dtype=torch.bfloat16)
prompts, n_new = cs.serve_requests(cfg.vocab)
kw = dict(n_slots=8, max_len=1024, chunk=8, family=llama)
got = serving.serve_greedy(params, cfg, prompts, n_new, **kw)
want = serving.serve_greedy(params, plain, prompts, n_new, **kw)


def replay(seq, S):
    """The plain path's decode for one request: logits at positions
    S-1 .. len(seq)-2 (each predicting the next token)."""
    toks = torch.as_tensor(seq, device="cuda")[None]
    lg, cache = llama.prefill(params, plain, toks[:, :S], len(seq),
                              last_only=True)
    out = [lg[0, -1]]
    for j in range(S, len(seq) - 1):
        lg, cache = llama.decode_step(params, plain, cache, toks[:, j])
        out.append(lg[0])
    return torch.stack(out)


params32 = {k: (v.float() if not isinstance(v, dict) else
                {n: t.float() for n, t in v.items()})
            for k, v in params.items()}
cfg32 = dataclasses.replace(plain, dtype=torch.float32)
worst = dict(fwd_vs_decode=0.0, replay_vs_fwd=0.0, kernel_vs_plain=0.0)
sq = dict(kernel=0.0, plain=0.0)
mx = dict(kernel=0.0, plain=0.0)
n_logits = 0
n_diff_tokens = 0
with torch.no_grad():
    for rid in range(n_req):
        p, g, w = prompts[rid], got[rid], want[rid]
        S = len(p)
        seq = torch.as_tensor(w[:-1], device="cuda")[None]
        lp = llama.forward(params, plain, seq)[0, S - 1:]
        lk = llama.forward(params, cfg, seq)[0, S - 1:]
        served = torch.as_tensor(w[S:], device="cuda").long()
        fwd_tok = lp.argmax(-1)
        differ = int((fwd_tok != served).sum())
        gap = (lp.gather(-1, fwd_tok[:, None]) - lp.gather(
            -1, served[:, None])).max().item()
        l32 = llama.forward(params32, cfg32, seq)[0, S - 1:]
        for key, lx in (("kernel", lk), ("plain", lp)):
            d = (lx - l32).double()
            sq[key] += d.square().sum().item()
            mx[key] = max(mx[key], d.abs().max().item())
        n_logits += l32.numel()
        rp = replay(w, S)
        rvf = (rp - lp).abs().max().item()
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
            rm = (rp[i, int(w[t])] - rp[i, int(g[t])]).item()
            line += (f"; servers diverge at {t}: plain margin by forward "
                     f"{fm:.4f}, by replayed decode {rm:.4f}")
        print(line, flush=True)
print(f"worst over {n_req} requests: {worst}; served tokens where the plain "
      f"forward's argmax differs from the plain server's: {n_diff_tokens} "
      f"[{cs.card()}]", flush=True)
for key in ("kernel", "plain"):
    print(f"{key} path's bf16 forward against the f32 forward: RMS "
          f"{(sq[key] / n_logits) ** 0.5:.4e}, max |logit error| "
          f"{mx[key]:.4e} over {n_logits} logits [{cs.card()}]", flush=True)
