"""Routed experts without dropped tokens (DeepSeekMoE, arXiv:2405.04434
section 2.2): the router's top-k, the grouping of (token, expert) pairs by
expert, and the expert products as grouped GEMM kernels, with their plain
versions.

The capacity layer of ``models/moe.py`` (the JAX package's) drops a token
past its expert's capacity and computes every expert in f32 through
one-hot einsums. Here every (token, expert) pair is computed once, in bf16
with f32 accumulation. No kernel of the JAX package computes this, so the
kernels replace none; they were added for ``models/deepseek_v2.py``.

Everything keeps static shapes, so a captured decode step holds it: the
pairs are counted per expert with a scatter-add, sorted by expert (a
stable sort), and each expert's rows start at the exclusive sum of the
counts, all on the device. Two Triton kernels then run over a grid of
(expert, output tile), each program reading its expert's count and
offset:

* ``_moe_experts_gate_up_kernel``: ``h = silu(x W_gate) * (x W_up)`` for
  the expert's rows, both products accumulated in f32 over the same loads
  of x, the SwiGLU fused, h stored in bf16 in expert order;
* ``_moe_experts_down_kernel``: ``y = (h W_down) * weight``, each row
  written in f32 to its pair's own row, so the k pairs of a token add in
  a fixed order.

A program whose expert has no pair reads nothing, and one whose rows fit
one block (every expert at a decode batch of up to ``BLOCK_M`` tokens)
reads its expert's weight tile once: a step reads each touched expert's
weights once. Bound: bytes at decode (the touched experts' weights),
operations at long prompts. Launches are counted in
``routed_experts.launches`` (one a call, both kernels).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

BLOCK_M = 64        # rows of one expert a program holds at a time
_KERNELS = {}


def _kernels():
    """The Triton kernels, built once a process at their first launch."""
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _moe_experts_gate_up_kernel(X, WG, WU, HB, TOK, CNT, OFF, sxt, swe,
                                    swk, D, I, BM: tl.constexpr,
                                    BN: tl.constexpr, BK: tl.constexpr):
        e = tl.program_id(0)
        pn = tl.program_id(1)
        cnt = tl.load(CNT + e)
        off = tl.load(OFF + e)
        cols = pn * BN + tl.arange(0, BN)
        cmask = cols < I
        kk = tl.arange(0, BK)
        mm = tl.arange(0, BM)
        wg = WG + e * swe + cols[None, :]
        wu = WU + e * swe + cols[None, :]
        for m0 in range(0, cnt, BM):
            rows = off + m0 + mm
            rmask = (m0 + mm) < cnt
            tok = tl.load(TOK + rows, mask=rmask, other=0)
            xp = X + tok[:, None] * sxt
            acc_g = tl.zeros([BM, BN], tl.float32)
            acc_u = tl.zeros([BM, BN], tl.float32)
            for k0 in range(0, D, BK):
                a = tl.load(xp + (k0 + kk)[None, :], mask=rmask[:, None],
                            other=0.0)
                bg = tl.load(wg + (k0 + kk)[:, None] * swk,
                             mask=cmask[None, :], other=0.0)
                bu = tl.load(wu + (k0 + kk)[:, None] * swk,
                             mask=cmask[None, :], other=0.0)
                acc_g = tl.dot(a, bg, acc_g)
                acc_u = tl.dot(a, bu, acc_u)
            h = acc_g * tl.sigmoid(acc_g) * acc_u
            tl.store(HB + rows[:, None] * I + cols[None, :],
                     h.to(HB.dtype.element_ty),
                     mask=rmask[:, None] & cmask[None, :])

    @triton.jit
    def _moe_experts_down_kernel(HB, WD, Y, WTS, DST, CNT, OFF, swe, swk, D,
                                 I, BM: tl.constexpr, BN: tl.constexpr,
                                 BK: tl.constexpr):
        e = tl.program_id(0)
        pn = tl.program_id(1)
        cnt = tl.load(CNT + e)
        off = tl.load(OFF + e)
        cols = pn * BN + tl.arange(0, BN)
        cmask = cols < D
        kk = tl.arange(0, BK)
        mm = tl.arange(0, BM)
        wd = WD + e * swe + cols[None, :]
        for m0 in range(0, cnt, BM):
            rows = off + m0 + mm
            rmask = (m0 + mm) < cnt
            acc = tl.zeros([BM, BN], tl.float32)
            for k0 in range(0, I, BK):
                kmask = (k0 + kk) < I
                a = tl.load(HB + rows[:, None] * I + (k0 + kk)[None, :],
                            mask=rmask[:, None] & kmask[None, :], other=0.0)
                b = tl.load(wd + (k0 + kk)[:, None] * swk,
                            mask=kmask[:, None] & cmask[None, :], other=0.0)
                acc = tl.dot(a, b, acc)
            w = tl.load(WTS + rows, mask=rmask, other=0.0)
            dst = tl.load(DST + rows, mask=rmask, other=0)
            tl.store(Y + dst[:, None] * D + cols[None, :], acc * w[:, None],
                     mask=rmask[:, None] & cmask[None, :])

    _KERNELS.update(gate_up=_moe_experts_gate_up_kernel,
                    down=_moe_experts_down_kernel)
    return _KERNELS


def route(h, w_router, top_k: int, scale: float = 1.0):
    """The router: ``h [T, d]`` against ``w_router [d, E]``, the product
    and the softmax in f32, then the ``top_k`` largest probabilities,
    ties to the lower expert (a stable descending sort), neither
    renormalised nor changed but for ``scale``. Returns ``(ids [T, k]
    int64, weights [T, k] f32)``."""
    probs = torch.softmax(h.float() @ w_router.float(), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return ids[:, :top_k], vals[:, :top_k] * scale


def expert_counts(ids, n_experts: int):
    """Pairs routed to each expert: ``[E]`` int32, by a scatter-add (a
    histogram whose size does not depend on the values, so a CUDA graph
    can hold it)."""
    flat = ids.reshape(-1)
    return torch.zeros(n_experts, dtype=torch.int32,
                       device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=torch.int32))


def routed_experts_reference(x, ids, weights, w_gate, w_up, w_down):
    """Plain version of :func:`routed_experts` (its arithmetic: the gate
    and up products of exact f32 operands, SwiGLU in f32, h rounded to x's
    dtype, the down product in f32 times the pair's weight), one expert
    at a time."""
    T, K = ids.shape
    y = torch.zeros(T, K, x.shape[1], dtype=torch.float32, device=x.device)
    for e in ids.unique().tolist():
        tok, slot = (ids == e).nonzero(as_tuple=True)
        xe = x[tok].float()
        g, u = xe @ w_gate[e].float(), xe @ w_up[e].float()
        h = (F.silu(g) * u).to(x.dtype).float()
        y[tok, slot] = (h @ w_down[e].float()) * weights[tok, slot][:, None]
    return y.sum(1)


def routed_experts(x, ids, weights, counts, w_gate, w_up, w_down):
    """Each token's routed experts, no pair dropped: ``x [T, d]``, ``ids``
    and ``weights [T, k]`` from :func:`route`, ``counts`` their
    :func:`expert_counts`, ``w_gate``/``w_up [E, d, I]``, ``w_down [E, I,
    d]`` -> ``y [T, d]`` f32, the sum over the token's k experts of
    ``weight * SwiGLU_e(x)``. On a CUDA tensor the two grouped kernels; on
    a CPU tensor :func:`routed_experts_reference`."""
    if x.device.type == "cpu":
        return routed_experts_reference(x, ids, weights, w_gate, w_up,
                                        w_down)
    T, d = x.shape
    K = ids.shape[1]
    E, _, I = w_gate.shape
    if x.dtype != torch.bfloat16 or not all(
            w.dtype == torch.bfloat16 and w.is_contiguous()
            for w in (w_gate, w_up, w_down)):
        raise TypeError("routed_experts: bf16 x and contiguous bf16 expert "
                        "weights")
    if w_up.shape != (E, d, I) or w_down.shape != (E, I, d) or d % 128:
        raise ValueError(f"routed_experts: x {tuple(x.shape)}, experts "
                         f"{tuple(w_gate.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)}; d a multiple of 128")
    if x.stride(1) != 1:
        x = x.contiguous()
    offsets = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    order = torch.argsort(ids.reshape(-1), stable=True)
    tok = (order // K).to(torch.int32)
    wts = weights.reshape(-1)[order].contiguous()
    dst = order.to(torch.int32)
    hbuf = torch.empty((T * K, I), dtype=x.dtype, device=x.device)
    y = torch.empty((T, K, d), dtype=torch.float32, device=x.device)
    ks = _kernels()
    ks["gate_up"][(E, -(-I // 64))](
        x, w_gate, w_up, hbuf, tok, counts, offsets, x.stride(0), d * I, I,
        d, I, BM=BLOCK_M, BN=64, BK=128, num_warps=4, num_stages=3)
    ks["down"][(E, -(-d // 64))](
        hbuf, w_down, y, wts, dst, counts, offsets, I * d, d, d, I,
        BM=BLOCK_M, BN=64, BK=64, num_warps=4, num_stages=3)
    routed_experts.launches += 1
    return y.sum(1)


routed_experts.launches = 0
