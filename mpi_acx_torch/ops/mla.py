"""Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 section 2.1):
the prefill kernel at a query/key width of 192 and a value width of 128,
the absorbed decode kernel over a latent cache, and their plain versions.

No kernel of the JAX package computes either form (it has no latent
attention), so neither replaces a TPU kernel; both were added for
``models/deepseek_v2.py``. Both are Triton kernels, built at their first
call (Triton is imported inside the launching function), each beside a
plain PyTorch version that the wrapper runs for CPU tensors. On a CUDA
tensor a wrapper launches its kernel or raises, and counts the launch in
``launches``.

* :func:`mla_flash_attention` (K1 at 192/128, kernel ``_mla_prefill_kernel``):
  causal flash attention of the non-absorbed form, per-head q and k ``[B,
  S, H, 192]`` (128 "nope" dims then 64 rope dims) and v ``[B, S, H,
  128]``. V is not padded: the kernel carries a 128-wide accumulator and
  splits each 192-wide row into a 128-wide and a 64-wide part (Triton's
  blocks are powers of two), so the two products of a score add. 64-row
  query blocks, 64 keys at a time, the online softmax in f32 and the
  probabilities rounded to bf16 for the PV product. Bound: operations at
  long prompts, bytes at short ones.
* :func:`mla_decode_attend` (kernels ``_mla_decode_split_kernel`` and
  ``_mla_decode_combine_kernel``): the absorbed form. Each slot's 16 query
  rows of 576 (a 512-wide latent query and the 64-wide rope query) attend
  the cached rows ``[c, k_pe]`` of 576 that every head shares; the first
  512 of a row are the value. K2's design: only the live rows ``[0,
  pos]`` are read, the positions are split over programs in chunks of
  :data:`SPLIT` (a static grid over ``max_len``, so a program past its
  slot's live rows exits at once), and the 16 query rows share each key
  row a program loads. A second kernel merges the chunks' partial softmax
  states. Bound: bytes, each live row read once for all heads.
"""

from __future__ import annotations

import math

import torch

from mpi_acx_torch import profiling

SPLIT = 128         # positions one decode program covers
_LOG2E = 1.4426950408889634
_KERNELS = {}


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _kernels():
    """The Triton kernels, built once a process at their first launch."""
    if _KERNELS:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def _mla_prefill_kernel(Q, K, V, O, sqb, sqs, sqh, skb, sks, skh, svb,
                            svs, svh, sob, sos, soh, S, H, qk_scale,
                            BLOCK_M: tl.constexpr, BLOCK_N: tl.constexpr,
                            DN: tl.constexpr, DR: tl.constexpr,
                            DV: tl.constexpr):
        pid_m = tl.program_id(0)
        pid_bh = tl.program_id(1)
        b = pid_bh // H
        h = pid_bh % H
        offs_m = pid_m * BLOCK_M + tl.arange(0, BLOCK_M)
        offs_n = tl.arange(0, BLOCK_N)
        dn = tl.arange(0, DN)
        dr = tl.arange(0, DR)
        dv = tl.arange(0, DV)
        mrow = offs_m < S
        q_base = Q + b * sqb + h * sqh + offs_m[:, None] * sqs
        q1 = tl.load(q_base + dn[None, :], mask=mrow[:, None], other=0.0)
        q2 = tl.load(q_base + DN + dr[None, :], mask=mrow[:, None],
                     other=0.0)
        k_base = K + b * skb + h * skh
        v_base = V + b * svb + h * svh
        m_i = tl.full([BLOCK_M], float("-inf"), tl.float32)
        l_i = tl.zeros([BLOCK_M], tl.float32)
        acc = tl.zeros([BLOCK_M, DV], tl.float32)
        hi = tl.minimum((pid_m + 1) * BLOCK_M, S)
        for n0 in range(0, hi, BLOCK_N):
            cols = n0 + offs_n
            cmask = cols < S
            kp = k_base + cols[None, :] * sks
            k1 = tl.load(kp + dn[:, None], mask=cmask[None, :], other=0.0)
            k2 = tl.load(kp + DN + dr[:, None], mask=cmask[None, :],
                         other=0.0)
            s = (tl.dot(q1, k1) + tl.dot(q2, k2)) * qk_scale
            keep = (cols[None, :] <= offs_m[:, None]) & cmask[None, :]
            s = tl.where(keep, s, float("-inf"))
            m_new = tl.maximum(m_i, tl.max(s, 1))
            alpha = tl.exp2(m_i - m_new)
            p = tl.exp2(s - m_new[:, None])
            l_i = l_i * alpha + tl.sum(p, 1)
            v = tl.load(v_base + cols[:, None] * svs + dv[None, :],
                        mask=cmask[:, None], other=0.0)
            acc = acc * alpha[:, None] + tl.dot(p.to(v.dtype), v)
            m_i = m_new
        acc = acc / l_i[:, None]
        tl.store(O + b * sob + h * soh + offs_m[:, None] * sos + dv[None, :],
                 acc.to(O.dtype.element_ty), mask=mrow[:, None])

    @triton.jit
    def _mla_decode_split_kernel(Q, C, POS, MP, LP, OP, sqb, sqh, scb, scs,
                                 max_len, qk_scale, NSPLIT,
                                 H: tl.constexpr, DC: tl.constexpr,
                                 DR: tl.constexpr, SPLIT: tl.constexpr,
                                 BLOCK_N: tl.constexpr):
        b = tl.program_id(0)
        s = tl.program_id(1)
        n_live = tl.minimum(tl.load(POS + b) + 1, max_len)
        start = s * SPLIT
        if start < n_live:
            hh = tl.arange(0, H)
            dc = tl.arange(0, DC)
            dr = tl.arange(0, DR)
            offs_n = tl.arange(0, BLOCK_N)
            q_base = Q + b * sqb + hh[:, None] * sqh
            q_c = tl.load(q_base + dc[None, :])
            q_r = tl.load(q_base + DC + dr[None, :])
            m_i = tl.full([H], float("-inf"), tl.float32)
            l_i = tl.zeros([H], tl.float32)
            acc = tl.zeros([H, DC], tl.float32)
            end = tl.minimum(start + SPLIT, n_live)
            c_base = C + b * scb
            for n0 in range(start, end, BLOCK_N):
                rows = n0 + offs_n
                rmask = rows < end
                rp = c_base + rows[:, None] * scs
                kc = tl.load(rp + dc[None, :], mask=rmask[:, None], other=0.0)
                kr = tl.load(rp + DC + dr[None, :], mask=rmask[:, None],
                             other=0.0)
                sc = (tl.dot(q_c, tl.trans(kc))
                      + tl.dot(q_r, tl.trans(kr))) * qk_scale
                sc = tl.where(rmask[None, :], sc, float("-inf"))
                m_new = tl.maximum(m_i, tl.max(sc, 1))
                alpha = tl.exp2(m_i - m_new)
                p = tl.exp2(sc - m_new[:, None])
                l_i = l_i * alpha + tl.sum(p, 1)
                acc = acc * alpha[:, None] + tl.dot(p.to(kc.dtype), kc)
                m_i = m_new
            part = (b * NSPLIT + s) * H + hh
            tl.store(MP + part, m_i)
            tl.store(LP + part, l_i)
            tl.store(OP + part[:, None] * DC + dc[None, :], acc)

    @triton.jit
    def _mla_decode_combine_kernel(POS, MP, LP, OP, O, sob, soh, max_len,
                                   NSPLIT, H: tl.constexpr, DC: tl.constexpr,
                                   SPLIT: tl.constexpr, NSP: tl.constexpr):
        b = tl.program_id(0)
        h = tl.program_id(1)
        n_live = tl.minimum(tl.load(POS + b) + 1, max_len)
        ns = tl.cdiv(n_live, SPLIT)
        ss = tl.arange(0, NSP)
        live = ss < ns
        parts = (b * NSPLIT + ss) * H + h
        ms = tl.load(MP + parts, mask=live, other=float("-inf"))
        m_max = tl.max(ms, 0)
        ws = tl.where(live, tl.exp2(ms - m_max), 0.0)
        total = tl.sum(ws * tl.load(LP + parts, mask=live, other=0.0), 0)
        dc = tl.arange(0, DC)
        acc = tl.zeros([DC], tl.float32)
        for s in range(0, ns):
            part = (b * NSPLIT + s) * H + h
            w = tl.exp2(tl.load(MP + part) - m_max)
            acc += w * tl.load(OP + part * DC + dc)
        tl.store(O + b * sob + h * soh + dc,
                 (acc / total).to(O.dtype.element_ty))

    _KERNELS.update(prefill=_mla_prefill_kernel,
                    split=_mla_decode_split_kernel,
                    combine=_mla_decode_combine_kernel,
                    next_pow2=triton.next_power_of_2)
    return _KERNELS


# -- prefill: the non-absorbed form -----------------------------------------


def mla_attention_reference(q, k, v, scale: float, causal: bool = True,
                            out=None):
    """Plain causal attention with a value width of its own: q, k ``[B, S,
    H, Dqk]``, v ``[B, S, H, Dv]`` -> ``[B, S, H, Dv]`` in q's dtype; the
    logits times ``scale`` and the softmax in f32. Written into ``out``
    when given."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale
    if causal:
        S, Sk = q.shape[1], k.shape[1]
        mask = torch.ones(S, Sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, float("-inf"))
    p = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o if out is None else out.copy_(o)


def mla_flash_attention(q, k, v, scale: float, causal: bool = True,
                        out=None):
    """Causal attention of the non-absorbed form (K1 at 192/128): q, k
    ``[B, S, H, 192]``, v ``[B, S, H, 128]``, bf16, each with unit stride
    in its last dimension -> ``[B, S, H, 128]``, written into ``out`` when
    given (the captured prefill's static buffer, models/decoding.py). On a
    CPU tensor this is :func:`mla_attention_reference`."""
    if q.device.type == "cpu":
        return mla_attention_reference(q, k, v, scale, causal, out=out)
    B, S, H, D = q.shape
    if not causal:
        raise ValueError("mla_flash_attention: the kernel is causal")
    if k.shape != (B, S, H, D) or v.shape[:3] != (B, S, H):
        raise ValueError(f"mla_flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    DV = v.shape[-1]
    if (D, DV) != (192, 128):
        raise ValueError(f"mla_flash_attention: the kernel takes a q/k width "
                         f"of 192 and a value width of 128, got {D}, {DV}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError("mla_flash_attention: q, k, v must be bfloat16")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("mla_flash_attention: the last dimension must have "
                         "unit stride")
    if out is None:
        out = torch.empty((B, S, H, DV), dtype=q.dtype, device=q.device)
    elif (out.shape != (B, S, H, DV) or out.dtype != q.dtype
          or out.device != q.device or out.stride(-1) != 1):
        raise ValueError(f"mla_flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} is no [B, S, H, {DV}] bf16 tensor "
                         f"with unit stride in its last dimension")
    kern = _kernels()["prefill"]
    grid = (_cdiv(S, 64), B * H)
    kern[grid](q, k, v, out, *q.stride()[:3], *k.stride()[:3],
               *v.stride()[:3], *out.stride()[:3], S, H, scale * _LOG2E,
               BLOCK_M=64, BLOCK_N=64, DN=128, DR=64, DV=DV,
               num_warps=4, num_stages=2)
    mla_flash_attention.launches += 1
    return out


mla_flash_attention.launches = 0


def select_mla_attention(use_flash=None):
    """The prefill form's entry as the families look attention up
    (``select_attention(use_flash)``): :func:`mla_flash_attention`, which
    takes its plain version on a CPU tensor; ``use_flash`` is not read.
    Takes ``(q, k, v, scale)``."""
    return mla_flash_attention


# -- decode: the absorbed form over the latent cache ------------------------


def mla_decode_reference(q, cache, pos, scale: float, kv_lora: int,
                         out=None):
    """Plain absorbed decode: q ``[B, 1, H, D]`` (D = ``kv_lora`` + the
    rope width) at each slot's position ``pos`` (a scalar or ``[B]``)
    against one layer's latent rows ``cache [B, max_len, 1, D]`` -> ``[B,
    1, H, kv_lora]``, the first ``kv_lora`` of each row as the value; rows
    past ``pos`` are masked. Copied into ``out`` when given."""
    B, W = q.shape[:2]
    rows = cache[:, :, 0]                                   # [B, T, D]
    logits = torch.einsum("bwhd,btd->bwht", q, rows).float() * scale
    cols = torch.arange(rows.shape[1], device=q.device)
    last = torch.as_tensor(pos, device=q.device).reshape(-1, 1).expand(B, 1)
    dead = cols[None, :] > last                                  # [B, T]
    logits = logits.masked_fill(dead[:, None, None, :], float("-inf"))
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bwht,btd->bwhd", p, rows[..., :kv_lora])
    if out is not None:
        out.copy_(o)
        return out
    return o


def mla_decode_attend(q, cache, pos, scale: float, kv_lora: int, out=None):
    """The absorbed decode attention of one layer (contract of
    :func:`mla_decode_reference`); on a CUDA tensor the split and combine
    kernels, reading only the live rows, with an int32 ``pos`` and a bf16
    q and cache whose rows have unit stride."""
    with profiling.annotate("acx.ops.mla_decode"):
        if q.device.type == "cpu":
            return mla_decode_reference(q, cache, pos, scale, kv_lora, out)
        B, W, H, D = q.shape
        max_len = cache.shape[1]
        if W != 1 or cache.shape != (B, max_len, 1, D):
            raise ValueError(f"mla_decode_attend: q {tuple(q.shape)} and "
                             f"cache {tuple(cache.shape)}: one token a slot "
                             f"against [B, max_len, 1, D] rows")
        if (kv_lora, D - kv_lora) != (512, 64) or H != 16:
            raise ValueError(f"mla_decode_attend: the kernel takes 16 heads "
                             f"of 512 + 64, got {H} heads of {kv_lora} + "
                             f"{D - kv_lora}")
        if not (q.dtype == cache.dtype == torch.bfloat16):
            raise TypeError("mla_decode_attend: q and the cache must be "
                            "bfloat16")
        if (q.stride(-1) != 1 or cache.stride(-1) != 1
                or q.stride(2) != D):
            raise ValueError("mla_decode_attend: rows need unit stride")
        if pos.ndim == 0:
            pos = pos.reshape(1).expand(B).contiguous()
        if pos.shape != (B,) or pos.dtype != torch.int32:
            raise ValueError("mla_decode_attend: pos must be a scalar or "
                             "[B], int32")
        ks = _kernels()
        nsplit = _cdiv(max_len, SPLIT)
        m_part = torch.empty((B, nsplit, H), dtype=torch.float32,
                             device=q.device)
        l_part = torch.empty_like(m_part)
        o_part = torch.empty((B, nsplit, H, kv_lora), dtype=torch.float32,
                             device=q.device)
        if out is None:
            out = torch.empty((B, 1, H, kv_lora), dtype=q.dtype,
                              device=q.device)
        ks["split"][(B, nsplit)](
            q, cache, pos, m_part, l_part, o_part, q.stride(0), q.stride(2),
            cache.stride(0), cache.stride(1), max_len, scale * _LOG2E,
            nsplit, H=H, DC=kv_lora, DR=D - kv_lora, SPLIT=SPLIT,
            BLOCK_N=32, num_warps=4, num_stages=2)
        ks["combine"][(B, H)](
            pos, m_part, l_part, o_part, out, out.stride(0), out.stride(2),
            max_len, nsplit, H=H, DC=kv_lora, SPLIT=SPLIT,
            NSP=ks["next_pow2"](nsplit), num_warps=4)
        mla_decode_attend.launches += 1
        return out


mla_decode_attend.launches = 0


def softmax_scale(q_head: int, factor: float, mscale_all_dim: float) -> float:
    """The published softmax scale: ``q_head ** -0.5`` times the square of
    YaRN's attention factor ``0.1 * mscale_all_dim * ln(factor) + 1``
    (``modeling_deepseek.py``, ``DeepseekV2Attention``)."""
    scale = q_head ** -0.5
    if mscale_all_dim and factor > 1:
        m = 0.1 * mscale_all_dim * math.log(factor) + 1.0
        scale *= m * m
    return scale
