"""Prefill and training attention: the flash-attention kernel (K1), its
row-logsumexp form (B10), and their plain versions and backward.

K1 is the hand-written CUDA kernel in ``csrc/flash_attention.cu``. It
replaces three Pallas kernels of ``mpi_acx_tpu/ops/attention.py``, each
behind the JAX package's entry point and signature:

* :func:`flash_attention` (B6, ``_flash_kernel``). With ``streaming`` (or
  Sk >= 16384 when ``streaming=None``) it is the streaming entry point
  (B7, ``_flash_stream_kernel``): the TPU needs a second kernel to hold
  one K/V tile at a time, K1 already does for any Sk, so B7 launches K1
  and counts in its own counters, ``flash_attention.launches_stream`` and
  ``launches_stream_d128``.
* :func:`flash_attention_lse` (B10, ``_flash_kernel(emit_lse=True)``):
  K1 with the row logsumexp as a second output, counted in
  ``flash_attention_lse.launches`` and ``launches_d128``.

Every entry point takes head dims 64 (GPT-2, MoE) and 128 (Llama-3-8B).

On a CUDA tensor a wrapper launches the kernel or raises; on a CPU tensor
it runs the plain version (:func:`attention_reference`,
:func:`_reference_lse`), which mirrors the JAX package's. Layout is the
JAX package's: q, k, v ``[B, S, H, D]`` in, ``[B, S, H, D]`` out, lse
``[B, H, S]`` f32.

Both are differentiable through ``torch.autograd.Function``s that share
the JAX package's blockwise flash backward (:func:`_flash_bwd_blockwise`).
As in the JAX package it is plain tensor code outside any kernel, on the
card too: it recomputes the logits block by block from (q, k, v, o) and
reuses the emitted lse where there is one. ``block_q``/``block_k`` shape
only that backward; the kernel tiles itself.

The TPU's S >= 1024 crossover of ``auto_attention`` was measured on a TPU
and is not carried over: on a CUDA tensor the kernel always runs.
"""

from __future__ import annotations

import math

import torch

from mpi_acx_torch import profiling
from mpi_acx_torch.ops import _build

_NEG_INF = -1e30
# Head dims K1 is built for, at B6, B7 and B10 alike: 64 (GPT-2, MoE) and
# 128 (Llama-3-8B).
HEAD_DIMS = (64, 128)
STREAM_MIN_SK = 16384   # streaming=None turns the streaming entry on here
TMA_ALIGN = 16      # bytes: TMA's granule for base addresses and strides


def attention_reference(q, k, v, causal: bool = True):
    """Dense-mask attention, [B, S, H, D] layout; f32 softmax. Ground
    truth for the kernel's numerics (and the CPU path of
    :func:`flash_attention`)."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    p = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def _reference_lse(q, k, v, causal: bool = True):
    """The plain version of :func:`flash_attention_lse`: the same contract
    (o [B, S, H, D] in q's dtype, lse [B, H, S] f32), materialized
    logits."""
    d = q.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones(s_q, s_k, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~mask, _NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)                # [B, H, S] f32
    p = torch.exp(logits - lse[..., None]).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v), lse


def _fit_blocks(S, block_q, block_k):
    """Shrink the requested block sizes to divisors of S. Returns
    ``(block_q, block_k)``, or ``None`` when S has no usable 128-multiple
    divisor (e.g. S=648)."""
    def fit(block):
        b = min(block, S)
        while b > 128 and S % b:
            b -= 128
        return b

    bq, bk = fit(block_q), fit(block_k)
    if S % bq or S % bk:
        return None
    return bq, bk


def _backward_blocks(S, Sk, block_q, block_k):
    """The backward's blocks: the JAX package's fitted divisors of S and
    Sk. Where it has none (it falls back to dense attention there), the
    requested sizes cut to S and Sk: the backward masks a ragged tail and
    the kernel takes any S, so there is no dense fallback."""
    fit_q = _fit_blocks(S, block_q, block_k)
    fit_k = _fit_blocks(Sk, block_q, block_k)
    if fit_q is None or fit_k is None:
        return min(block_q, S), min(block_k, Sk)
    return fit_q[0], fit_k[1]


def _flash_bwd_blockwise(qt, kt, vt, o, do, causal, block_q, block_k,
                         lse=None, dlse=None):
    """Blockwise flash backward ([B, H, S, D] operands), the JAX package's
    ``_flash_bwd_blockwise`` in PyTorch.

    Outer loop over q blocks; for each, an inner loop over exactly the k
    blocks at or below the diagonal (causal skips the rest) first rebuilds
    that q block's row logsumexp (skipped when the forward emitted ``lse``
    [B, H, S]), then applies the flash-backward formulas:
      dV_j += P_j^T dO;  dP_j = dO V_j^T;  D = rowsum(dO * O)
      dS_j = P_j * (dP_j - D + dLSE) * scale;  dQ += dS_j K_j;  dK_j += dS_j^T Q
    (the dLSE term is the cotangent of an emitted lse output). Everything
    runs in f32; the results are cast to the input dtypes. The last block
    of either loop may be short (a ragged tail)."""
    B, H, S, Dh = qt.shape
    Sk = kt.shape[2]
    scale = 1.0 / (Dh ** 0.5)
    k32, v32, do32 = kt.float(), vt.float(), do.float()
    Drow = (do32 * o.float()).sum(-1)                          # [B,H,S]
    dq = torch.empty((B, H, S, Dh), dtype=torch.float32, device=qt.device)
    dk = torch.zeros((B, H, Sk, Dh), dtype=torch.float32, device=qt.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, S, block_q):
        q1 = min(q0 + block_q, S)
        qb = qt[:, :, q0:q1].float()                           # [B,H,bq,D]
        dob = do32[:, :, q0:q1]
        rows = torch.arange(q0, q1, device=qt.device)[:, None]
        # k blocks [0, n_kv) hold at least one unmasked column for this q
        # block (the forward kernel's bound).
        n_kv = -(-(q1 if causal else Sk) // block_k)

        def logits(j):
            k0, k1 = j * block_k, min((j + 1) * block_k, Sk)
            kb = k32[:, :, k0:k1]
            s = (qb @ kb.transpose(-1, -2)) * scale
            if causal:
                cols = torch.arange(k0, k1, device=qt.device)[None, :]
                s = s.masked_fill(rows < cols, _NEG_INF)
            return s, kb, k0, k1

        if lse is not None:
            lse_b = lse[:, :, q0:q1].float()
        else:
            m = torch.full((B, H, q1 - q0), _NEG_INF, dtype=torch.float32,
                           device=qt.device)
            l = torch.zeros_like(m)
            for j in range(n_kv):
                s = logits(j)[0]
                m_new = torch.maximum(m, s.amax(-1))
                l = l * torch.exp(m - m_new) + torch.exp(
                    s - m_new[..., None]).sum(-1)
                m = m_new
            lse_b = m + torch.log(l)                           # [B,H,bq]

        rowterm = Drow[:, :, q0:q1, None]
        if dlse is not None:
            rowterm = rowterm - dlse[:, :, q0:q1, None].float()

        dq_b = torch.zeros_like(qb)
        for j in range(n_kv):
            s, kb, k0, k1 = logits(j)
            p = torch.exp(s - lse_b[..., None])                # [B,H,bq,bk]
            dv[:, :, k0:k1] += p.transpose(-1, -2) @ dob
            dp = dob @ v32[:, :, k0:k1].transpose(-1, -2)
            ds = p * (dp - rowterm) * scale
            dq_b += ds @ kb
            dk[:, :, k0:k1] += ds.transpose(-1, -2) @ qb
        dq[:, :, q0:q1] = dq_b
    return dq.to(qt.dtype), dk.to(kt.dtype), dv.to(vt.dtype)


def _check_rows(name, x, D):
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"flash_attention: {name} needs head stride {D} and "
                         f"element stride 1, got strides {tuple(x.stride())}")


def _check_inputs(q, k, v, causal):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, S, H, D] q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(f"flash_attention: causal needs S == Sk ({S}, {Sk})")


def block_rows(B, S, H, sm_count):
    """Query rows per CTA of K1's bf16 kernel, a rule of the shape and the
    card alone: 64 (one consumer warpgroup) when CTAs of 64 rows all run in
    one wave, B * H * ceil(S / 64) <= ``sm_count`` (the card's SMs, one CTA
    each), else 128 (two consumer warpgroups). Within one wave the smaller
    CTA finishes sooner (its warpgroup has the SM's tensor cores to
    itself); past it, the 128-row CTAs' single wave wins. On an H100's 132
    SMs serving prefill at B=1, H=12 (S <= 704) takes 64 rows, training
    (B=4, S=1024) and long context take 128. ``chip_smoke.py`` times both
    sizes on either side of the boundary."""
    return 64 if B * H * -(-S // 64) <= sm_count else 128


def tma_strides(x):
    """(batch, seq) element strides of a [B, S, H, D] operand as K1 takes
    them: a dimension of size 1 never moves the index, so its stride is
    that of a contiguous layout of the dimensions inside it."""
    B, S, H, D = x.shape
    ss = x.stride(1) if S > 1 else H * D
    sb = x.stride(0) if B > 1 else S * ss
    return sb, ss


def tma_ready(x):
    """Whether K1's tensor maps can read the bf16 operand ``x`` where it
    lies: a base address and (batch, seq) strides that are positive
    multiples of TMA_ALIGN bytes (the head stride, D = 64 or 128
    elements, is 128 or 256 bytes). An operand that is not gets copied by
    the wrapper."""
    es = x.element_size()
    return x.data_ptr() % TMA_ALIGN == 0 and all(
        st > 0 and st * es % TMA_ALIGN == 0 for st in tma_strides(x))


def check_head_dim(name, D):
    """Raise, naming the entry point ``name``, unless K1 is built for
    head dim ``D`` (:data:`HEAD_DIMS`)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernel is built for head dims "
                         f"{', '.join(map(str, HEAD_DIMS))}, got {D}")


def _launch(q, k, v, causal, emit_lse, name="flash_attention"):
    """One launch of K1 on CUDA tensors: ``o``, and with ``emit_lse`` the
    row logsumexp (B10) -> ``(o, lse)``. The bf16 kernel reads q, k, v by
    TMA: an operand that :func:`tma_ready` refuses is copied to a fresh
    contiguous tensor first, counted in ``flash_attention.copies`` (over
    all three entry points). ``name`` is the entry point, named in what
    :func:`check_head_dim` raises. Raises on what the kernel does not take
    and on a failed launch."""
    B, S, H, D = q.shape
    Sk = k.shape[1]
    check_head_dim(name, D)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    code = _build.dtype_code(q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x, D)
    rows = 64                               # the f32 kernel's blocks
    if q.dtype == torch.bfloat16:
        rows = block_rows(B, S, H, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        ops = []
        for x in (q, k, v):
            if not tma_ready(x):
                x = x.clone(memory_format=torch.contiguous_format)
                flash_attention.copies += 1
            ops.append(x)
        q, k, v = ops
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    st = _build.strides(*tma_strides(q), *tma_strides(k), *tma_strides(v),
                        out.stride(0), out.stride(1))
    stream = _build.stream_handle(q.device)
    args = (code, B, S, Sk, H, D, st, int(causal), rows, stream)
    if emit_lse:
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
        rc = _build.lib().acx_flash_attention_lse(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), *args)
    else:
        lse = None
        rc = _build.lib().acx_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *args)
    if rc < 0:
        raise RuntimeError(f"flash_attention: TMA tensor-map encode failed: "
                           f"CUresult {-rc}")
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    return out, lse


def _to_bhsd(*xs):
    """[B, S, H, D] <-> [B, H, S, D] views (the backward's layout)."""
    return tuple(x.transpose(1, 2) for x in xs)


class _Flash(torch.autograd.Function):
    """B6/B7 forward (K1, or the plain version on the CPU) and the
    blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k, streaming):
        if q.device.type == "cpu":
            o = attention_reference(q, k, v, causal=causal)
        elif streaming:
            o, _ = _launch(q, k, v, causal, False,
                           "flash_attention(streaming=True)")
            if q.shape[-1] == 128:
                flash_attention.launches_stream_d128 += 1
            else:
                flash_attention.launches_stream += 1
        else:
            o, _ = _launch(q, k, v, causal, emit_lse=False)
            if q.shape[-1] == 128:
                flash_attention.launches_d128 += 1
            else:
                flash_attention.launches += 1
        ctx.save_for_backward(q, k, v, o)
        ctx.blocks = (causal, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o = ctx.saved_tensors
        with profiling.annotate("acx.ops.attn_bwd"):
            grads = _flash_bwd_blockwise(*_to_bhsd(q, k, v, o, do),
                                         *ctx.blocks)
        return (*_to_bhsd(*grads), None, None, None, None)


class _FlashLse(torch.autograd.Function):
    """B10 forward (K1 with the lse, or the plain version on the CPU) and
    the blockwise backward, which reuses the emitted lse and folds in its
    cotangent."""

    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_k):
        if q.device.type == "cpu":
            o, lse = _reference_lse(q, k, v, causal=causal)
        else:
            o, lse = _launch(q, k, v, causal, True, "flash_attention_lse")
            if q.shape[-1] == 128:
                flash_attention_lse.launches_d128 += 1
            else:
                flash_attention_lse.launches += 1
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.blocks = (causal, block_q, block_k)
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, o, lse = ctx.saved_tensors
        with profiling.annotate("acx.ops.attn_bwd"):
            if do is None:
                do = torch.zeros_like(o)
            qt, kt, vt, ot, dot = _to_bhsd(q, k, v, o, do)
            grads = _flash_bwd_blockwise(qt, kt, vt, ot, dot, *ctx.blocks,
                                         lse=lse, dlse=dlse)
        return (*_to_bhsd(*grads), None, None, None)


def flash_attention(q, k, v, causal: bool = True, block_q: int = 512,
                    block_k: int = 512, streaming: bool | None = None):
    """Flash attention, [B, S, H, D] in and out; differentiable.

    On a CUDA tensor K1 runs: B6, or with ``streaming`` the streaming
    entry point B7 (``None`` -> on for Sk >= 16384); both launch the same
    kernel, counted apart by entry and head dim (``launches`` and
    ``launches_d128`` for B6 at 64 and 128, ``launches_stream`` and
    ``launches_stream_d128`` for B7). Causal needs S == Sk; non-causal
    takes any Sk. Any S works (the kernel masks the ragged tails).
    float32 runs in true f32, bfloat16 with f32 softmax state. On a CPU
    tensor this is :func:`attention_reference`. The gradient is the
    blockwise backward over ``block_q``/``block_k``."""
    _check_inputs(q, k, v, causal)
    if streaming is None:
        streaming = k.shape[1] >= STREAM_MIN_SK
    bq, bk = _backward_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return _Flash.apply(q, k, v, causal, bq, bk, bool(streaming))


flash_attention.launches = 0
flash_attention.launches_d128 = 0
flash_attention.launches_stream = 0
flash_attention.launches_stream_d128 = 0
flash_attention.copies = 0


def flash_attention_lse(q, k, v, causal: bool = True, block_q: int = 512,
                        block_k: int = 512):
    """Flash attention that also returns the row logsumexp (B10), the merge
    state of sequence-parallel attention: ``(o [B, S, H, D] in q's dtype,
    lse [B, H, S] f32)`` with ``lse[b, h, s] = log sum_k exp(q.k/sqrt(D))``
    over the visible keys. Two partial results merge exactly:
    ``lse = logaddexp(lse1, lse2); o = o1*exp(lse1-lse) + o2*exp(lse2-lse)``.
    Differentiable in both outputs: the backward reuses the emitted lse
    and folds the lse cotangent into dS. Shape rules as
    :func:`flash_attention`; Sk may differ from S when non-causal. On a
    CUDA tensor K1 runs, counted in ``launches`` (head dim 64) and
    ``launches_d128``; on a CPU tensor this is :func:`_reference_lse`."""
    _check_inputs(q, k, v, causal)
    bq, bk = _backward_blocks(q.shape[1], k.shape[1], block_q, block_k)
    return _FlashLse.apply(q, k, v, causal, bq, bk)


flash_attention_lse.launches = 0
flash_attention_lse.launches_d128 = 0


def select_attention(use_flash):
    """The ``use_flash`` config switch (the JAX package's three-way
    ``select_attention``): ``False`` -> the plain version on any device;
    ``True`` or ``None`` -> :func:`flash_attention`, which launches the
    kernel for a CUDA tensor and runs the plain version for a CPU tensor —
    exactly the ``None`` policy, so the two share one callable. All take
    ``(q, k, v, causal=True)`` on [B, S, H, D]."""
    return attention_reference if use_flash is False else flash_attention
