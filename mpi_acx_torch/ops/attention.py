"""Prefill attention: the flash-attention kernel (K1) and its plain version.

:func:`flash_attention` is the wrapper of the hand-written CUDA kernel in
``csrc/flash_attention.cu``, which replaces the Pallas kernel
``mpi_acx_tpu/ops/attention.py:_flash_kernel``. On a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs
:func:`attention_reference`, the plain version, which mirrors the JAX
package's ``attention_reference``. Layout is the JAX package's: q, k, v
``[B, S, H, D]`` in, ``[B, S, H, D]`` out.

The TPU's S >= 1024 crossover of ``auto_attention`` was measured on a TPU
and is not carried over: on a CUDA tensor the kernel always runs.
"""

from __future__ import annotations

import math

import torch

from mpi_acx_torch.ops import _build

_NEG_INF = -1e30
HEAD_DIM = 64       # the one head dim the kernels are built for (GPT-2's)


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


def _check_rows(name, x, D):
    if x.stride(-1) != 1 or x.stride(-2) != D:
        raise ValueError(f"flash_attention: {name} needs head stride {D} and "
                         f"element stride 1, got strides {tuple(x.stride())}")


def flash_attention(q, k, v, causal: bool = True):
    """Flash attention, [B, S, H, D] in and out (K1).

    Causal needs S == Sk; non-causal takes any Sk. Any S works (the kernel
    masks the ragged tails). float32 runs in true f32, bfloat16 with f32
    softmax state. On a CPU tensor this is :func:`attention_reference`."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("flash_attention takes [B, S, H, D] q, k, v")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    B, S, H, D = q.shape
    Sk = k.shape[1]
    if k.shape != (B, Sk, H, D) or v.shape != k.shape:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if causal and Sk != S:
        raise ValueError(f"flash_attention: causal needs S == Sk ({S}, {Sk})")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v dtypes differ")
    if D != HEAD_DIM:
        raise ValueError(f"flash_attention: the kernel is built for head dim "
                         f"{HEAD_DIM} only, got {D}")
    code = _build.dtype_code(q.dtype)
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_rows(name, x, D)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    st = _build.strides(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1), out.stride(0),
                        out.stride(1))
    rc = _build.lib().acx_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), code, B,
        S, Sk, H, D, st, int(causal), _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def select_attention(use_flash):
    """The ``use_flash`` config switch (the JAX package's three-way
    ``select_attention``): ``False`` -> the plain version on any device;
    ``True`` or ``None`` -> :func:`flash_attention`, which launches the
    kernel for a CUDA tensor and runs the plain version for a CPU tensor —
    exactly the ``None`` policy, so the two share one callable. All take
    ``(q, k, v, causal=True)`` on [B, S, H, D]."""
    return attention_reference if use_flash is False else flash_attention
