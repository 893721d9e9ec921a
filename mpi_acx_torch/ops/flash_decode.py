"""Decode attention: the length-aware flash-decode kernel (K2) and its
plain version.

:func:`flash_decode_attend` wraps the hand-written CUDA kernel in
``csrc/flash_decode.cu``, which replaces the Pallas kernel
``mpi_acx_tpu/ops/flash_decode.py:_decode_kernel``: grouped-query decode
attention of a W-token window against an un-repeated ``[B, max_len, Hkv,
D]`` cache, reading only the live rows ``[0, pos + W)`` of each slot. On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
:func:`dense_decode_attend`, the plain version, which is the JAX package's
``models/decoding.py:dense_decode_attend``.
"""

from __future__ import annotations

import torch

from mpi_acx_torch.ops import _build
from mpi_acx_torch.ops.attention import HEAD_DIM


def dense_decode_attend(q, kc, vc, pos, max_len, n_rep):
    """Dense reference for decode attention: q [B, W, Hq, D] at positions
    pos..pos+W-1 against kc/vc [B, max_len, Hkv, D] (Hq = Hkv*n_rep) ->
    [B, W, Hq*D]. Reads the whole cache; window row w attends entries <=
    pos + w; ``pos`` is a scalar or [B] (one position per slot).

    ``kc``/``vc`` may each be an ``(int8 codes, f32 scales [B, max_len,
    Hkv, 1])`` tuple: the scales then multiply the logits and the
    probabilities, never the cache (the JAX package's scale-on-scores
    factoring)."""
    ks = vs = None
    if isinstance(kc, tuple):
        kc, ks = kc
    if isinstance(vc, tuple):
        vc, vs = vc
    B, W = q.shape[:2]
    Hkv, Dh = kc.shape[2], kc.shape[3]
    qg = q.reshape(B, W, Hkv, n_rep, Dh)
    qg = (qg.float() * (1.0 / Dh ** 0.5)).to(q.dtype)
    kin = kc if ks is None else kc.to(q.dtype)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, kin).float()
    if ks is not None:
        logits = logits * ks[..., 0].transpose(1, 2)[:, :, None, None]
    pos = torch.as_tensor(pos, device=q.device)
    cols = torch.arange(max_len, device=q.device)
    win = torch.arange(W, device=q.device)
    if pos.ndim == 0:
        mask = (cols[None, :] <= (pos + win)[:, None])[None, None, None]
    else:
        rows = pos[:, None, None] + win[None, :, None]          # [B, W, 1]
        mask = (cols[None, None, :] <= rows)[:, None, None]      # [B,1,1,W,L]
    logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    p = torch.softmax(logits, dim=-1)
    if vs is not None:
        p = p * vs[..., 0].transpose(1, 2)[:, :, None, None]
    p = p.to(q.dtype)
    vin = vc if vs is None else vc.to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", p, vin).reshape(
        B, W, Hkv * n_rep * Dh)


def flash_decode_attend(q, kc, vc, pos, max_len, n_rep):
    """Length-aware decode attention (K2); same signature and output as
    :func:`dense_decode_attend`. On a CUDA tensor the kernel runs: a
    ``(codes, scales)`` int8 cache raises ``NotImplementedError`` there (a
    later slice ports that operand form with ``ops/kvquant.py``). On a CPU
    tensor this is :func:`dense_decode_attend`."""
    dev = q.device
    if dev.type == "cpu":
        return dense_decode_attend(q, kc, vc, pos, max_len, n_rep)
    if isinstance(kc, tuple) or isinstance(vc, tuple):
        raise NotImplementedError(
            "flash_decode_attend: the int8 (codes, scales) cache form has no "
            "CUDA kernel yet")
    if dev.type != "cuda":
        raise ValueError(f"flash_decode_attend: no kernel for {dev}")
    if q.ndim != 4 or kc.ndim != 4:
        raise ValueError("flash_decode_attend takes q [B, W, Hq, D] and "
                         "caches [B, max_len, Hkv, D]")
    B, W, Hq, D = q.shape
    Hkv = kc.shape[2]
    if (kc.shape != (B, max_len, Hkv, D) or vc.shape != kc.shape
            or Hq != Hkv * n_rep):
        raise ValueError(f"flash_decode_attend: q {tuple(q.shape)}, cache "
                         f"{tuple(kc.shape)}, max_len {max_len}, n_rep {n_rep}")
    if not (kc.device == vc.device == dev):
        raise ValueError("flash_decode_attend: operands on different devices")
    if not (q.dtype == kc.dtype == vc.dtype):
        raise TypeError("flash_decode_attend: q and cache dtypes differ")
    if D != HEAD_DIM:
        raise ValueError(f"flash_decode_attend: the kernel is built for head "
                         f"dim {HEAD_DIM} only, got {D}")
    code = _build.dtype_code(q.dtype)
    esize = q.element_size()
    if q.stride(-1) != 1 or q.stride(-2) != D:
        raise ValueError("flash_decode_attend: q needs head stride D and "
                         "element stride 1")
    for c in (kc, vc):
        # Each lane reads its key row in 16-byte chunks.
        if (c.stride(-1) != 1 or c.stride(-2) != D or c.data_ptr() % 16
                or (c.stride(0) * esize) % 16 or (c.stride(1) * esize) % 16):
            raise ValueError("flash_decode_attend: cache rows must be "
                             "contiguous [Hkv, D] blocks on 16-byte bounds")
    pos = torch.as_tensor(pos, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"flash_decode_attend: pos shape {tuple(pos.shape)}")
    pos = pos.to(torch.int32).contiguous()
    out = torch.empty((B, W, Hq * D), dtype=q.dtype, device=dev)
    st = _build.strides(q.stride(0), q.stride(1), kc.stride(0), kc.stride(1),
                        vc.stride(0), vc.stride(1))
    rc = _build.lib().acx_flash_decode(
        q.data_ptr(), kc.data_ptr(), vc.data_ptr(), pos.data_ptr(),
        out.data_ptr(), code, B, W, Hkv, n_rep, D, max_len, st,
        _build.stream_handle(dev))
    if rc != 0:
        raise RuntimeError(f"flash_decode_attend kernel launch failed: CUDA "
                           f"error {rc}")
    flash_decode_attend.launches += 1
    return out


flash_decode_attend.launches = 0


def select_decode_attend(decode_flash):
    """The ``decode_flash`` config switch (the JAX package's
    ``select_decode_attend``): ``False`` -> :func:`dense_decode_attend` on
    any device; ``True`` or ``None`` -> :func:`flash_decode_attend`, which
    launches the kernel for a CUDA tensor and runs the plain version for a
    CPU tensor. All take ``(q, kc, vc, pos, max_len, n_rep)``."""
    return (dense_decode_attend if decode_flash is False
            else flash_decode_attend)
