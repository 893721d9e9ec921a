"""Decode attention: the length-aware flash-decode kernel (K2), its paged
sibling (B9), and their plain versions.

:func:`flash_decode_attend` wraps the hand-written CUDA kernel in
``csrc/flash_decode.cu`` that replaces the Pallas kernel
``mpi_acx_tpu/ops/flash_decode.py:_decode_kernel``: grouped-query decode
attention of a W-token window against an un-repeated ``[B, max_len, Hkv,
D]`` cache, reading only the live rows ``[0, pos + W)`` of each slot.
:func:`paged_flash_decode_attend` wraps the same kernel template's paged
instantiation, which replaces ``_paged_decode_kernel``: the cache rows live
in ``[P, page_tokens, Hkv, D]`` pools and slot b's row t on pool page
``table[b, t // page_tokens]``. Both take a bf16/f32 cache or an int8 one
as ``(codes, f32 scales [..., 1])`` pairs (ops/kvquant.py). On a CUDA
tensor each wrapper launches its kernel or raises, and counts the launch
(``launches`` for the bf16/f32 form, ``launches_int8`` for the int8 form,
each with a ``_d128`` twin for K2 at head dim 128);
on a CPU tensor it runs the plain version: :func:`dense_decode_attend`, the
JAX package's ``models/decoding.py:dense_decode_attend``, and
:func:`paged_gather_attend`, which gathers each slot's pages into that
layout first.

The kernel splits each slot's keys over CTAs in chunks of
:func:`decode_chunk` positions, a rule of what the host knows (the shape
and the card's SM count, never ``pos``, which stays on the card). A slot's
chunks form one thread block cluster, and its first chunk merges the
others' partial states from its own shared memory: a call allocates
nothing but its output.
"""

from __future__ import annotations

import torch

from mpi_acx_torch.ops import _build

TILE = 128          # keys a CTA stages at a time (csrc kTile)
MAX_CLUSTER = 8     # chunks per slot at most: a portable cluster (csrc)
CTAS_PER_SM = 4     # full-cache CTAs an SM is given at head dim 64
HEAD_DIMS = (64, 128)       # K2's head dims (the contiguous cache)
PAGED_HEAD_DIMS = (64,)     # B9's: no path pages a head dim 128 cache


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


def paged_gather_attend(q, kp, vp, table, pos, page_tokens, n_rep):
    """Plain version of paged decode attention: gather each slot's pages
    (``kp``/``vp`` [P, page_tokens, Hkv, D] pools, or ``(codes, scales)``
    pairs of pools, through the ``[B, max_pages]`` table) into the
    contiguous ``[B, max_pages * page_tokens, Hkv, D]`` layout and run
    :func:`dense_decode_attend` on it. Gathered rows past a slot's horizon
    contribute exactly 0 through the masked softmax, as the fixed cache's
    own dead tail does."""
    B, max_pages = table.shape
    max_len = max_pages * page_tokens
    idx = torch.as_tensor(table, device=q.device).long()

    def gather(pool):
        return pool[idx].reshape((B, max_len) + tuple(pool.shape[2:]))

    kin = (gather(kp[0]), gather(kp[1])) if isinstance(kp, tuple) \
        else gather(kp)
    vin = (gather(vp[0]), gather(vp[1])) if isinstance(vp, tuple) \
        else gather(vp)
    return dense_decode_attend(q, kin, vin, pos, max_len, n_rep)


def check_head_dim(name, D, dims):
    """Raise unless the decode kernel ``name`` is built for head dim
    ``D`` (``dims``: :data:`HEAD_DIMS` for K2, :data:`PAGED_HEAD_DIMS` for
    B9)."""
    if D in dims:
        return
    if D in HEAD_DIMS:
        raise ValueError(
            f"{name}: head dim {D} is built for the contiguous cache "
            f"(flash_decode_attend) only: the paged server serves GPT-2, "
            f"no path pages a head dim {D} cache")
    raise ValueError(f"{name}: the kernel is built for head dims "
                     f"{', '.join(map(str, dims))}, got {D}")


def _check_q(name, q, n_rep, dims=HEAD_DIMS):
    """q's shape [B, W, Hq, D] and the kernel's layout rules."""
    if q.ndim != 4:
        raise ValueError(f"{name} takes q [B, W, Hq, D]")
    B, W, Hq, D = q.shape
    if n_rep <= 0 or Hq % n_rep:
        raise ValueError(f"{name}: {Hq} query heads, n_rep {n_rep}")
    check_head_dim(name, D, dims)
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {q.device}")
    if q.stride(-1) != 1 or q.stride(-2) != D:
        raise ValueError(f"{name}: q needs head stride D and element "
                         "stride 1")
    return B, W, Hq, D


def _cache_operands(name, q, kc, vc, units, rows, Hkv):
    """The K/V operands of a kernel call, checked: ``(k, v, ks, vs,
    quant)``; ``kc``/``vc`` are both tensors of q's type or both ``(int8
    codes, f32 scales)`` pairs, each ``[units, rows, Hkv, D]`` (scales
    ``[..., 1]``) with rows of contiguous ``[Hkv, D]`` blocks on 16-byte
    bounds."""
    quant = isinstance(kc, tuple)
    if quant != isinstance(vc, tuple):
        raise TypeError(f"{name}: K and V must both be int8 (codes, "
                        "scales) pairs or both plain caches")
    ks = vs = None
    if quant:
        (kc, ks), (vc, vs) = kc, vc
    D = q.shape[-1]
    want = torch.int8 if quant else q.dtype
    for c in (kc, vc):
        if tuple(c.shape) != (units, rows, Hkv, D):
            raise ValueError(f"{name}: cache {tuple(c.shape)}, expected "
                             f"{(units, rows, Hkv, D)}")
        if c.device != q.device:
            raise ValueError(f"{name}: operands on different devices")
        if c.dtype != want:
            raise TypeError(f"{name}: cache dtype {c.dtype}, expected {want} "
                            f"with q in {q.dtype}")
        # Each lane reads its key row in 16-byte chunks.
        esize = c.element_size()
        if (c.stride(-1) != 1 or c.stride(-2) != D or c.data_ptr() % 16
                or (c.stride(0) * esize) % 16 or (c.stride(1) * esize) % 16):
            raise ValueError(f"{name}: cache rows must be contiguous [Hkv, "
                             "D] blocks on 16-byte bounds")
    for s in (ks, vs) if quant else ():
        if (tuple(s.shape) != (units, rows, Hkv, 1)
                or s.dtype != torch.float32 or s.device != q.device
                or s.stride(2) != 1):
            raise ValueError(f"{name}: scales must be f32 "
                             f"{(units, rows, Hkv, 1)} with head stride 1, "
                             f"got {tuple(s.shape)} {s.dtype}")
    return kc, vc, ks, vs, quant


def _pos_vector(name, pos, B, dev):
    pos = torch.as_tensor(pos, device=dev)
    if pos.ndim == 0:
        pos = pos.expand(B)
    if pos.shape != (B,):
        raise ValueError(f"{name}: pos shape {tuple(pos.shape)}")
    return pos.to(torch.int32).contiguous()


def row_block(rows):
    """Window rows (``W * n_rep``) per CTA: the kernel's row templates 1,
    2, 4 and 8."""
    return 1 if rows <= 1 else 2 if rows <= 2 else 4 if rows <= 4 else 8


def decode_chunk(B, Hkv, rows, max_len, sm_count, head_dim=64):
    """Positions per CTA of the decode kernels, a rule of what the host
    knows: the slots ``B``, KV groups ``Hkv``, window rows ``rows`` (``W *
    n_rep``), the cache length ``max_len``, the card's SMs and the head
    dim. Never the positions: they live on the card. A multiple of
    :data:`TILE`: the smallest one for which a full cache (every slot at
    ``max_len``) needs no more than ``CTAS_PER_SM * 64 / head_dim`` CTAs on
    each SM (a CTA's tile and shared memory grow with the head dim) and a
    slot no more chunks than one cluster holds (:data:`MAX_CLUSTER`).
    Below that a shorter live length spreads over the most SMs; past it
    more, smaller chunks queue for the SMs and add partials to merge.
    ``CTAS_PER_SM`` was set on an H100 from the A/B that ``chip_smoke.py``
    runs every time (128 to 1024 positions a CTA, at the served positions
    and the full cache, at GPT-2's and Llama-3-8B's decode shapes)."""
    units = B * Hkv * -(-rows // row_block(rows))
    per_sm = max(1, CTAS_PER_SM * 64 // head_dim)
    chunks = min(MAX_CLUSTER, max(1, per_sm * sm_count // units))
    return TILE * -(-max_len // (TILE * chunks))


def _sm_count(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _scale_strides(quant, ks, vs):
    if not quant:
        return (0, 0, 0, 0)
    return (ks.stride(0), ks.stride(1), vs.stride(0), vs.stride(1))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _count(fn, quant, D):
    attr = ("launches_int8" if quant else "launches") + (
        "_d128" if D == 128 else "")
    setattr(fn, attr, getattr(fn, attr) + 1)


def flash_decode_attend(q, kc, vc, pos, max_len, n_rep):
    """Length-aware decode attention (K2); same signature and output as
    :func:`dense_decode_attend`, whose ``(codes, scales)`` int8 form it
    takes too. On a CUDA tensor the kernel runs; on a CPU tensor this is
    :func:`dense_decode_attend`."""
    if q.device.type == "cpu":
        return dense_decode_attend(q, kc, vc, pos, max_len, n_rep)
    name = "flash_decode_attend"
    B, W, Hq, D = _check_q(name, q, n_rep)
    Hkv = Hq // n_rep
    k, v, ks, vs, quant = _cache_operands(name, q, kc, vc, B, max_len, Hkv)
    pos = _pos_vector(name, pos, B, q.device)
    chunk = decode_chunk(B, Hkv, W * n_rep, max_len, _sm_count(q.device),
                         D)
    out = torch.empty((B, W, Hq * D), dtype=q.dtype, device=q.device)
    st = _build.strides(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1),
                        *_scale_strides(quant, ks, vs))
    rc = _build.lib().acx_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        pos.data_ptr(), out.data_ptr(), _build.dtype_code(q.dtype),
        int(quant), B, W, Hkv, n_rep, D, max_len, chunk, st,
        _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(flash_decode_attend, quant, D)
    return out


flash_decode_attend.launches = 0
flash_decode_attend.launches_int8 = 0
flash_decode_attend.launches_d128 = 0
flash_decode_attend.launches_int8_d128 = 0


def paged_flash_decode_attend(q, kp, vp, table, pos, page_tokens, n_rep):
    """Paged decode attention (B9): K/V pools ``[P, page_tokens, Hkv, D]``
    (or ``(codes, scales)`` pairs of pools) addressed through a ``[B,
    max_pages]`` int32 table; same output as :func:`paged_gather_attend`.
    On a CUDA tensor the kernel runs, with the table and ``pos`` read on
    the card; on a CPU tensor this is :func:`paged_gather_attend`."""
    if q.device.type == "cpu":
        return paged_gather_attend(q, kp, vp, table, pos, page_tokens, n_rep)
    name = "paged_flash_decode_attend"
    B, W, Hq, D = _check_q(name, q, n_rep, PAGED_HEAD_DIMS)
    Hkv = Hq // n_rep
    table = torch.as_tensor(table, device=q.device)
    if table.ndim != 2 or table.shape[0] != B:
        raise ValueError(f"{name}: table {tuple(table.shape)} for {B} slots")
    max_pages = table.shape[1]
    if max_pages <= 0:
        raise ValueError(f"{name}: a table of no pages")
    table = table.to(torch.int32).contiguous()
    P = (kp[0] if isinstance(kp, tuple) else kp).shape[0]
    k, v, ks, vs, quant = _cache_operands(name, q, kp, vp, P, page_tokens,
                                          Hkv)
    pos = _pos_vector(name, pos, B, q.device)
    chunk = decode_chunk(B, Hkv, W * n_rep, max_pages * page_tokens,
                         _sm_count(q.device))
    out = torch.empty((B, W, Hq * D), dtype=q.dtype, device=q.device)
    st = _build.strides(q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                        v.stride(0), v.stride(1),
                        *_scale_strides(quant, ks, vs), table.stride(0))
    rc = _build.lib().acx_paged_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
        pos.data_ptr(), table.data_ptr(), out.data_ptr(),
        _build.dtype_code(q.dtype), int(quant), B, W, Hkv, n_rep, D,
        page_tokens, max_pages, P, chunk, st, _build.stream_handle(q.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(paged_flash_decode_attend, quant, D)
    return out


paged_flash_decode_attend.launches = 0
paged_flash_decode_attend.launches_int8 = 0


def select_decode_attend(decode_flash):
    """The ``decode_flash`` config switch (the JAX package's
    ``select_decode_attend``): ``False`` -> :func:`dense_decode_attend` on
    any device; ``True`` or ``None`` -> :func:`flash_decode_attend`, which
    launches the kernel for a CUDA tensor and runs the plain version for a
    CPU tensor. All take ``(q, kc, vc, pos, max_len, n_rep)``."""
    return (dense_decode_attend if decode_flash is False
            else flash_decode_attend)


def select_paged_decode_attend(decode_flash):
    """The paged arm of the same switch (the JAX package's
    ``select_paged_decode_attend``): ``False`` -> :func:`paged_gather_attend`;
    ``True`` or ``None`` -> :func:`paged_flash_decode_attend`. All take
    ``(q, kp, vp, table, pos, page_tokens, n_rep)``."""
    return (paged_gather_attend if decode_flash is False
            else paged_flash_decode_attend)
