"""Ring attention: exact attention over a sequence sharded on a mesh axis
(the JAX package's ``parallel/ring_attention.py``).

Each rank holds a sequence block of Q, K, V; K/V blocks rotate around the
ring while each rank merges its Q block's attention over every K/V block
by logaddexp. A K/V block is, by the causal structure, entirely visible
(source before this rank's block: a non-causal call), the diagonal (a
causal call) or entirely masked (skipped). The flash branch runs each
block through :func:`mpi_acx_torch.ops.attention.flash_attention_lse`
(B10; the kernel on a CUDA tensor), the dense branch through
:func:`_dense_block`. K and V travel stacked, one ``ppermute`` a ring
step, so their cotangents travel back as one message that cannot be
taken for the other's.
"""

from __future__ import annotations

import math

import torch

from mpi_acx_torch.ops.attention import flash_attention_lse
from mpi_acx_torch.parallel.collective import (_ring_perm, axis_index,
                                               axis_size, ppermute, tie)

_NEG = float(torch.finfo(torch.float32).min)


def _dense_block(q32, kk, vv, mask):
    """One Q-block x K-block dense attention: returns (normalized output
    [mb, Sq, H, D] f32, lse [mb, H, Sq] f32). Fully masked rows get
    lse = finfo.min (an additive identity for the logaddexp merge)."""
    d = q32.shape[-1]
    logits = torch.einsum("bqhd,bkhd->bhqk", q32, kk.float()) / math.sqrt(d)
    logits = torch.where(mask, logits, _NEG)
    m = logits.amax(-1)                               # [mb, H, Sq]
    p = torch.exp(logits - m[..., None])
    p = torch.where(mask, p, 0.0)                     # kill fully masked rows
    l = p.sum(-1)                                     # [mb, H, Sq]
    o = torch.einsum("bhqk,bkhd->bqhd", p, vv.float())
    lse = torch.where(l > 0, m + torch.log(l.clamp(min=1e-37)), _NEG)
    o = o / l.clamp(min=1e-37).transpose(1, 2)[..., None]
    return o, lse


def ring_attention_batched(q, k, v, axis_name: str, causal: bool = True,
                           use_flash: bool | None = None,
                           kv_repeat: int = 1):
    """Exact (optionally causal) attention with K/V rotating on the ring.

    Per-rank shapes: q ``[mb, seq_shard, heads, head_dim]``; k, v
    ``[mb, seq_shard, heads / kv_repeat, head_dim]`` (``kv_repeat > 1`` is
    grouped-query attention: each block broadcasts the K/V heads to the
    query heads). Returns the attention output of the local Q block, shape
    and dtype of q.

    ``use_flash``: ``True`` -> the flash branch (B10's kernel on a CUDA
    tensor, its plain version on a CPU one), ``False`` -> the dense
    blocks, ``None`` -> the kernel on a CUDA tensor and the dense blocks on
    the CPU, the policy of the port's ``flash_attention``. The JAX
    package's ``FLASH_MIN_SHARD`` crossover was measured on a TPU and is
    not carried over. On the flash branch q stays in its dtype; on the
    dense branch it is f32. Both yield (normalized block output, lse) and
    merge by logaddexp with ``finfo(f32).min`` sentinels."""
    n = axis_size(axis_name)
    my = axis_index(axis_name)
    mb, sq, h, dh = q.shape
    if k.shape[2] * kv_repeat != h:
        raise ValueError(f"k heads {k.shape[2]} x kv_repeat {kv_repeat} != "
                         f"q heads {h}")
    if use_flash is None:
        use_flash = q.is_cuda

    def expand(x):
        # kv head g serves query heads [g*kv_repeat, (g+1)*kv_repeat).
        if kv_repeat == 1:
            return x
        hkv = x.shape[2]
        return x[:, :, :, None, :].expand(
            mb, x.shape[1], hkv, kv_repeat, dh).reshape(mb, x.shape[1], h, dh)

    if use_flash:
        def block_fn(q_, kk, vv, src):
            if causal and src > my:                   # entirely masked
                # The block that arrived is tied in with a zero cotangent,
                # so that its ppermute runs its backward on this rank as on
                # the ranks that read theirs.
                return (tie(torch.zeros((mb, sq, h, dh), dtype=torch.float32,
                                        device=q.device), kk, vv),
                        torch.full((mb, h, sq), _NEG, dtype=torch.float32,
                                   device=q.device))
            o, lse = flash_attention_lse(q_, expand(kk), expand(vv),
                                         causal=causal and src == my)
            return o.float(), lse

        q_in = q
    else:
        def block_fn(q_, kk, vv, src):
            if causal:
                qpos = my * sq + torch.arange(sq, device=q.device)[:, None]
                kpos = src * sq + torch.arange(kk.shape[1],
                                               device=q.device)[None, :]
                mask = (kpos <= qpos)[None, None]       # [1, 1, Sq, Sk]
            else:
                mask = torch.ones((1, 1, sq, kk.shape[1]), dtype=torch.bool,
                                  device=q.device)
            return _dense_block(q_, expand(kk), expand(vv), mask)

        q_in = q.float()

    o_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse_acc = torch.full((mb, h, sq), _NEG, dtype=torch.float32,
                         device=q.device)
    kk, vv = k, v
    for t in range(n):
        # The K/V block held now arrived from t ring steps back.
        o_b, lse_b = block_fn(q_in, kk, vv, (my - t) % n)
        # logaddexp merge; finfo.min sentinels stay finite, so the weights
        # need no NaN guard.
        lse_new = torch.logaddexp(lse_acc, lse_b)
        wa = torch.exp(lse_acc - lse_new).transpose(1, 2)[..., None]
        wb = torch.exp(lse_b - lse_new).transpose(1, 2)[..., None]
        o_acc = o_acc * wa + o_b * wb
        lse_acc = lse_new
        if t < n - 1:           # the JAX ring's last rotation is unused
            kk, vv = ppermute(torch.stack([kk, vv]), axis_name,
                              _ring_perm(n, 1)).unbind(0)
    return o_acc.to(q.dtype)


def ring_attention(q, k, v, axis_name: str, causal: bool = True,
                   use_flash: bool | None = None):
    """3-D per-rank form: q, k, v ``[seq_shard, heads, head_dim]``."""
    return ring_attention_batched(q[None], k[None], v[None], axis_name,
                                  causal=causal, use_flash=use_flash)[0]


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "x",
                           causal: bool = True,
                           use_flash: bool | None = None):
    """The JAX wrapper's per-rank meaning: this rank's sequence blocks of
    q, k, v ``[seq_shard, heads, head_dim]`` (the leading axis sharded over
    ``axis_name`` of ``mesh``); returns this rank's output block."""
    with mesh:
        return ring_attention(q, k, v, axis_name, causal=causal,
                              use_flash=use_flash)


def blockwise_attention_reference(q, k, v, causal: bool = True):
    """Single-device reference attention (for tests): [S, H, D] inputs."""
    d = q.shape[-1]
    logits = torch.einsum("qhd,khd->hqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        s = q.shape[0]
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask[None], logits, _NEG)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("hqk,khd->qhd", p, v.float()).to(q.dtype)
