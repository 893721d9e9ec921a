"""Ulysses (all-to-all) sequence parallelism: the JAX package's
``parallel/ulysses.py`` over :mod:`mpi_acx_torch.parallel.collective`.

The second long-context strategy beside ring attention
(``parallel/ring_attention.py``). Ring attention keeps the sequence
sharded and rotates K/V around the ring; Ulysses re-shards instead: one
all_to_all turns the sequence-sharded q/k/v into head-sharded ones, each
rank runs attention over the whole sequence for its H/n heads with a
one-device kernel (K1 on a CUDA tensor), and a second all_to_all restores
the sequence sharding. Two collectives in all.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from mpi_acx_torch.parallel import collective as col


def _default_local_attn(q, k, v, causal: bool):
    """Attention over the whole sequence for the local heads, [S, H_loc,
    D]: ``flash_attention`` (K1 on a CUDA tensor, its plain version on
    the CPU). The JAX package's default picks between flash and dense by
    its crossover policy for the TPU, which the port leaves out."""
    from mpi_acx_torch.ops.attention import flash_attention
    return flash_attention(q[None], k[None], v[None], causal=causal)[0]


def ulysses_attention(q, k, v, axis_name: str, causal: bool = True,
                      attn_fn: Optional[Callable] = None):
    """Exact attention under Ulysses sequence parallelism, run by every
    rank of the mesh axis ``axis_name`` (under an active mesh).

    q, k, v are this rank's [seq_shard, heads, head_dim] blocks; the
    global sequence is the blocks in axis order, and ``heads`` must divide
    by the axis size. Returns this rank's block of the output, same shape.
    ``attn_fn(q, k, v, causal)`` runs on [S_global, heads / n, head_dim];
    the default is :func:`_default_local_attn`."""
    n = col.axis_size(axis_name)
    # The JAX package's assertions, raised so that -O keeps them.
    if q.ndim != 3:
        raise AssertionError(
            f"expected [seq_shard, heads, head_dim], got {q.shape}")
    H = q.shape[1]
    if H % n:
        raise AssertionError(f"heads {H} not divisible by axis size {n}")
    if attn_fn is None:
        attn_fn = _default_local_attn
    # Sequence-sharded -> head-sharded; q, k, v travel in ONE all_to_all.
    xh = col.all_to_all_seq(torch.stack([q, k, v]), axis_name, split_axis=2,
                            concat_axis=1)
    oh = attn_fn(xh[0], xh[1], xh[2], causal)      # [S_global, H / n, D]
    # Head-sharded -> sequence-sharded.
    return col.all_to_all_seq(oh, axis_name, split_axis=0, concat_axis=1)


def ulysses_attention_sharded(q, k, v, mesh, axis_name: str = "x",
                              causal: bool = True):
    """The JAX wrapper's per-rank meaning: q, k, v are this rank's blocks
    of arrays sharded on the sequence (leading) axis over ``axis_name``;
    returns this rank's block of the output."""
    return col._on(mesh, ulysses_attention, q, k, v, axis_name,
                   causal=causal)
