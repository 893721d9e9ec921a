"""Quantized all-reduce over a mesh axis (the JAX package's
``parallel/quantized.py``, after EQuARX): the data-parallel gradient sync
with about 4x fewer bytes on the wire.

The all-reduce is the ring reduce-scatter plus all-gather, each hop a
``ppermute`` of int8 codes and one f32 scale per 128-lane block (symmetric
max-abs quantization). Each reduce-scatter hop re-quantizes a partial sum
at about 1/254 of its block's max, so the worst elementwise error grows
with the ring's length while the mean error stays an order of magnitude
smaller. The all-gather encodes each reduced chunk once, and its owner
keeps the decoded value too, so every rank holds bit-identical results.

The block scale is ``amax * f32(1/127)``, as XLA compiles the JAX
package's ``amax / 127`` under ``jit`` (a multiply by the rounded
reciprocal), so the codes equal the JAX step's bit for bit.
"""

from __future__ import annotations

import torch

from mpi_acx_torch.parallel.collective import (_ring_perm, axis_index,
                                               axis_size, ppermute, psum)

_BLOCK = 128   # lanes per quantization block (one f32 scale per block)
_QMAX = 127.0


def _quant(x):
    """f32 [C] (C a multiple of _BLOCK) -> (int8 [C // B, B], f32 scales
    [C // B, 1])."""
    xb = x.reshape(-1, _BLOCK)
    s = xb.abs().amax(dim=1, keepdim=True) * torch.tensor(
        1.0 / _QMAX, dtype=torch.float32, device=x.device)
    s = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(xb / s), -_QMAX, _QMAX).to(torch.int8)
    return q, s


def ring_psum(x, axis_name: str, quantize: bool = True):
    """Ring reduce-scatter + all-gather all-reduce of ``x`` over
    ``axis_name`` (f32 result of ``x``'s shape). ``quantize=True`` sends
    every hop as int8 codes plus per-block f32 scales; ``quantize=False``
    sends raw f32 on the same hop schedule (the exact all-reduce)."""
    n = axis_size(axis_name)
    r = axis_index(axis_name)
    ring = _ring_perm(n)
    shape, size = x.shape, x.numel()
    c = -(-size // n)                                  # ceil chunk size
    c = -(-c // _BLOCK) * _BLOCK                       # round to blocks
    flat = torch.zeros(n * c, dtype=torch.float32, device=x.device)
    flat[:size] = x.detach().float().reshape(-1)
    acc = flat.reshape(n, c)

    def hop(chunk):
        """Encode, move one step along the ring, decode -> [c] f32."""
        if not quantize:
            return ppermute(chunk, axis_name, ring)
        q, s = _quant(chunk)
        q = ppermute(q, axis_name, ring)
        s = ppermute(s, axis_name, ring)
        return (q * s).reshape(-1)

    # Reduce-scatter: after n - 1 hops rank r owns the fully reduced
    # chunk (r + 1) mod n.
    for t in range(n - 1):
        got = hop(acc[(r - t) % n])
        ri = (r - t - 1) % n
        acc[ri] = acc[ri] + got
    owned = (r + 1) % n
    reduced = acc[owned]

    # All-gather: each reduced chunk is encoded once and travels the ring.
    if quantize:
        q, s = _quant(reduced)
        cur = (q * s).reshape(-1)
    else:
        cur = reduced
    out = torch.zeros((n, c), dtype=torch.float32, device=x.device)
    out[owned] = cur
    for t in range(1, n):
        if quantize:
            q = ppermute(q, axis_name, ring)
            s = ppermute(s, axis_name, ring)
            cur = (q * s).reshape(-1)
        else:
            cur = ppermute(cur, axis_name, ring)
        out[(r - t + 1) % n] = cur
    return out.reshape(-1)[:size].reshape(shape)


def quantized_psum(x, axis_name: str, bits: int = 8):
    """All-reduce-sum of ``x`` over ``axis_name`` with int8-quantized ring
    hops: f32 of ``x``'s shape, identical on every rank. Leaves under
    n * 128 elements take the exact psum (block padding and 2(n - 1) hops
    would cost more there). Not differentiable: it syncs gradients."""
    if bits != 8:
        raise ValueError(f"bits={bits}: int8 is the implemented wire format")
    n = axis_size(axis_name)
    if n == 1:
        return x.float()
    with torch.no_grad():
        if x.numel() < n * _BLOCK:
            return psum(x.detach().float(), axis_name)
        return ring_psum(x, axis_name, quantize=True)


def quantized_pmean(x, axis_name: str, bits: int = 8):
    """The mean-reducing sibling of :func:`quantized_psum` (the drop-in
    for ``pmean`` on gradient leaves)."""
    return quantized_psum(x, axis_name, bits) / axis_size(axis_name)
