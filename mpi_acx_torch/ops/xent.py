"""Memory-bounded cross-entropy: online logsumexp over vocab chunks (the
JAX package's ``ops/xent.py`` in PyTorch; no kernel).

:func:`chunked_xent_ll` computes the per-token target log-likelihood
``logit[target] - logsumexp(logits)`` without the [tokens, vocab] logits
tensor: the forward walks the vocabulary ``chunk`` rows at a time carrying
the running (max, sumexp, target logit); the backward
(``torch.autograd.Function``) keeps only (h, head, targets, lse) and
recomputes each chunk's logits. The last chunk is cut short where the JAX
package pads it with masked rows: the same values, since a masked row's
exponential is exactly 0.
"""

from __future__ import annotations

import torch

_NEG = float(torch.finfo(torch.float32).min)


class _ChunkedXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, head, targets, chunk):
        T, V = h.shape[0], head.shape[0]
        h32 = h.float()
        m = torch.full((T,), _NEG, dtype=torch.float32, device=h.device)
        s = torch.zeros_like(m)
        tl = torch.zeros_like(m)
        for c0 in range(0, V, chunk):
            lg = h32 @ head[c0:c0 + chunk].float().T           # [T, chunk]
            nm = torch.maximum(m, lg.amax(-1))
            s = s * torch.exp(m - nm) + torch.exp(lg - nm[:, None]).sum(-1)
            m = nm
            idx = targets - c0
            inb = (idx >= 0) & (idx < lg.shape[1])
            got = lg.gather(1, idx.clamp(0, lg.shape[1] - 1)[:, None])[:, 0]
            tl = tl + torch.where(inb, got, 0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(h, head, targets, lse)
        ctx.chunk = chunk
        return tl - lse

    @staticmethod
    def backward(ctx, g):
        h, head, targets, lse = ctx.saved_tensors
        chunk, V = ctx.chunk, head.shape[0]
        h32, g = h.float(), g.float()
        dh = torch.zeros_like(h32)
        dhead = torch.empty(head.shape, dtype=torch.float32, device=h.device)
        for c0 in range(0, V, chunk):
            head_c = head[c0:c0 + chunk].float()
            lg = h32 @ head_c.T                                # recompute
            p = torch.exp(lg - lse[:, None])
            lanes = torch.arange(c0, c0 + head_c.shape[0], device=h.device)
            onehot = (targets[:, None] == lanes[None, :]).float()
            coef = (onehot - p) * g[:, None]                   # [T, chunk]
            dh += coef @ head_c
            dhead[c0:c0 + chunk] = coef.T @ h32
        return dh.to(h.dtype), dhead.to(head.dtype), None, None


def chunked_xent_ll(h, head, targets, chunk: int = 8192):
    """Per-token target log-likelihood, vocab processed ``chunk`` rows at a
    time. ``h`` [T, d] (any float dtype; compute in f32), ``head`` [V, d],
    ``targets`` [T] int. Returns [T] f32 equal to
    ``log_softmax(h @ head.T)[t, targets[t]]``; differentiable in ``h``
    and ``head``."""
    return _ChunkedXent.apply(h, head, targets.long(), int(chunk))
