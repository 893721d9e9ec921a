"""What the references share: the product in the reference's precision
(float32 with TF32 off, or the control's float8), causal attention in
blocks of query rows, and the switch that keeps TF32 off."""

from __future__ import annotations

import contextlib
import math

import torch

FP8 = torch.float8_e4m3fn
FP8_GRAD = torch.float8_e5m2


@contextlib.contextmanager
def exact_f32():
    """TF32 off for every float32 product inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x, dtype=FP8):
    """``x`` rounded to float8 (e4m3 unless told) with one scale for the
    tensor (its largest magnitude maps to the format's largest), back in
    float32."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = torch.finfo(dtype).max / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    """x @ w in float8: both operands rounded to e4m3, the output's
    cotangent to ``grad_dtype`` (e5m2 in float8 training's hybrid recipe);
    products accumulate in float32."""

    @staticmethod
    def forward(ctx, x, w, grad_dtype):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        ctx.grad_dtype = grad_dtype
        return xq @ wq

    @staticmethod
    def backward(ctx, go):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(go, ctx.grad_dtype)
        gx = gq @ wq.T
        gw = (xq.reshape(-1, xq.shape[-1]).T
              @ gq.reshape(-1, gq.shape[-1]))
        return gx, gw, None


def matmul(precision: str):
    """The reference's product: ``"f32"`` (float32, TF32 off: run inside
    :func:`exact_f32`), ``"fp8"`` (the control's precision: the hybrid
    recipe) or ``"fp8_e4m3"`` (e4m3 for the cotangents too)."""
    if precision == "f32":
        return lambda x, w: x.float() @ w.float()
    if precision in ("fp8", "fp8_e4m3"):
        grad_dtype = FP8_GRAD if precision == "fp8" else FP8
        return lambda x, w: _Fp8Matmul.apply(x, w, grad_dtype)
    raise ValueError(f"precision {precision!r}: f32, fp8 or fp8_e4m3")


def causal_attention(q, k, v, block: int = 512):
    """softmax(q k^T / sqrt(D) + causal mask) v in float32, q [B, S, H,
    D], k/v [B, S, H, D] (KV groups already broadcast), computed a block
    of query rows at a time. Differentiable."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    qh, kh, vh = (t.float().transpose(1, 2) for t in (q, k, v))  # [B,H,S,D]
    outs = []
    for s0 in range(0, S, block):
        s1 = min(S, s0 + block)
        logits = (qh[:, :, s0:s1] @ kh[:, :, :s1].transpose(-1, -2)) * scale
        rows = torch.arange(s0, s1, device=q.device)[:, None]
        cols = torch.arange(s1, device=q.device)[None, :]
        logits = logits.masked_fill(cols > rows, float("-inf"))
        outs.append(torch.softmax(logits, dim=-1) @ vh[:, :, :s1])
    return torch.cat(outs, dim=2).transpose(1, 2)              # [B,S,H,D]
