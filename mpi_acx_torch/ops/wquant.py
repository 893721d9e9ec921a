"""Int8 weight-only quantization for serving (the JAX package's
``ops/wquant.py``).

:func:`quantize_weights_int8` keeps the parameter tree's shape: each named
per-layer matmul weight ``w`` [L, in, out] becomes its int8 codes and a
``w + "_scale"`` companion [L, 1, out] in f32 is added beside it (one
scale per output channel, symmetric, ``max|w|`` over the contracted axis
over 127). Every model block reads its matmul weights through
:func:`wread`, so a quantized and a plain checkpoint run the same code.
Embeddings, unembeddings, norms and biases stay as they are. The MoE
expert products have no ``wread`` path and refuse quantized experts
(``moe_transformer._reject_quantized_experts``).

``wread`` dequantizes eagerly: the f32 product of codes and scales is
written to memory before the cast and the matmul read it (XLA fuses the
same expression into the product's operand read). A fused int8-weight
product is Hopper work of its own, not the port of a TPU kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable

import torch

# Per-family matmul weights streamed as int8 (contracted axis second to
# last at every call site: y = x @ w).
GPT2_WEIGHTS = ("wqkv", "wo", "w1", "w2")
LLAMA_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def wread(lp: Dict[str, Any], name: str, dtype) -> torch.Tensor:
    """Weight ``name`` of layer params ``lp`` in compute ``dtype``,
    dequantized when a ``name + "_scale"`` companion is present. The
    product is taken in f32 before the cast: a bf16 scale would add about
    0.4% error on top of the int8 rounding."""
    w = lp[name]
    s = lp.get(name + "_scale")
    if s is None:
        return w.to(dtype)
    return (w.float() * s).to(dtype)


def _quant_leaf(w: torch.Tensor):
    """Symmetric per-output-channel int8 of ``w`` [..., in, out]: scales
    ``max(amax over in, 1e-12) / 127`` in f32 [..., 1, out] and codes
    ``round(w / scale)`` (half to even) clipped to +-127. Both divisions
    are true divisions, as the JAX package computes them (eagerly: this
    runs once per checkpoint, outside any jit)."""
    w32 = w.float()
    s = w32.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 127.0
    q = torch.round(w32 / s).clamp(-127, 127)
    return q.to(torch.int8), s


def quantize_weights_int8(params: Dict[str, Any],
                          names: Iterable[str]) -> Dict[str, Any]:
    """Quantize the named ``params["layers"]`` weights to int8 with their
    ``<name>_scale`` companions (the leading layer axis kept, so
    ``_layer(params, i)`` carries both). Returns a new tree sharing every
    other tensor with ``params``, which is left as it was. Each leaf is
    quantized one layer slice at a time into preallocated codes and scales
    on its own device, so the f32 transient is one layer's size (equal
    bit for bit to :func:`_quant_leaf` of the whole leaf: every channel's
    amax lies within one layer). Use :data:`GPT2_WEIGHTS` or
    :data:`LLAMA_WEIGHTS` for ``names``, or any subset."""
    lay = dict(params["layers"])
    for name in names:
        w = lay[name]
        q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
        s = torch.empty(w.shape[:-2] + (1, w.shape[-1]), dtype=torch.float32,
                        device=w.device)
        for i in range(w.shape[0]):
            q[i], s[i] = _quant_leaf(w[i])
        lay[name] = q
        lay[name + "_scale"] = s
    return dict(params, layers=lay)


def weight_bytes(params: Dict[str, Any]) -> int:
    """Total parameter bytes as stored: the numerator of a decode step's
    weight-streaming bound."""
    if isinstance(params, dict):
        return sum(weight_bytes(v) for v in params.values())
    return params.numel() * params.element_size()
