"""Int8 KV-cache quantization (the JAX package's ``ops/kvquant.py``).

Symmetric per-vector scales: each cached K/V vector [head_dim] gets one f32
scale ``max|x| * (1/127)`` (floored at ``1e-12 / 127``), stored in a parallel
``[..., 1]`` buffer, and codes ``round(x / scale)`` (half to even) clipped to
±127. Quantization happens when a row is written (the fresh K/V of a decode
step, the prompt at prefill). Reads never dequantize the cache to memory:
the plain decode attention applies K's scales to the logits and V's to the
probabilities, and the decode kernels (``csrc/flash_decode.cu``) load the
int8 codes and their scales and dequantize each row in registers. Writing
the dequantized cache to memory first was the JAX package's first design,
and it ran at 0.73x the bf16 cache there (int8 read + bf16 write + bf16
read).

These are no kernels: plain tensor functions, equal bit for bit on f32 and
bf16 inputs to the JAX ones as XLA compiles them (``jax.jit``, as every
JAX decode and serving path runs them). XLA turns the scale's division by
the constant 127 into a product with its f32 reciprocal, which can differ
from the division in the last bit; so does this port, so that its int8
caches are the JAX package's bit for bit.
"""

from __future__ import annotations

import torch


def kv_quant(x: torch.Tensor):
    """[..., D] -> (int8 codes [..., D], f32 scales [..., 1])."""
    x32 = x.float()
    s = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.round(x32 / s).clamp(-127, 127)
    return q.to(torch.int8), s


def kv_dequant(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Codes and scales back to [..., D] in ``dtype`` (for tests and
    offline use; never on the decode path, see the module docstring)."""
    return (q.float() * s).to(dtype)
